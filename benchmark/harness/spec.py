"""Finding a cell's pieces by name.

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout. It names a configuration (``configs/<config>.json``) and a
traffic mix (``traffic/<traffic>.json``, whose ``kind`` names the code
``traffic/<kind>.py``); ``workloads/<cell>.json`` holds the limits of the
cell's correctness numbers. The metrics a cell reports are the entries of
``end_to_end`` and ``per_layer`` that apply to it; a per-layer metric is
read by ``metrics/<name>.py``. So a new cell, mix, configuration or
metric is a new file, and no file here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent.parent          # benchmark/
ROOT = HERE.parent                                    # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the cell's entry in BENCHMARK.json
    config: dict           # configs/<config>.json
    mix: dict              # traffic/<traffic>.json
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_file() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def applies(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Does ``metric`` belong to ``cell``? One with ``workloads`` lists its
    cells; an end-to-end one without it (``setup_s``) belongs to every
    cell, and a per-layer one without it to every cell that reports the
    end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load_cell(name: str) -> Cell:
    bench = benchmark_file()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(entries)}")
    entry = entries[name]
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]),
                None)
    if conf is None:
        raise KeyError(f"cell {name!r}: no configuration {entry['config']!r}")
    base = ROOT / "benchmark"
    e2e = [m for m in bench["end_to_end"] if applies(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if applies(m, name, e2e_names)]
    return Cell(name=name, entry=entry, config=_json(ROOT / conf["file"]),
                mix=_json(base / "traffic" / f"{entry['traffic']}.json"),
                limits=_json(base / "workloads" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=per_layer)


def traffic_kind(kind: str) -> ModuleType:
    """The code of a traffic kind, ``traffic/<kind>.py``."""
    return importlib.import_module(f"benchmark.traffic.{kind}")


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``, loaded by its path (a metric's name may hold
    dots). It defines ``read(run)`` and may define ``install(run)``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + "".join(c if c.isalnum() else "_"
                                       for c in name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
