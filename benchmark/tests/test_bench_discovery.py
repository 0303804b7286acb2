"""A new cell, traffic mix, per-layer metric, or configuration with a
reference of its own is added with new files and entries in
BENCHMARK.json; no file of the harness changes."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark.harness import spec

REPO = Path(__file__).resolve().parents[2]

PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark.harness import spec
cell = spec.load_cell("bf16-clips-2x96")
reader = spec.metric_reader("calls_per_s.clips2")
class Run: counts = {"calls": 30, "window_s": 3.0}
print(json.dumps({"mix": cell.mix, "per_layer": [m["name"] for m in cell.per_layer],
                  "e2e": [m["name"] for m in cell.end_to_end],
                  "limits": cell.limits, "value": reader.read(Run()),
                  "file": spec.__file__}))
"""


def _tree(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _copy(root: Path) -> None:
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")


def test_new_cell_and_metric_are_files_only(tmp_path):
    _copy(tmp_path)
    before = _tree(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "bf16-clips-2x96",
                               "config": "mimamo-bf16",
                               "traffic": "clips-2x96", "chips": 1,
                               "why": "longer clips"})
    frames = next(m for m in bench["end_to_end"]
                  if m["name"] == "frames_per_s")
    frames["workloads"].append("bf16-clips-2x96")
    bench["per_layer"].append({"name": "calls_per_s.clips2", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "runner", "moves": "frames_per_s",
                               "workloads": ["bf16-clips-2x96"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark/traffic/clips-2x96.json").write_text(json.dumps(
        {"kind": "clips", "clips": 2, "frames": 96, "pool": 4,
         "warmup_calls": 2}))
    (tmp_path / "benchmark/workloads/bf16-clips-2x96.json").write_text(
        json.dumps({"limits": {"out_err": 2.5}}))
    (tmp_path / "benchmark/metrics/calls_per_s.clips2.py").write_text(
        "def read(run):\n"
        "    return run.counts['calls'] / run.counts['window_s']\n")
    after = _tree(tmp_path)
    assert all(after[k] == v for k, v in before.items())   # nothing edited
    out = subprocess.run([sys.executable, "-c", PROBE, str(tmp_path)],
                         capture_output=True, text=True, cwd=tmp_path,
                         check=True)
    got = json.loads(out.stdout)
    assert got["file"].startswith(str(tmp_path))
    assert got["mix"]["frames"] == 96 and got["limits"] == {"out_err": 2.5}
    assert got["per_layer"] == ["calls_per_s.clips2"]
    assert got["e2e"] == ["frames_per_s", "setup_s"]
    assert got["value"] == 10.0


def test_every_cell_finds_its_pieces():
    bench = spec.benchmark_file()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        spec.traffic_kind(cell.kind)
        assert cell.per_layer, w["name"]
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        assert len(cell.end_to_end) >= 2
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)


PROBE_REFERENCE = '''"""MIMAMO-Net\'s reference, counting its calls."""
from . import mimamo
from .mimamo import FAULTS, check_supported  # noqa: F401

CALLS = {"schema": 0, "Reference": 0, "clips": 0, "train_steps": 0}


def schema(cfg):
    CALLS["schema"] += 1
    return mimamo.schema(cfg)


def train_steps(*args, **kwargs):
    CALLS["train_steps"] += 1
    return mimamo.train_steps(*args, **kwargs)


class Reference(mimamo.Reference):
    def __init__(self, *args, **kwargs):
        CALLS["Reference"] += 1
        super().__init__(*args, **kwargs)

    def clips(self, crops):
        CALLS["clips"] += 1
        return super().clips(crops)
'''

JUDGE = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from benchmark.harness import data, main, spec
from benchmark.reference import probe
from benchmark.tests.conftest import tiny
out = {}
for name in ("probe-clips", "probe-train"):
    cell = spec.load_cell(name)
    config, mix = tiny(cell)
    weights = data.make_weights(config, 5, "cpu")
    plain = data.make_weights({k: v for k, v in config.items()
                               if k != "reference"}, 5, "cpu")
    drawn = dict(probe.CALLS)
    result = main.execute(cell, 5, 0.2, False, "cpu", time.perf_counter(),
                          config=config, mix=mix, keep=True)
    out[name] = {"drawn": drawn, "calls": dict(probe.CALLS),
                 "same_weights": all(torch.equal(weights[k], plain[k])
                                     for k in plain) and set(weights) == set(plain),
                 "run_reference": result["_run"].reference is probe,
                 "correct": result["correct"], "checks": result["checks"]}
    for k in probe.CALLS:
        probe.CALLS[k] = 0
out["file"] = probe.__file__
out["program"] = sys.modules["mimamo_tpu_torch"].__file__
print(json.dumps(out))
"""


def test_new_reference_is_files_only(tmp_path):
    """A configuration that names a reference of its own
    (``"reference": "probe"``) is found, its weights drawn from the
    module's ``schema`` and its runs judged by the module's ``Reference``
    and ``train_steps``; no file that was there changes."""
    _copy(tmp_path)
    shutil.copytree(REPO / "mimamo_tpu_torch", tmp_path / "mimamo_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    before = _tree(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in bench["configs"]}
    for name, base, traffic, source in (
            ("probe-clips", "mimamo-bf16", "clips-8x48", "bf16-clips"),
            ("probe-train", "mimamo-fp32", "train-4x48", "fp32-train")):
        config = json.loads((REPO / configs[base]["file"]).read_text())
        config["reference"] = "probe"
        path = f"benchmark/configs/{name}.json"
        (tmp_path / path).write_text(json.dumps(config))
        bench["configs"].append(dict(configs[base], name=name, file=path))
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a reference of its own"})
        shutil.copy(REPO / f"benchmark/workloads/{source}.json",
                    tmp_path / f"benchmark/workloads/{name}.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark/reference/probe.py").write_text(PROBE_REFERENCE)
    after = _tree(tmp_path)
    assert all(after[k] == v for k, v in before.items())   # nothing edited
    out = subprocess.run([sys.executable, "-c", JUDGE, str(tmp_path)],
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(tmp_path))
    assert got["program"].startswith(str(tmp_path))
    clips, train = got["probe-clips"], got["probe-train"]
    for cell in (clips, train):
        assert cell["drawn"]["schema"] == 1 and cell["calls"]["schema"] == 2
        assert cell["same_weights"] and cell["run_reference"]
        assert cell["correct"] is True, cell["checks"]
    # the fp32 reference, and the bf16 yardstick that ``stated`` builds
    assert clips["calls"]["Reference"] == 2 and clips["calls"]["clips"] >= 2
    assert train["calls"]["Reference"] == 1
    assert train["calls"]["train_steps"] == 2
