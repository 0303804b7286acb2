"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference that decides ``correct``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, then ``card`` and, last, ``checks``: each number compared
beside its limit. The same numbers and limits are the last lines of
standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from types import ModuleType
from typing import Any, Dict, List, Optional

import torch

from . import data, judge, spec, trace
from .. import reference


@dataclasses.dataclass
class Run:
    """What a traffic kind and the metric readers share in one run."""

    cell: spec.Cell
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    mix: dict                        # the traffic mix's parameters
    config: dict                     # the configuration as it is run
    reference: ModuleType = None     # the configuration's plain reference
    state: Dict[str, torch.Tensor] = None   # the weights both sides get
    model: Any = None                # the port's Mimamo
    program: Any = None              # what the kind drives (session, step)
    inputs: Any = None
    values: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, Any] = dataclasses.field(default_factory=dict)
    scratch: Dict[str, Any] = dataclasses.field(default_factory=dict)
    observed: Any = None             # the program's outputs to judge
    trace: Optional[trace.Trace] = None


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool,
            device, t0: float, config: Optional[dict] = None,
            mix: Optional[dict] = None, keep: bool = False) -> dict:
    """Run ``cell`` once on ``device``; returns the result (without
    printing). ``config`` and ``mix`` replace the cell's files (the tests
    run at small sizes on the CPU); ``keep`` adds the run and the
    reference's outputs under ``_run`` and ``_expected`` (for the
    readings that set the limits, ``tools/readings.py``)."""
    device = torch.device(device)
    run = Run(cell=cell, seed=seed, seconds=seconds, traced=traced,
              device=device, mix=mix or cell.mix,
              config=config or cell.config)
    kind = spec.traffic_kind(cell.kind)
    run.reference = reference.for_config(run.config)
    run.reference.check_supported(run.config)
    run.state = data.make_weights(run.config, seed, device)
    kind.setup(run)
    readers = {m["name"]: spec.metric_reader(m["name"])
               for m in cell.per_layer} if traced else {}
    for reader in readers.values():
        if hasattr(reader, "install"):
            reader.install(run)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    # what set-up made stays out of the collector's scans in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    traces: List[trace.Trace] = []
    with trace.profiled(traces) if traced else contextlib.nullcontext():
        kind.window(run)
        if cuda:
            torch.cuda.synchronize(device)
    gc.unfreeze()
    loaded = judge.forbidden_modules()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.trace = traces[0] if traces else None
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.values, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    # the program's state goes before the reference runs, so that the
    # reference neither sets the peak nor runs short of memory
    observed = run.observed
    run.model = run.program = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = run.reference.Reference(run.config, run.state, device)
    want = kind.expected(run, ref)
    numbers = kind.numbers(observed, want)
    checks = judge.judge(numbers, cell.limits)
    loaded = sorted(set(loaded) | set(judge.forbidden_modules()))
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": int(run.counts["attempted"]),
              "failed": int(run.counts.get("failed", 0)),
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if cuda else "cpu"),
                         "count": int(cell.entry["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["traffic"] = run.counts.get("report", {})
    result["card"] = card_label() if cuda else "cpu"
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    result["_forbidden"] = loaded
    if keep:
        result["_run"], result["_expected"] = run, want
    return result


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="benchmark/run.py",
        description="Run one cell of BENCHMARK.json once on the card.")
    p.add_argument("--workload", required=True, help="the cell's name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: per-layer metrics from a profiled window")
    return p.parse_args(argv)


def main(argv: List[str], t0: float) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell {cell.name!r} needs {chips} CUDA "
              f"device(s); {torch.cuda.device_count()} available. No CPU "
              f"fallback.", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", t0)
    loaded = result.pop("_forbidden")
    if loaded:
        print(f"benchmark: the run loaded forbidden modules: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
