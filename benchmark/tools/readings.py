"""The readings that a cell's limits are set from, on the card: the
program's numbers over many seeds and the controls' over the same seeds,
in one process (the kernels build once).

    python3 -m benchmark.tools.readings --workload <cell> --seeds 1,2,3 \\
        --seconds 3 --controls fp8

A control is the reference put in the program's place: ``fp8`` or
``tf32`` (the reference in that precision), or, for a training cell, a
planted fault of the ``FAULTS`` of the configuration's reference
(``benchmark/reference``). One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..harness import main, spec


def readings(cell: spec.Cell, seed: int, seconds: float, controls, device,
             config=None, mix=None) -> dict:
    kind = spec.traffic_kind(cell.kind)
    t0 = time.perf_counter()
    result = main.execute(cell, seed, seconds, False, device, t0,
                          config=config, mix=mix, keep=True)
    run, want = result.pop("_run"), result.pop("_expected")
    out = {"seed": seed, "program": {k: c["value"] for k, c in
                                     result["checks"].items()},
           "metrics": {k: m["value"] for k, m in result["metrics"].items()}}
    reference = run.reference
    for name in controls:
        if name in reference.FAULTS:
            got = kind.outputs(run, reference.Reference(
                run.config, run.state, device), fault=name)
        else:
            got = kind.as_observed(kind.outputs(
                run, reference.Reference(run.config, run.state, device,
                                         low=name)))
        out[name] = kind.numbers(got, want)
    return out


def main_(argv) -> int:
    p = argparse.ArgumentParser(prog="benchmark.tools.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", default="", help="comma-separated")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    controls = [c for c in args.controls.split(",") if c]
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds, controls,
                                  "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_(sys.argv[1:]))
