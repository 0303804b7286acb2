"""The highest rate a streams cell's session sustains, by a sweep on the
card: the cell's traffic at each of several frame rates a stream, one
window each, in one process. A rate is sustained while the chunks served
late in the window wait no longer than those served early (no backlog
grows).

    python3 -m benchmark.tools.knee --workload bf16-streams \\
        --fps 30,120,200,240,280,320 --seconds 8
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..harness import main, spec


def point(cell, fps: float, seed: int, seconds: float, device) -> dict:
    result = main.execute(cell, seed, seconds, False, device,
                          time.perf_counter(), mix=dict(cell.mix, fps=fps),
                          keep=True)
    counts = result["_run"].counts
    lat = np.asarray(counts["latency_s"]) * 1e3
    third = max(1, len(lat) // 3)
    return {"fps": fps, "chunks": len(lat), "feeds": counts["feeds"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "max_ms": float(lat.max()),
            "first_third_p95_ms": float(np.percentile(lat[:third], 95)),
            "last_third_p95_ms": float(np.percentile(lat[-third:], 95)),
            "lane_use_pct": 100.0 * counts["lanes_fed"] / counts["lanes_run"],
            "feed_ms_median": float(np.median(counts["feed_s"]) * 1e3),
            "out_err": result["checks"]["out_err"]["value"]}


def main_(argv) -> int:
    p = argparse.ArgumentParser(prog="benchmark.tools.knee")
    p.add_argument("--workload", required=True)
    p.add_argument("--fps", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("knee: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for fps in (float(f) for f in args.fps.split(",")):
        print(json.dumps(point(cell, fps, args.seed, args.seconds, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_(sys.argv[1:]))
