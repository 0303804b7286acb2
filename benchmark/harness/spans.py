"""What the per-layer metrics that read the program's spans share
(``mimamo_tpu_torch.tracing``): spans on in the traced run's window only,
their records collected once, and the device's idle time inside a span.

A reader's ``install(run)`` turns the spans on after set-up, so the timed
run (``--trace 0``) keeps them off and the warm-up leaves no records. The
first read collects the window's records into ``run.scratch["spans"]`` and
turns the spans off again. A program without the tracing module (a
checkout older than the spans) has no records and no span in the trace:
every reader then returns None, never 0.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Tuple

Interval = Tuple[float, float]


def _tracing():
    try:
        from mimamo_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def install(run) -> None:
    tracing = _tracing()
    if tracing is not None:
        tracing.enable()


def records(run) -> list:
    """The span records of the window, collected on the first call."""
    if "spans" not in run.scratch:
        tracing = _tracing()
        if tracing is None:
            run.scratch["spans"] = []
        else:
            tracing.enable(False)
            run.scratch["spans"] = tracing.collect()
    return run.scratch["spans"]


def median_ms(run, name: str) -> Optional[float]:
    """The median ``device_ms`` of the window's spans ``name``."""
    ms = [r.device_ms for r in records(run)
          if r.name == name and r.device_ms is not None]
    return statistics.median(ms) if ms else None


def _merged(intervals: List[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap_s(xs: List[Interval], ys: List[Interval]) -> float:
    """Seconds that two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(run, name: str) -> Optional[float]:
    """Seconds of the traced window in which the host was inside a span
    ``name`` (its host events, merged) and no kernel ran on the device:
    ``idle_pct``'s idle, so a copy or a fill alone counts as idle. None
    when the trace holds no such span or no kernel."""
    records(run)                    # the first read ends the spans
    trace = run.trace
    if trace is None:
        return None
    lo, hi = trace.window
    inside = _merged([(max(a, lo), min(b, hi)) for n, a, b in trace.host
                      if n == name and min(b, hi) > max(a, lo)])
    busy = trace._busy(kernels_only=True)
    if not inside or not busy:
        return None
    return sum(b - a for a, b in inside) - _overlap_s(inside, busy)
