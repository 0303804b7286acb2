"""What the per-layer metrics share: reading a share of a roofline, of a
peak, and of the window from a traced run. A metric's own file
(``metrics/<name>.py``) names its kernels and its work. A reader that
finds nothing to read returns None, never 0."""

from __future__ import annotations

from typing import Optional

H2D = r"^Memcpy HtoD"


def roofline_pct(run, pattern: str, bound_s: float,
                 launches_per_call: int) -> Optional[float]:
    """The share (%) of its roofline that a kernel reaches: ``bound_s``
    (the least time a call's work could take) times the calls, over the
    device time of the kernels matching ``pattern``; ``launches_per_call``
    launches make one call's work."""
    if run.trace is None:
        return None
    seconds, count = run.trace.kernels(pattern)
    if count == 0 or seconds <= 0:
        return None
    return 100.0 * bound_s * (count / launches_per_call) / seconds


def peak_pct(run, flops: float, peak: float) -> Optional[float]:
    """``flops`` done over the window, as a share (%) of ``peak``."""
    window = run.counts.get("window_s")
    if not window or flops <= 0:
        return None
    return 100.0 * flops / window / peak


def idle_pct(run) -> Optional[float]:
    """The share (%) of the traced window in which no kernel ran on the
    device: a copy or a fill alone leaves the device idle here (the copies'
    own time is ``h2d_ms``)."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    busy = run.trace.busy_s(kernels_only=True)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.trace.window_s)


def h2d_ms_per_call(run) -> Optional[float]:
    """Device time (ms) of the host-to-device copies, per call."""
    if run.trace is None or not run.counts.get("calls"):
        return None
    seconds, count = run.trace.kernels(H2D)
    if count == 0:
        return None
    return 1e3 * seconds / run.counts["calls"]
