"""The device trace of a traced run (``--trace 1``), from ``torch.profiler``.

The window runs under the profiler with CPU and CUDA activities; nothing
is written to disk. :class:`Trace` keeps the device activities (kernels,
copies, fills) and the host's events as (name, start, end) in seconds,
and answers what the readers ask: the device time and count of the
kernels whose names match a pattern, the time of host-to-device copies,
the seconds in which anything ran on the device (or, leaving out copies
and fills, a kernel), the longest idle gaps labelled by what the host was
doing, and the top device operations.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

Span = Tuple[str, float, float]

# Device activities that are copies or fills, not kernels.
TRANSFER = re.compile(r"^(Memcpy|Memset)")


class Trace:
    def __init__(self, device_spans: List[Span], host_spans: List[Span],
                 window: Tuple[float, float]):
        self.device = sorted(device_spans, key=lambda s: s[1])
        self.host = sorted(host_spans, key=lambda s: s[1])
        self._host_starts = [s[1] for s in self.host]
        self.window = window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, count) of the activities whose names match
        ``pattern`` (``re.search``)."""
        rx = re.compile(pattern)
        total, count = 0.0, 0
        for name, start, end in self.device:
            if rx.search(name):
                total += end - start
                count += 1
        return total, count

    def _busy(self, kernels_only: bool = False
              ) -> List[Tuple[float, float]]:
        """The union of the device's activity intervals (with
        ``kernels_only``, of its kernels' alone), clipped to the window."""
        lo, hi = self.window
        merged: List[List[float]] = []
        for name, start, end in self.device:
            if kernels_only and TRANSFER.match(name):
                continue
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    def busy_s(self, kernels_only: bool = False) -> float:
        return sum(b - a for a, b in self._busy(kernels_only))

    def gaps(self) -> List[Tuple[float, float]]:
        """The device's idle intervals inside the window."""
        lo, hi = self.window
        out, t = [], lo
        for a, b in self._busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host event running at ``t``, or "host idle"."""
        best: Optional[Span] = None
        i = bisect.bisect_right(self._host_starts, t)
        # events that start before t; scan back over a bounded number
        for name, start, end in reversed(self.host[max(0, i - 4096):i]):
            if end >= t and (best is None or end - start < best[2] - best[1]):
                best = (name, start, end)
        return best[0] if best else "host idle"

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The ``top`` longest idle gaps, each [what the host was doing at
        its middle, seconds]."""
        gaps = sorted(self.gaps(), key=lambda g: g[1] - g[0], reverse=True)
        return [[self.host_at((a + b) / 2), b - a] for a, b in gaps[:top]]

    def device_ops(self, top: int = 10) -> List[List]:
        """The ``top`` device operations by total time, [name, seconds]."""
        lo, hi = self.window
        sums: Dict[str, float] = defaultdict(float)
        for name, start, end in self.device:
            if end > lo and start < hi:
                sums[name[:160]] += end - start
        return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])
                [:top]]


@contextlib.contextmanager
def profiled(sink: List[Trace]) -> Iterator[None]:
    """Run the block under the profiler and append its :class:`Trace` to
    ``sink``. The window is the block's host clock span (the caller
    synchronises the device before the block ends)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("benchmark.window"):
            yield
    sink.append(from_profile(prof))


def _annotation(event) -> bool:
    """Is this device-side event the mirror of a host range (a
    ``record_function`` label), not work the device did?"""
    flag = getattr(event, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    kind = getattr(event, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def from_profile(prof) -> Trace:
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    window = None
    for e in events:
        name = e.name()
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not _annotation(e):
                device.append((name, start, end))
        else:
            if name == "benchmark.window":
                window = (start, end)
            host.append((name, start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no window")
    return Trace(device, host, window)
