"""Spans: the named stages of the port's entry points, on the profiler's
clock and on the device's.

A span marks one stage of a request: ``runner.forward``,
``backbone.layer3``, ``train.backward`` and so on, at the layer boundaries
the call sites name. Tracing is off by default, and then :func:`span`
returns one shared null context: a flag check, no allocation, no
``record_function`` and no CUDA call. :func:`enable` turns it on for the
process. Each span then

  * enters ``torch.profiler.record_function(name)``, so that it sits in
    any active ``torch.profiler`` trace on the same clock as the device's
    kernels (a Chrome trace shows the stage names beside the kernels);
  * where its device is a CUDA device, records a ``torch.cuda.Event`` on
    the current stream at entry and at exit;
  * appends a :class:`Record` to a list in memory: the name, the index of
    the enclosing span in that list (spans nest per thread) and a request
    id that every span under one top-level span shares.

:func:`collect` synchronises once, resolves each record's ``device_ms``,
returns the records and clears the list. Nothing is written to disk, and
records pile up until collected; collect when no span is open.

A span's ``device_ms`` is the time the stream takes from finishing the
work queued before the span to finishing the span's own work: the stage's
kernels plus any wait, inside the stage, for the host's launches. When the
host runs ahead of the device it is pure device time. On the CPU it is
None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import List, Optional

import torch

_NULL = contextlib.nullcontext()
_enabled = False
_lock = threading.Lock()
_records: List["Record"] = []
_requests = itertools.count()
_local = threading.local()          # .stack: (index, request) of open spans


@dataclasses.dataclass
class Record:
    """One span. ``parent``: the index of the enclosing span in the list
    :func:`collect` returns (None at the top); ``request``: shared by every
    span under one top-level span; ``start`` / ``end``: its CUDA events on
    ``device`` (None on the CPU); ``device_ms``: set by :func:`collect`."""

    name: str
    parent: Optional[int]
    request: int
    device: Optional[torch.device] = None
    start: Optional[torch.cuda.Event] = None
    end: Optional[torch.cuda.Event] = None
    device_ms: Optional[float] = None


def enable(on: bool = True) -> None:
    """Turn spans on (or off) for the whole process."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def suspended():
    """Spans off for the whole process while the block runs (set-up work
    that serves no request), then as they were."""
    on = _enabled
    enable(False)
    try:
        yield
    finally:
        enable(on)


def span(name: str, device=None):
    """A context that marks the stage ``name`` of work on ``device``
    (events only where it is a CUDA device); the shared null context when
    tracing is off."""
    if not _enabled:
        return _NULL
    return _Span(name, device)


class _Span:
    __slots__ = ("name", "device", "record", "range")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self) -> None:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        with _lock:
            index = len(_records)
            request = stack[-1][1] if stack else next(_requests)
            rec = Record(self.name, stack[-1][0] if stack else None, request)
            _records.append(rec)
        stack.append((index, request))
        if (self.device is not None
                and torch.device(self.device).type == "cuda"):
            stream = torch.cuda.current_stream(self.device)
            rec.device = stream.device
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.start.record(stream)
        self.record = rec

    def __exit__(self, *exc) -> None:
        rec = self.record
        if rec.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(rec.device))
            rec.end = end
        _local.stack.pop()
        self.range.__exit__(*exc)


def collect() -> List[Record]:
    """The records since the last call, in the order their spans opened,
    with ``device_ms`` resolved; the list is cleared."""
    global _records
    with _lock:
        records, _records = _records, []
    for device in {r.device for r in records if r.end is not None}:
        torch.cuda.synchronize(device)
    for r in records:
        if r.end is not None:
            r.device_ms = r.start.elapsed_time(r.end)
    return records
