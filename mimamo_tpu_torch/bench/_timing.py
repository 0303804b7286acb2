"""Timing on the card for the probes and ``chip_smoke.py``, the label
every measurement carries, the card's published peaks and the error
measure their checks share.

A time is the median over ``iters`` batches of ``batch`` back-to-back
calls between two CUDA events, after ``warmup`` calls. Back to back, so
that the card does not wait while the host prepares the next launch and a
short kernel's time is the card's, not the host's.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

# Published H100 SXM peaks (NVIDIA data sheet), at a 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12     # tensor cores, dense
PEAK_FP32_FLOP_PER_S = 67e12      # outside the tensor cores
PEAK_TF32_FLOP_PER_S = 495e12     # tensor cores, dense


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device(cpu: bool) -> torch.device:
    """The card, or the CPU when ``cpu`` is asked for; raises when there is
    no card and the CPU was not asked for."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes time the card; pass "
                           "--cpu for a smoke run of the plain versions")
    return torch.device("cuda")


def time_ms(fn, warmup: int = 2, iters: int = 5, batch: int = 10) -> float:
    """Time (ms) of one call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def max_rel(got, want) -> float:
    """max |got - want| / max |want| of two tensors or arrays, on the
    device of the first tensor among them."""
    dev = next((x.device for x in (got, want)
                if isinstance(x, torch.Tensor)), None)
    got = torch.as_tensor(got, device=dev).float()
    want = torch.as_tensor(want, device=dev).float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-12)
            ).item()
