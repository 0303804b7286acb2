"""Does a frame's phase stage depend on the batch it arrives in?

    python -m mimamo_tpu_torch.bench.fft_invariance [--gray port|matmul]
        [--groups 0,8,16,32,64] [--out FILE]
    python -m mimamo_tpu_torch.bench.fft_invariance --cpu

On 384 seeded 112^2 uint8 RGB crops, frame f is put at several positions
(first, second, middle, last) of batches of 1, 3, 16, 17, 48, 128, 136,
192, 300 and 384 frames (a window of the 384 around it), and each step of
the phase stage is held against the same frame's in the 384-frame batch,
bit for bit (the count of elements that are not equal):

  * ``gray``: the crops made grey;
  * ``forward``: the fftshifted spectrum (``pyramid.fft2_shifted``) of the
    reference's grey frames, so only the forward transform's batch differs;
  * ``inverse``: each scale's bands made from the reference's spectra, so
    only the inverse transforms' batch differs;
  * ``bands``: each scale's bands from the crops, end to end.

Then the phase stacks (``phase_kernel.micro_motion_features_fused``) of an
8 x 48 clip against those of its chunks of 16 frames with the frame before
each (a streamed feed), every chunk made grey on its own: unequal elements
and values that moved by more than 0.1 (a phase difference across the
+-pi wrap).

A mode is a grey conversion and a way to call the FFTs. ``--gray port``
is ``preprocess.to_grayscale`` (elementwise); ``matmul`` is the earlier
form, a matrix-vector product ``rgb @ w``. ``--groups`` lists the FFT
calls to try: 0 is the port's (each transform of a batch in one call);
G > 0 calls G frames at a time, the last call filled up with zero frames
whose results are dropped (a candidate design, run only here). For each
mode on the card it also times the 8 x 48 clip step's frames and a feed's
8 x 17: ``gray_ms`` and ``back_to_back_ms`` of the bands
(``_timing.time_ms``); ``fft_bands_ms``, the device time from the end of
a pageable host copy of the uint8 clip to its last band, grey conversion
included, as a forward meets it (median of 7); the host's time to issue
the bands; the FFT calls a forward makes; the CUDA kernels of one call of
the bands by ``torch.profiler`` (null where it sees none); and how many
grey values differ between the card and the CPU.

Prints the card's name and power limit, one JSON line per mode and a
summary line; ``--out`` writes every count. ``--cpu`` runs it on the CPU
at 24 frames of 32^2, a smoke test that times nothing. Without it the
script needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

import numpy as np
import torch

from mimamo_tpu_torch import pyramid
from mimamo_tpu_torch.bench._timing import card, device, time_ms
from mimamo_tpu_torch.config import PhaseSpec, PyramidSpec
from mimamo_tpu_torch.kernels import phase_kernel
from mimamo_tpu_torch.preprocess import _LUMA_RGB, to_grayscale

SIZES = (1, 3, 16, 17, 48, 128, 136, 192, 300, 384)
FRAMES = (0, 137, 383)            # the frames followed through the batches
CLIP, CHUNK = (8, 48), 16         # the clip step; a feed's chunk
PHASE_JUMP = 0.1
SEED = 0


def matmul_gray(rgb: torch.Tensor) -> torch.Tensor:
    """The earlier grey conversion: ``rgb @ w``."""
    return rgb @ torch.tensor(_LUMA_RGB, dtype=rgb.dtype, device=rgb.device)


GRAY = {"port": to_grayscale, "matmul": matmul_gray}


def in_groups(fft, x: torch.Tensor, frame_ndim: int, group: int):
    """``fft`` of ``x`` [..., *frame] (a frame: the trailing ``frame_ndim``
    axes) called on ``group`` frames at a time, the last call filled up
    with zero frames whose results are dropped."""
    lead = x.shape[:x.dim() - frame_ndim]
    flat = x.reshape((-1,) + x.shape[len(lead):])
    n = flat.shape[0]
    parts = list(flat.split(group))
    parts[-1] = torch.cat([parts[-1], parts[-1].new_zeros(
        (-n % group,) + flat.shape[1:])])
    out = torch.cat([fft(p) for p in parts])[:n]
    return out.reshape(lead + out.shape[1:])


@contextlib.contextmanager
def fft_calls(group: int):
    """Inside the block the bands' FFTs run in calls of ``group`` frames
    (0: the port's own calls)."""
    if not group:
        yield
        return
    saved = pyramid.fft2_shifted, pyramid.ifft2_shifted
    pyramid.fft2_shifted = lambda x: torch.fft.fftshift(in_groups(
        torch.fft.fft2, x.to(torch.complex64), 2, group), dim=(-2, -1))
    pyramid.ifft2_shifted = lambda y: in_groups(   # only [..., K, h, w]
        torch.fft.ifft2, torch.fft.ifftshift(y, dim=(-2, -1)), 3, group)
    try:
        yield
    finally:
        pyramid.fft2_shifted, pyramid.ifft2_shifted = saved


def crops(n: int, size: int, dev) -> torch.Tensor:
    """``n`` seeded uint8 RGB crops [n, size, size, 3] on ``dev``."""
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, 256, (n, size, size, 3),
                                         dtype=np.uint8)).to(dev)


def unequal(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of ``a`` and ``b`` that are not bitwise equal."""
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def stage(rgb: torch.Tensor, masks: tuple, gray=to_grayscale) -> dict:
    """The phase stage's steps on uint8 crops [n, S, S, 3]."""
    g = gray(rgb.float())
    spectrum = pyramid.fft2_shifted(g)
    return {"gray": g, "spectrum": spectrum,
            "bands": list(pyramid._bands(spectrum, masks))}


def positions(n: int) -> list:
    return sorted({0, 1, n // 2, n - 1} & set(range(n)))


def invariance(rgb: torch.Tensor, spec: PyramidSpec, sizes=SIZES,
               frames=FRAMES, gray=to_grayscale) -> dict:
    """Unequal elements of each step for frame f at position p of a batch
    of n, against f in the batch of all of ``rgb``: ``{n: {"gray": c,
    "forward": c, "inverse": [c per scale], "bands": [c per scale],
    "positions": [...]}}``, summed over ``frames`` and positions."""
    total = rgb.shape[0]
    masks = pyramid.band_masks(spec, rgb.device)[:spec.height]
    ref = stage(rgb, masks, gray)
    counts = {}
    for n in sizes:
        row = {"gray": 0, "forward": 0, "inverse": [0] * spec.height,
               "bands": [0] * spec.height, "positions": positions(n)}
        for f in frames:
            for p in row["positions"]:
                idx = (torch.arange(n, device=rgb.device) + f - p) % total
                got = stage(rgb[idx], masks, gray)
                row["gray"] += unequal(got["gray"][p], ref["gray"][f])
                row["forward"] += unequal(
                    pyramid.fft2_shifted(ref["gray"][idx])[p],
                    ref["spectrum"][f])
                inv = pyramid._bands(ref["spectrum"][idx], masks)
                for s, (a, b, want) in enumerate(zip(
                        inv, got["bands"], ref["bands"])):
                    row["inverse"][s] += unequal(a[p], want[f])
                    row["bands"][s] += unequal(b[p], want[f])
        counts[n] = row
    return counts


def all_equal(counts: dict) -> bool:
    return not any(r["gray"] or r["forward"] or any(r["inverse"])
                   or any(r["bands"]) for r in counts.values())


def stacks_vs_chunks(rgb: torch.Tensor, spec: PyramidSpec,
                     phase_spec: PhaseSpec, clip=CLIP,
                     gray=to_grayscale) -> dict:
    """The phase stacks of a clip [b, t] against those of its chunks of
    CHUNK frames, each with the frame before it (a streamed feed), each
    chunk made grey on its own: unequal elements, jumps and max |d|."""
    b, t = clip
    frames = rgb[:b * t].reshape((b, t) + tuple(rgb.shape[1:]))

    def stacks(x):
        return phase_kernel.micro_motion_features_fused(
            gray(x.float()), spec, phase_spec)

    whole = stacks(frames)
    diff, jumps, max_abs = 0, 0, 0.0
    for start in range(CHUNK, t, CHUNK):
        got = stacks(frames[:, start - 1:start + CHUNK])
        want = whole[:, start - 1:start + CHUNK - 1]
        diff += unequal(got, want)
        jumps += int(((got - want).abs() > PHASE_JUMP).sum())
        max_abs = max(max_abs, float((got - want).abs().max()))
    return {"unequal": diff, "jumps": jumps, "max_abs": max_abs}


def fft_bands_ms(rgb: torch.Tensor, masks: tuple, clip, gray) -> float:
    """Device ms from the end of a pageable copy of the uint8 clip to its
    last band, grey conversion included, median of 7 after a warm-up."""
    host = rgb[:clip[0] * clip[1]].cpu().reshape(
        tuple(clip) + tuple(rgb.shape[1:])).numpy()
    times = []
    for _ in range(8):
        x = torch.from_numpy(host).cuda()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        list(pyramid._bands(pyramid.fft2_shifted(gray(x.float())), masks))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def kernels_per_call(fn) -> dict:
    """CUDA kernels of one ``fn()`` by ``torch.profiler``: all, and those
    whose name holds "fft" (None where the profiler saw no device work)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        return {"all": None, "fft": None}
    return {"all": len(names),
            "fft": sum("fft" in n.lower() for n in names)}


def timings(rgb: torch.Tensor, spec: PyramidSpec, group: int,
            gray) -> dict:
    masks = pyramid.band_masks(spec, rgb.device)[:spec.height]
    out = {}
    for tag, clip in (("clip_8x48", CLIP), ("feed_8x17", (8, CHUNK + 1))):
        n = clip[0] * clip[1]
        x = rgb[:n].float()
        g = gray(x)

        def call():
            return list(pyramid._bands(pyramid.fft2_shifted(g), masks))

        host = []
        for _ in range(11):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            host.append((time.perf_counter() - t) * 1e3)
        out[tag] = {"fft_bands_ms": fft_bands_ms(rgb, masks, clip, gray),
                    "gray_ms": time_ms(lambda: gray(x)),
                    "back_to_back_ms": time_ms(call),
                    "host_issue_ms": statistics.median(host),
                    "fft_calls": -(-n // (group or n)) * (1 + spec.height),
                    "padded_frames": -n % (group or n),
                    "kernels": kernels_per_call(call)}
    out["gray_card_vs_cpu_unequal"] = unequal(
        gray(rgb.float()).cpu(), gray(rgb.cpu().float()))
    return out


def check(rgb: torch.Tensor, spec: PyramidSpec, phase_spec: PhaseSpec,
          sizes=SIZES, frames=FRAMES, clip=CLIP) -> dict:
    """The port's phase stage: :func:`invariance` and
    :func:`stacks_vs_chunks`; ``"equal"`` says whether every count is 0."""
    counts = invariance(rgb, spec, sizes, frames)
    stacks = stacks_vs_chunks(rgb, spec, phase_spec, clip)
    return {"equal": all_equal(counts) and not stacks["unequal"],
            "counts": counts, "stacks_vs_chunks": stacks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gray", choices=sorted(GRAY), default="port")
    ap.add_argument("--groups", default="0",
                    help="FFT calls to try: 0 = the port's, G = G frames "
                    "a call")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None, help="write every count here")
    args = ap.parse_args(argv)
    dev = device(args.cpu)
    line = "cpu" if args.cpu else card()
    print(line, flush=True)
    size, total = (32, 24) if args.cpu else (112, 384)
    spec = PyramidSpec(input_size=(size, size))
    phase_spec = PhaseSpec(phase_size=16 if args.cpu else 48)
    rgb = crops(total, size, dev)
    sizes = (1, 3, 8, 17, 24) if args.cpu else SIZES
    frames = (0, 11, 23) if args.cpu else FRAMES
    clip = (1, 24) if args.cpu else CLIP
    gray = GRAY[args.gray]
    report = {}
    with torch.no_grad():
        for group in map(int, args.groups.split(",")):
            with fft_calls(group):
                counts = invariance(rgb, spec, sizes, frames, gray)
                row = {"gray": args.gray, "fft_group": group,
                       "equal": all_equal(counts), "counts": counts,
                       "stacks_vs_chunks": stacks_vs_chunks(
                           rgb, spec, phase_spec, clip, gray)}
                if not args.cpu:
                    row["time"] = timings(rgb, spec, group, gray)
            report[group] = row
            print(json.dumps({**row, "card": line}), flush=True)
    print(json.dumps({"fft_invariance": {
        g: {"gray": args.gray, "equal": r["equal"],
            "stacks_vs_chunks": r["stacks_vs_chunks"]}
        for g, r in report.items()}, "card": line}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": line, "modes": report}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
