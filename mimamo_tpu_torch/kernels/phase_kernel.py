"""Phase difference + bilinear resize: CUDA kernel and its plain version.

Counterpart of ``mimamo_tpu/pallas/phase_kernel.py``
(``phase_diff_resize_blocked`` and ``micro_motion_features_fused``). The
kernel is ``csrc/phase_diff_resize.cu``; the FFTs and mask products stay
in ``torch.fft``, as the TPU kernel left them to XLA.

The kernel works on strips of output rows (see the source): this module
plans the strips (:func:`strip_plan`, plain numpy, so the CPU tests reach
it), sizes the grid and the shared memory, and hands the kernel one table
of scales, so that all scales of a forward go in one launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import phase, pyramid, tracing
from ..config import PhaseSpec, PyramidSpec
from ._build import I, P, Kernel

KERNEL = Kernel("mimamo_phase_diff_resize", [P, I, I, P])

MAX_SCALES = 8                # kMaxScales of the kernel
BUFS = 3                      # kBufs of the kernel: strip buffers a block
SMEM_LIMIT = 227 * 1024       # dynamic shared memory a block may have
MAX_P = 2047                  # the kernel indexes P * P outputs in fp32
# A strip holds at most this many bytes of one frame's complex64 rows (BUFS
# such buffers and the strip's fp32 dphi make a block's shared memory), and
# a plane's frames are cut into runs until the grid has about this many
# blocks: short runs even out the load over the SMs, at the price of one
# frame read again per run. ``bench_phase.py --sweep`` times the kernel over
# a grid of both at the clip step and the streaming step.
STRIP_BYTES = 8 * 1024
TARGET_BLOCKS = 8448


class _Scale(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("band", "strips", "row_idx", "row_wts", "col_idx",
                  "col_wts")]
                + [(name, ctypes.c_int) for name in
                   ("h", "w", "c0", "ns", "first_block", "pad")])


class _Params(ctypes.Structure):
    _fields_ = ([("scale", _Scale * MAX_SCALES)]
                + [(name, ctypes.c_void_p) for name in
                   ("out", "partial", "count")]
                + [(name, ctypes.c_int) for name in
                   ("n_scales", "B", "T", "K", "P", "C", "run_len",
                    "weighting", "buf_elems", "ns_max", "tab_rows")])


def strip_plan(h: int, w: int, p: int, weighting: bool,
               strip_bytes: int = STRIP_BYTES) -> np.ndarray:
    """Cut the ``p`` output rows of an h x w plane into strips.

    Returns [NS, 6] int32, one row per strip: first and end output row; the
    first source row the strip holds and how many; first and end source row
    it owns. Output row ``i`` reads source rows ``resize_taps(h, p)[0][i]``,
    so a strip holds the span from its first row's first tap to its last
    row's second tap. Strips take equally many output rows: the fewest strips
    that keep every span within ``strip_bytes`` of complex64 (a strip has
    at least one row). The
    owned rows partition ``0..h`` (a strip owns from its first tap to the
    next strip's); with ``weighting`` a strip also holds all rows it owns,
    for the plane-wide sum of amplitudes.
    """
    idx, _ = phase.resize_taps(h, p)
    lo, hi = idx[:, 0].astype(np.int64), idx[:, 1].astype(np.int64)

    def cut(rows):
        return [(p0, min(p0 + rows, p)) for p0 in range(0, p, rows)]

    rows = next((n for n in range(p, 0, -1)
                 if all((hi[p1 - 1] - lo[p0] + 1) * w * 8 <= strip_bytes
                        for p0, p1 in cut(n))), 1)
    strips = cut(-(-p // -(-p // rows)))      # as many strips, evened out
    plan = np.zeros((len(strips), 6), np.int32)
    for j, (p0, p1) in enumerate(strips):
        r0, r1 = lo[p0], hi[p1 - 1] + 1
        own0 = 0 if j == 0 else lo[p0]
        own1 = h if j == len(strips) - 1 else lo[strips[j + 1][0]]
        if weighting:
            r0, r1 = min(r0, own0), max(r1, own1)
        plan[j] = (p0, p1, r0, r1 - r0, own0, own1)
    return plan


@functools.lru_cache(maxsize=32)
def _taps(src: int, dst: int, device: torch.device):
    idx, wts = phase.resize_taps(src, dst)
    return (torch.from_numpy(np.ascontiguousarray(idx)).to(device),
            torch.from_numpy(np.ascontiguousarray(wts)).to(device))


def _check(band: torch.Tensor, out: torch.Tensor, channel: int) -> None:
    if band.dim() != 5 or band.dtype != torch.complex64:
        raise ValueError(f"band must be [B, T, K, h, w] complex64, got "
                         f"{tuple(band.shape)} {band.dtype}")
    b, t, k = band.shape[:3]
    if t < 2:
        raise ValueError(f"band needs at least 2 frames, got T={t}")
    if (out.dim() != 5 or out.dtype != torch.float32
            or tuple(out.shape[:2]) != (b, t - 1)
            or out.shape[-1] != out.shape[-2]
            or not 0 <= channel <= out.shape[2] - k):
        raise ValueError(f"out must be [{b}, {t - 1}, C >= {channel + k}, "
                         f"P, P] float32, got {tuple(out.shape)} {out.dtype}")
    if band.device != out.device:
        raise ValueError(f"band on {band.device}, out on {out.device}")


def phase_diff_resize_scales(bands: Sequence[torch.Tensor],
                             out: torch.Tensor, channels: Sequence[int],
                             amplitude_weighting: bool) -> torch.Tensor:
    """Write the resized phase differences of consecutive frames of every
    band into ``out`` and return ``out``.

    Args:
      bands: per scale, [B, T, K, h_s, w_s] complex64, contiguous (the same
        B, T and K; any h_s, w_s).
      out: [B, T-1, C, P, P] float32, contiguous; band ``s`` writes
        channels ``channels[s] .. channels[s]+K-1``.
      amplitude_weighting: scale each map by |prod| / (mean|prod| + 1e-6).

    CUDA tensors go through the kernel, all scales in one launch; CPU
    tensors through the plain version (:func:`phase.phase_diff_resize`).
    """
    if not 1 <= len(bands) <= MAX_SCALES or len(bands) != len(channels):
        raise ValueError(f"need 1..{MAX_SCALES} bands and as many channel "
                         f"offsets, got {len(bands)} and {len(channels)}")
    for band, channel in zip(bands, channels):
        _check(band, out, channel)
        if (band.shape[:3] != bands[0].shape[:3]
                or band.device != bands[0].device):
            raise ValueError("the bands must share B, T, K and the device")
    b, t, k = bands[0].shape[:3]
    p = out.shape[-1]
    device = out.device
    if device.type == "cpu":
        for band, channel in zip(bands, channels):
            out[:, :, channel:channel + k] = phase.phase_diff_resize(
                band, p, amplitude_weighting)
        return out
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not (out.is_contiguous() and all(x.is_contiguous() for x in bands)):
        raise ValueError("the bands and out must be contiguous")
    if p > MAX_P:
        raise ValueError(f"phase_size {p} is over the kernel's {MAX_P}")

    prm, n_blocks, smem, _tables = _launch_plan(
        tuple(tuple(x.shape[-2:]) for x in bands), tuple(channels), b, t, k,
        p, out.shape[2], bool(amplitude_weighting), device)
    prm = _Params.from_buffer_copy(prm)
    prm.out = out.data_ptr()
    for s, band in enumerate(bands):
        prm.scale[s].band = band.data_ptr()
    if amplitude_weighting:
        # scratch of this launch; the allocator hands it to no one before
        # the launch has run, because reuse is ordered on the stream
        pairs = len(bands) * b * (t - 1) * k
        partial = torch.empty(pairs * prm.ns_max, dtype=torch.float32,
                              device=device)
        count = torch.zeros(pairs, dtype=torch.int32, device=device)
        prm.partial, prm.count = partial.data_ptr(), count.data_ptr()
    KERNEL(ctypes.addressof(prm), n_blocks, smem,
           torch.cuda.current_stream(device).cuda_stream)
    return out


@functools.lru_cache(maxsize=32)
def _launch_plan(sizes: Tuple[Tuple[int, int], ...],
                 channels: Tuple[int, ...], b: int, t: int, k: int, p: int,
                 c: int, weighting: bool, device: torch.device):
    """Everything of a launch that depends on the shapes alone: the kernel's
    parameters without the data pointers, the grid, the shared memory, and
    the device tables the parameters point to (kept alive here)."""
    prm = _Params(n_scales=len(sizes), B=b, T=t, K=k, P=p, C=c,
                  weighting=int(weighting))
    tables: List[torch.Tensor] = []
    units = 0
    for s, ((h, w), channel) in enumerate(zip(sizes, channels)):
        plan = strip_plan(h, w, p, weighting, STRIP_BYTES)
        elems = int(plan[:, 3].max()) * w
        taps = _taps(h, p, device) + _taps(w, p, device)
        tables += [torch.from_numpy(plan).to(device), *taps]
        sc = prm.scale[s]
        sc.strips = tables[-5].data_ptr()
        sc.row_idx, sc.row_wts, sc.col_idx, sc.col_wts = (
            x.data_ptr() for x in taps)
        sc.h, sc.w, sc.c0, sc.ns = h, w, channel, len(plan)
        prm.buf_elems = max(prm.buf_elems, elems + -elems % 4)
        prm.ns_max = max(prm.ns_max, len(plan))
        prm.tab_rows = max(prm.tab_rows,
                           int((plan[:, 1] - plan[:, 0]).max()))
        units += b * k * len(plan)
    # the strip buffers, the strip's dphi, the row and column tap tables
    smem = (BUFS * (prm.buf_elems + 2) * 8 + prm.buf_elems * 4
            + (prm.tab_rows + p) * 16)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a strip of the widest band needs {smem} bytes of "
                         f"shared memory, over the {SMEM_LIMIT} a block has")
    # cut the T-1 pairs of a plane into runs until the grid fills the card
    n_runs = min(t - 1, max(1, TARGET_BLOCKS // units))
    prm.run_len = -(-(t - 1) // n_runs)
    n_runs = -(-(t - 1) // prm.run_len)          # none of them empty
    n_blocks = 0
    for s in range(len(sizes)):
        prm.scale[s].first_block = n_blocks
        n_blocks += n_runs * b * k * prm.scale[s].ns
    return prm, n_blocks, smem, tables


def phase_diff_resize(band: torch.Tensor, out: torch.Tensor, channel: int,
                      amplitude_weighting: bool) -> torch.Tensor:
    """One band [B, T, K, h, w] into channels ``channel .. channel+K-1`` of
    ``out``: :func:`phase_diff_resize_scales` with a single scale."""
    return phase_diff_resize_scales([band], out, [channel],
                                    amplitude_weighting)


def micro_motion_features_fused(frames: torch.Tensor,
                                pyramid_spec: PyramidSpec,
                                phase_spec: PhaseSpec) -> torch.Tensor:
    """[B, T, H, W] grayscale -> [B, T-1, S*K, P, P] float32, with the
    phase-difference + resize stage in the kernel (one launch, each scale
    writing its channel slice of the one output buffer)."""
    b, t = frames.shape[:2]
    k, p = pyramid_spec.orientations, phase_spec.phase_size
    out = torch.empty((b, t - 1, pyramid_spec.height * k, p, p),
                      dtype=torch.float32, device=frames.device)
    with tracing.span("micro.bands", frames.device):
        masks = pyramid.band_masks(pyramid_spec, frames.device)
        bands = list(pyramid.bands(frames, pyramid_spec, masks))
    with tracing.span("micro.phase_kernel", frames.device):
        return phase_diff_resize_scales(
            bands, out, [s * k for s in range(len(bands))],
            phase_spec.amplitude_weighting)
