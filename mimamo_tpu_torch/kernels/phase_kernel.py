"""Phase difference + bilinear resize: CUDA kernel and its plain version.

Counterpart of ``mimamo_tpu/pallas/phase_kernel.py``
(``phase_diff_resize_blocked`` and ``micro_motion_features_fused``). The
kernel is ``csrc/phase_diff_resize.cu``; the FFTs and mask products stay
in ``torch.fft``, as the TPU kernel left them to XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import phase, pyramid
from ..config import PhaseSpec, PyramidSpec
from ._build import I, P, Kernel

KERNEL = Kernel("mimamo_phase_diff_resize",
                [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P])


@functools.lru_cache(maxsize=32)
def _taps(src: int, dst: int, device: torch.device):
    idx, wts = phase.resize_taps(src, dst)
    return (torch.from_numpy(np.ascontiguousarray(idx)).to(device),
            torch.from_numpy(np.ascontiguousarray(wts)).to(device))


def phase_diff_resize(band: torch.Tensor, out: torch.Tensor, channel: int,
                      amplitude_weighting: bool) -> torch.Tensor:
    """Write the resized phase differences of consecutive frames of
    ``band`` into ``out`` and return ``out``.

    Args:
      band: [B, T, K, h, w] complex64, contiguous.
      out: [B, T-1, C, P, P] float32, contiguous; channels
        ``channel .. channel+K-1`` are written.
      amplitude_weighting: scale each map by |prod| / (mean|prod| + 1e-6).

    A CUDA tensor goes through the kernel; a CPU tensor through the plain
    version (:func:`phase.phase_diff_resize`).
    """
    if band.dim() != 5 or band.dtype != torch.complex64:
        raise ValueError(f"band must be [B, T, K, h, w] complex64, got "
                         f"{tuple(band.shape)} {band.dtype}")
    b, t, k, h, w = band.shape
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
    p = out.shape[-1]
    if band.device.type == "cpu":
        out[:, :, channel:channel + k] = phase.phase_diff_resize(
            band, p, amplitude_weighting)
        return out
    if band.device.type != "cuda":
        raise ValueError(f"unsupported device {band.device}")
    if not (band.is_contiguous() and out.is_contiguous()):
        raise ValueError("band and out must be contiguous")
    row_idx, row_wts = _taps(h, p, band.device)
    col_idx, col_wts = _taps(w, p, band.device)
    KERNEL(band.data_ptr(), out.data_ptr(), row_idx.data_ptr(),
           row_wts.data_ptr(), col_idx.data_ptr(), col_wts.data_ptr(),
           b, t, k, h, w, p, out.shape[2], channel,
           int(amplitude_weighting),
           torch.cuda.current_stream(band.device).cuda_stream)
    return out


def micro_motion_features_fused(frames: torch.Tensor,
                                pyramid_spec: PyramidSpec,
                                phase_spec: PhaseSpec) -> torch.Tensor:
    """[B, T, H, W] grayscale -> [B, T-1, S*K, P, P] float32, with the
    phase-difference + resize stage in the kernel (one launch per scale,
    each writing its channel slice of the one output buffer)."""
    b, t = frames.shape[:2]
    k, p = pyramid_spec.orientations, phase_spec.phase_size
    out = torch.empty((b, t - 1, pyramid_spec.height * k, p, p),
                      dtype=torch.float32, device=frames.device)
    masks = pyramid.band_masks(pyramid_spec, frames.device)
    for s, band in enumerate(pyramid.bands(frames, pyramid_spec, masks)):
        phase_diff_resize(band, out, s * k,
                          phase_spec.amplitude_weighting)
    return out
