"""Inter-frame phase-difference (micro-motion) extraction, plain PyTorch.

Counterpart of ``mimamo_tpu/phase.py``. Per consecutive-frame pair and per
(scale, orientation) band, ``dphi = angle(c_t * conj(c_{t-1}))`` wrapped to
(-pi, pi], optionally amplitude-weighted, each map bilinearly resized to
``phase_size`` and the S*K maps stacked as channels c = s*K + k.

This is the plain version of the micro-motion path: the CPU tests hold it
against the JAX package, and ``kernels.phase_kernel`` holds the CUDA
kernel against it. The runner goes through the kernel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from . import pyramid as pyr_mod
from .config import PhaseSpec, PyramidSpec


@functools.lru_cache(maxsize=64)
def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] bilinear interpolation matrix, half-pixel centers.

    Matches ``torch.nn.functional.interpolate(mode='bilinear',
    align_corners=False)`` sampling with edge clamping. Every row has at
    most two nonzeros (see :func:`resize_taps`).
    """
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo
    w = np.zeros((dst, src), dtype=np.float64)
    rows = np.arange(dst)
    w[rows, np.clip(lo, 0, src - 1)] += 1.0 - frac
    w[rows, np.clip(lo + 1, 0, src - 1)] += frac
    return w.astype(np.float32)


@functools.lru_cache(maxsize=64)
def resize_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """The two taps of each row of :func:`_resize_matrix`.

    Returns (idx [dst, 2] int32, wts [dst, 2] float32) with
    ``_resize_matrix(src, dst)[i] == sum_a wts[i, a] * onehot(idx[i, a])``;
    a clamped edge row has both taps on one source index.
    """
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo
    idx = np.stack([np.clip(lo, 0, src - 1), np.clip(lo + 1, 0, src - 1)],
                   axis=1).astype(np.int32)
    wts = np.stack([1.0 - frac, frac], axis=1).astype(np.float32)
    return idx, wts


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """Bilinear-resize the trailing two dims of ``x`` as ``R_h x R_w^T``
    (float32 matmuls; the caller keeps TF32 off)."""
    h, w = x.shape[-2], x.shape[-1]
    p, q = out_hw
    rh = torch.from_numpy(_resize_matrix(h, p)).to(x.device)   # [P, h]
    rw = torch.from_numpy(_resize_matrix(w, q)).to(x.device)   # [Q, w]
    return rh @ (x @ rw.T)


def phase_diff(c_t: torch.Tensor, c_prev: torch.Tensor) -> torch.Tensor:
    """Wrapped phase difference angle(c_t * conj(c_prev)) in (-pi, pi]."""
    prod = c_t * torch.conj(c_prev)
    return torch.atan2(prod.imag, prod.real)


def phase_diff_resize(band: torch.Tensor, phase_size: int,
                      amplitude_weighting: bool) -> torch.Tensor:
    """[B, T, K, h, w] complex band -> [B, T-1, K, P, P] resized,
    optionally amplitude-weighted phase differences of consecutive
    frames."""
    dphi = phase_diff(band[:, 1:], band[:, :-1])
    if amplitude_weighting:
        amp = torch.abs(band[:, 1:]) * torch.abs(band[:, :-1])
        denom = torch.mean(amp, dim=(-2, -1), keepdim=True) + 1e-6
        dphi = dphi * (amp / denom)
    return resize_bilinear(dphi, (phase_size, phase_size))


def num_phase_channels(pyramid_spec: PyramidSpec) -> int:
    """Channels of a phase-difference stack: one per (scale, orientation)."""
    return pyramid_spec.height * pyramid_spec.orientations


def micro_motion_features(frames: torch.Tensor, pyramid_spec: PyramidSpec,
                          phase_spec: PhaseSpec) -> torch.Tensor:
    """Grayscale frames [B, T, H, W] -> [B, T-1, S*K, P, P] float32
    phase-diff stacks (channel c = s*K + k)."""
    masks = pyr_mod.band_masks(pyramid_spec, frames.device)
    return torch.cat([
        phase_diff_resize(band, phase_spec.phase_size,
                          phase_spec.amplitude_weighting)
        for band in pyr_mod.bands(frames, pyramid_spec, masks)], dim=2)
