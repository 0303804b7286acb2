"""Complex steerable pyramid as batched FFT-domain filtering (PyTorch).

Counterpart of ``mimamo_tpu/pyramid.py``. The pyramid is a fixed linear
operator: all radial/angular masks are precomputed in NumPy (an own copy
of the JAX package's mask code, bit-identical), and a band is
``ifft2(crop(fft2(x)) * mask)`` on the cropped grid of its scale. The
FFTs are ``torch.fft`` (cuFFT on the card) in complex64.

Conventions: radial coordinate normalized so the spectrum edge midpoint is
r = pi; raised-cosine transitions one octave wide in log2(r); the oriented
band at scale s lives on the central (H/2^s, W/2^s) box of the fftshifted
spectrum; unnormalized forward / 1/N inverse FFT (numpy default).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .config import PyramidSpec


def _freq_grid(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """fftshifted frequency grid: log2-radius (edge midpoint = 0) and angle."""
    fy = (np.arange(h) - h // 2) / (h / 2.0)
    fx = (np.arange(w) - w // 2) / (w / 2.0)
    xr, yr = np.meshgrid(fx, fy)
    angle = np.arctan2(yr, xr)
    rad = np.sqrt(xr * xr + yr * yr)
    # Avoid log2(0) at DC: reuse the smallest nonzero radius (SCFpyr
    # convention); DC lands fully in the lowpass either way.
    rad[h // 2, w // 2] = rad[h // 2, w // 2 - 1]
    return np.log2(rad), angle


def _lo_transition(log_rad: np.ndarray, log_r0: float) -> np.ndarray:
    """Raised-cosine lowpass L(r; r0) in log2 domain."""
    t = log_rad - log_r0
    ramp = np.cos((np.pi / 2.0) * (np.clip(t, -1.0, 0.0) + 1.0))
    return np.where(t <= -1.0, 1.0, np.where(t >= 0.0, 0.0, ramp))


def _hi_transition(log_rad: np.ndarray, log_r0: float) -> np.ndarray:
    lo = _lo_transition(log_rad, log_r0)
    return np.sqrt(np.maximum(0.0, 1.0 - lo * lo))


def _angular_windows(angle: np.ndarray, k_bands: int) -> List[np.ndarray]:
    """Steering windows G_k(theta) = alpha_K cos(theta - pi k/K)^(K-1) on the
    half-plane cos(theta - pi k/K) > 0."""
    order = k_bands - 1
    alpha = (2.0 ** order) * math.factorial(order) / math.sqrt(
        k_bands * math.factorial(2 * order))
    out = []
    for k in range(k_bands):
        c = np.cos(angle - np.pi * k / k_bands)
        out.append(np.where(c > 0.0, alpha * np.power(np.abs(c), order), 0.0))
    return out


def _crop_slices(h: int, w: int, scale: int) -> Tuple[slice, slice]:
    """Central (h/2^s, w/2^s) box of an fftshifted (h, w) spectrum."""
    hs, ws = h >> scale, w >> scale
    y0 = h // 2 - hs // 2
    x0 = w // 2 - ws // 2
    return slice(y0, y0 + hs), slice(x0, x0 + ws)


@functools.lru_cache(maxsize=8)
def make_masks(spec: PyramidSpec) -> Dict[str, tuple]:
    """Precompute all pyramid masks for a given spec (numpy constants).

    Returns:
      hi0:   (H, W) float32 highpass residual mask (full res)
      bands: tuple over scale s of (K, H/2^s, W/2^s) complex64 oriented
             analytic band masks on the cropped grid
      low:   (H/2^S, W/2^S) float32 lowpass residual mask (cropped grid)
    """
    h, w = spec.input_size
    s_scales, k_bands = spec.height, spec.orientations
    log_rad, angle = _freq_grid(h, w)
    g_k = _angular_windows(angle, k_bands)

    hi0 = _hi_transition(log_rad, 0.0)
    lo_cum = _lo_transition(log_rad, 0.0)

    cfac = (-1j) ** (k_bands - 1) if spec.complex_factor else 1.0 + 0.0j
    per_scale = []
    for s in range(s_scales):
        log_r0 = -float(s + 1)
        hi_s = _hi_transition(log_rad, log_r0)
        radial = lo_cum * hi_s          # ring: peak at r0, 2-octave support
        ys, xs = _crop_slices(h, w, s)
        per_orient = np.stack(
            [2.0 * radial[ys, xs] * g[ys, xs] for g in g_k], axis=0)
        per_scale.append((per_orient * cfac).astype(np.complex64))
        lo_cum = lo_cum * _lo_transition(log_rad, log_r0)

    ys, xs = _crop_slices(h, w, s_scales)
    low = lo_cum[ys, xs]
    return {
        "hi0": (hi0.astype(np.float32),),
        "bands": tuple(per_scale),
        "low": (low.astype(np.float32),),
    }


@functools.lru_cache(maxsize=8)
def band_masks(spec: PyramidSpec, device: torch.device
               ) -> Tuple[torch.Tensor, ...]:
    """The per-scale complex64 band masks of ``spec`` as tensors on
    ``device``."""
    return tuple(torch.from_numpy(m).to(device)
                 for m in make_masks(spec)["bands"])


def fft2_shifted(x: torch.Tensor) -> torch.Tensor:
    """fftshift(fft2(x)) over the trailing two axes, complex64."""
    return torch.fft.fftshift(torch.fft.fft2(x.to(torch.complex64)),
                              dim=(-2, -1))


def ifft2_shifted(y: torch.Tensor) -> torch.Tensor:
    """ifft2(ifftshift(y)) over the trailing two axes."""
    return torch.fft.ifft2(torch.fft.ifftshift(y, dim=(-2, -1)))


def _crop(x: torch.Tensor, scale: int) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    ys, xs = _crop_slices(h, w, scale)
    return x[..., ys, xs]


def bands(frames: torch.Tensor, spec: PyramidSpec,
          masks: Tuple[torch.Tensor, ...]):
    """Yield the oriented complex bands of ``frames`` [..., H, W], one
    [..., K, H/2^s, W/2^s] complex64 tensor per scale s."""
    x = fft2_shifted(frames.to(torch.float32))
    for s in range(spec.height):
        xc = _crop(x, s).unsqueeze(-3)                  # [..., 1, hs, ws]
        yield ifft2_shifted(xc * masks[s])
