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

:func:`bands` is the micro stream's path; :func:`build` returns the whole
pyramid (highpass residual, bands, lowpass residual) and
:func:`reconstruct` inverts it, to check the filter bank.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def _bands(x: torch.Tensor, masks: Tuple[torch.Tensor, ...]
           ) -> Iterator[torch.Tensor]:
    """The oriented bands of the fftshifted spectrum ``x`` [..., H, W], one
    [..., K, H/2^s, W/2^s] complex64 tensor per scale s."""
    for s, mask in enumerate(masks):
        yield ifft2_shifted(_crop(x, s).unsqueeze(-3) * mask)


def bands(frames: torch.Tensor, spec: PyramidSpec,
          masks: Tuple[torch.Tensor, ...]) -> Iterator[torch.Tensor]:
    """The oriented complex bands of ``frames`` [..., H, W], one
    [..., K, H/2^s, W/2^s] complex64 tensor per scale s of ``spec``
    (``masks``: :func:`band_masks`)."""
    return _bands(fft2_shifted(frames.to(torch.float32)),
                  masks[:spec.height])


Pyramid = Dict[str, object]


def build(frames: torch.Tensor, spec: PyramidSpec) -> Pyramid:
    """Decompose grayscale frames [..., H, W] ((H, W) = ``spec.input_size``)
    into the complex steerable pyramid: ``{"high": [..., H, W] float32,
    "bands": tuple over scale of [..., K, H/2^s, W/2^s] complex64, "low":
    [..., H/2^S, W/2^S] float32}``."""
    if tuple(frames.shape[-2:]) != tuple(spec.input_size):
        raise ValueError(
            f"frames spatial shape {tuple(frames.shape[-2:])} != "
            f"spec.input_size {tuple(spec.input_size)}")
    m = make_masks(spec)
    dev = frames.device
    x = fft2_shifted(frames.to(torch.float32))
    high = ifft2_shifted(x * torch.from_numpy(m["hi0"][0]).to(dev)).real
    low = ifft2_shifted(_crop(x, spec.height)
                        * torch.from_numpy(m["low"][0]).to(dev)).real
    return {"high": high, "bands": tuple(_bands(x, band_masks(spec, dev))),
            "low": low}


def _pad_spectrum(y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Zero-pad a cropped fftshifted spectrum back to the full (h, w)."""
    hs, ws = y.shape[-2], y.shape[-1]
    y0, x0 = h // 2 - hs // 2, w // 2 - ws // 2
    return F.pad(y, (x0, w - x0 - ws, y0, h - y0 - hs))


def reconstruct(pyr: Pyramid, spec: PyramidSpec) -> torch.Tensor:
    """Invert :func:`build` (perfect reconstruction up to fp32 FFT error):
    [..., H, W] float32. It checks the filter bank; no inference path
    calls it."""
    m = make_masks(spec)
    h, w = spec.input_size
    dev = pyr["high"].device

    def herm_sym(d: torch.Tensor) -> torch.Tensor:
        # (d(f) + conj(d(-f))) / 2 on an even fftshifted grid: -f is a
        # flip and a roll by one (the Nyquist row and column map to
        # themselves)
        mirror = torch.roll(d.flip(-2, -1), shifts=(1, 1), dims=(-2, -1))
        return 0.5 * (d + torch.conj(mirror))

    acc = fft2_shifted(pyr["high"]) * torch.from_numpy(m["hi0"][0]).to(dev)
    acc = acc + _pad_spectrum(
        fft2_shifted(pyr["low"]) * torch.from_numpy(m["low"][0]).to(dev),
        h, w)
    for band, mask in zip(pyr["bands"], band_masks(spec, dev)):
        contrib = (fft2_shifted(band) * torch.conj(mask)).sum(dim=-3)
        # each orientation covered one half-plane (doubled); the
        # symmetrization restores the mirror lobe, and the angular windows
        # sum to 1 over both lobes, so 0.5 closes the identity
        # hi0^2 + sum_s B_s^2 + lo^2 = 1
        acc = acc + 0.5 * _pad_spectrum(herm_sym(contrib), h, w)
    return ifft2_shifted(acc).real


def band_shapes(spec: PyramidSpec) -> Tuple[Tuple[int, int, int], ...]:
    """(K, H/2^s, W/2^s) of each scale s."""
    h, w = spec.input_size
    return tuple((spec.orientations, h >> s, w >> s)
                 for s in range(spec.height))
