"""Crop preprocessing for the two streams (PyTorch).

Counterpart of ``to_grayscale``, ``upscale2x`` and ``for_backbone`` in
``mimamo_tpu/preprocess.py``: BT.601 luma for the micro stream, and the
MatConvNet-style backbone input (exact 2x bilinear upscale of the aligned
crop, per-channel mean subtraction, no scaling) for the macro stream. On
the runner's path the backbone input is never materialized: the stem
kernel forms it on the fly (``kernels.stem_kernel``); ``for_backbone`` is
the plain reference for it.
"""

from __future__ import annotations

import torch

from .config import BackboneSpec

# ITU-R BT.601 luma weights (cv2.cvtColor RGB2GRAY convention).
_LUMA_RGB = (0.299, 0.587, 0.114)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def work_dtype(spec: BackboneSpec) -> torch.dtype:
    return _DTYPES[spec.dtype]


def to_grayscale(frames_rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] RGB -> [..., H, W] BT.601 luma."""
    wts = torch.tensor(_LUMA_RGB, dtype=frames_rgb.dtype,
                       device=frames_rgb.device)
    return frames_rgb @ wts


def _upscale2x_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact 2x bilinear upscale (half-pixel centers, edge clamp) along
    ``dim``: sample 2i = 0.25 x[i-1] + 0.75 x[i], sample 2i+1 =
    0.75 x[i] + 0.25 x[i+1]."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    shape = list(x.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim=dim + 1).reshape(shape)


def upscale2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upscale of the (-3, -2) spatial axes of [..., H, W, C]."""
    return _upscale2x_axis(_upscale2x_axis(x, x.dim() - 3), x.dim() - 2)


def for_backbone(crops_rgb: torch.Tensor, spec: BackboneSpec) -> torch.Tensor:
    """[..., S, S, 3] RGB crops (0..255) -> [..., 2S, 2S, 3] backbone
    input in fp32: mean-subtracted, then exactly 2x upscaled, in the
    configured channel order (the stem kernel's arithmetic order)."""
    mean = torch.tensor(spec.mean_rgb, dtype=torch.float32,
                        device=crops_rgb.device)
    x = upscale2x(crops_rgb.to(torch.float32) - mean)
    return x.flip(-1) if spec.channel_order == "bgr" else x
