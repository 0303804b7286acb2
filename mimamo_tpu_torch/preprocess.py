"""Crop preprocessing for the two streams, and the sliding-window helpers
(PyTorch).

Counterpart of ``to_grayscale``, ``upscale2x`` and ``for_backbone`` in
``mimamo_tpu/preprocess.py``: BT.601 luma for the micro stream, and the
MatConvNet-style backbone input (exact 2x bilinear upscale of the aligned
crop, per-channel mean subtraction, no scaling) for the macro stream. On
the runner's path the backbone input is never materialized: the stem
kernel forms it on the fly (``kernels.stem_kernel``); ``for_backbone`` is
the plain reference for it.

``pad_short_clip``, ``window_starts``, ``sliding_windows`` and
``merge_window_predictions`` are the window bookkeeping of
``predict_from_crops`` (same file of the JAX package): index math and a
[N, clip_len, 2] -> [T, 2] average, on the host in numpy.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
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


def pad_short_clip(crops: Union[np.ndarray, torch.Tensor], clip_len: int):
    """Pad a [T < clip_len, ...] crop sequence by repeating its last crop
    (a static tail contributes ~zero phase differences); callers trim the
    outputs back to the true length. Longer sequences pass through."""
    t = crops.shape[0]
    if t >= clip_len:
        return crops
    if isinstance(crops, np.ndarray):
        return np.concatenate(
            [crops, np.repeat(crops[-1:], clip_len - t, axis=0)])
    return torch.cat(
        [crops, crops[-1:].expand((clip_len - t,) + tuple(crops.shape[1:]))])


def window_starts(t: int, clip_len: int, stride: int) -> np.ndarray:
    """Start frames of the sliding windows over a T-frame sequence; the
    last window is right-aligned so the tail is covered."""
    if t < clip_len:
        raise ValueError(f"sequence length {t} < clip_len {clip_len}")
    starts = list(range(0, t - clip_len + 1, stride))
    if starts[-1] != t - clip_len:
        starts.append(t - clip_len)
    return np.asarray(starts, np.int32)


def sliding_windows(x: Union[np.ndarray, torch.Tensor], clip_len: int,
                    stride: int) -> Tuple[Union[np.ndarray, torch.Tensor],
                                          np.ndarray]:
    """Slice [T, ...] into overlapping [N, clip_len, ...] windows; returns
    (windows, starts), see :func:`window_starts`."""
    starts = window_starts(x.shape[0], clip_len, stride)
    idx = starts[:, None] + np.arange(clip_len)[None, :]
    if isinstance(x, np.ndarray):
        return x[idx], starts
    return x[torch.from_numpy(idx).to(x.device, torch.long)], starts


def merge_window_predictions(preds, starts: np.ndarray,
                             total_len: int) -> np.ndarray:
    """Overlap-average [N, clip_len, D] window outputs back to [T, D], on
    the host (the arrays are tiny and every caller already holds them
    there); accumulates in float64 and returns the input dtype."""
    preds = np.asarray(preds)
    _n, clip_len, d = preds.shape
    idx = (np.asarray(starts)[:, None]
           + np.arange(clip_len)[None, :]).reshape(-1)
    acc = np.zeros((total_len, d), np.float64)
    cnt = np.zeros((total_len, 1), np.float64)
    np.add.at(acc, idx, preds.reshape(-1, d).astype(np.float64))
    np.add.at(cnt, idx, 1.0)
    return (acc / np.maximum(cnt, 1.0)).astype(preds.dtype)
