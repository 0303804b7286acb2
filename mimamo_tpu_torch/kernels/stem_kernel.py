"""Fused ResNet stem: CUDA kernel and its plain version.

Counterpart of ``mimamo_tpu/pallas/stem_kernel.py`` (``stem_fused``,
``prepare_stem_weights``, ``prepare_stem_input``): from RGB crops in
0..255, ``max_pool3x3/2(relu(conv1_7x7/2(upscale2x(crop - mean)) + b))``
with BN folded into conv1 and the BGR flip, when configured, folded into
the weights. The upscale and mean subtraction run in fp32 and round to the
conv dtype where conv1 casts; the conv accumulates in fp32. The kernels are
in ``csrc/stem.cu``, one per conv dtype (the TPU kernel's static ``dtype``
argument), both on the tensor cores: bf16 (``KERNEL``) and fp32
(``KERNEL_F32``, crops up to ``MAX_CROP_F32``), whose conv1 splits each
fp32 operand into two TF32 parts and sums three products (3xTF32): not
bit-equal to fp32 FMA sums, but within 1e-5 of the largest output. Both
read the NHWC crops directly, so the port needs no
``prepare_stem_input``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..preprocess import upscale2x
from ._build import I, P, Kernel

_ARGS = [P, P, P, P, I, I, ctypes.c_float, ctypes.c_float, ctypes.c_float, P]
KERNEL = Kernel("mimamo_stem", _ARGS)              # bf16
KERNEL_F32 = Kernel("mimamo_stem_f32", _ARGS)      # fp32
MAX_CROP = 192          # the kernel's shared-memory strip grows with S
MAX_CROP_F32 = 128      # fp32 doubles the strip, the weights and the ring


def prepare_stem_weights(conv1_weight: torch.Tensor, conv1_bias: torch.Tensor,
                         channel_order: str, dtype: torch.dtype
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN-folded conv1 [64, 3, 7, 7] (OIHW) + [64] bias -> the kernel's
    [147, 64] weights in ``dtype`` (row 3*(7*ky + kx) + c) and [64] fp32
    bias. ``channel_order="bgr"`` folds the flip into the weights, so the
    kernel consumes RGB crops."""
    w = conv1_weight.to(torch.float32)
    if channel_order == "bgr":
        w = w.flip(1)
    w2 = w.permute(2, 3, 1, 0).reshape(147, 64).to(dtype).contiguous()
    return w2, conv1_bias.to(torch.float32).contiguous()


def stem_plain(crops: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor,
               mean_rgb: Sequence[float]) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points."""
    mean = torch.tensor(tuple(mean_rgb), dtype=torch.float32,
                        device=crops.device)
    u = upscale2x(crops.to(torch.float32) - mean)        # [N, 2S, 2S, 3]
    u = u.to(w2.dtype).to(torch.float32)                 # conv1's cast
    k = w2.to(torch.float32).reshape(7, 7, 3, 64).permute(3, 2, 0, 1)
    y = F.conv2d(u.permute(0, 3, 1, 2), k, bias, stride=2, padding=3)
    y = F.max_pool2d(F.relu(y), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(w2.dtype).contiguous()


def stem_fused(crops: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor,
               mean_rgb: Sequence[float]) -> torch.Tensor:
    """[N, S, S, 3] float32 RGB crops (0..255) -> [N, S/2, S/2, 64] stem
    features in ``w2.dtype`` (NHWC), for even S >= 8.

    ``w2``/``bias`` come from :func:`prepare_stem_weights`. A CUDA tensor
    goes through the kernel of ``w2.dtype`` (bf16, or fp32 for
    S <= ``MAX_CROP_F32``); a CPU tensor through :func:`stem_plain`.
    """
    if (crops.dim() != 4 or crops.shape[1] != crops.shape[2]
            or crops.shape[3] != 3 or crops.shape[1] % 2
            or not 8 <= crops.shape[1] <= MAX_CROP
            or crops.dtype != torch.float32):
        raise ValueError(f"crops must be [N, S, S, 3] float32 with even "
                         f"8 <= S <= {MAX_CROP}, got {tuple(crops.shape)} "
                         f"{crops.dtype}")
    if tuple(w2.shape) != (147, 64) or tuple(bias.shape) != (64,) \
            or bias.dtype != torch.float32:
        raise ValueError(f"expected [147, 64] weights and [64] float32 "
                         f"bias, got {tuple(w2.shape)}, {tuple(bias.shape)} "
                         f"{bias.dtype}")
    if not crops.device == w2.device == bias.device:
        raise ValueError("crops, weights and bias must share a device")
    if crops.device.type == "cpu":
        return stem_plain(crops, w2, bias, mean_rgb)
    kernel = {torch.bfloat16: KERNEL, torch.float32: KERNEL_F32}.get(
        w2.dtype)
    if crops.device.type != "cuda" or kernel is None:
        raise ValueError(f"the stem kernels take bf16 or fp32 weights on a "
                         f"CUDA device, got {w2.dtype} on {crops.device}")
    if kernel is KERNEL_F32 and crops.shape[1] > MAX_CROP_F32:
        raise ValueError(f"the fp32 stem kernel takes crops up to "
                         f"{MAX_CROP_F32}, got {crops.shape[1]}")
    if not (crops.is_contiguous() and w2.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("crops, weights and bias must be contiguous")
    if kernel is KERNEL_F32 and w2.data_ptr() % 16:
        raise ValueError("the fp32 stem kernel reads its weights in 16-byte "
                         "vectors: they must be 16-byte aligned")
    n, s = crops.shape[0], crops.shape[1]
    out = torch.empty((n, s // 2, s // 2, 64), dtype=w2.dtype,
                      device=crops.device)
    kernel(crops.data_ptr(), w2.data_ptr(), bias.data_ptr(), out.data_ptr(),
           n, s, *(float(m) for m in mean_rgb),
           torch.cuda.current_stream(crops.device).cuda_stream)
    return out
