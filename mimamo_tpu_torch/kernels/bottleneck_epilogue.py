"""The epilogue of the backbone's cuDNN convs: CUDA kernel and its plain
version, and the folded bottleneck block that uses them.

A folded bottleneck (``backbone.FoldedResNet50``) is three convs, and a
projection conv in block 0 of a stage, each with a bias, then relu, and
after conv3 the residual add and relu. On the card cuDNN returns a conv
without its bias, and PyTorch then runs the bias add, the relu and the
residual add as separate elementwise passes over the conv's output.
``csrc/bottleneck_epilogue.cu`` does them in one pass a conv, in place:
``y = relu(y + b)`` after conv1 and conv2, ``y = relu((y + b) + r)``
after conv3, with ``r = d + bd`` (the projection's raw output and its
bias) in a block with a projection and the block's input otherwise. It
rounds as PyTorch's ops do, so :func:`bottleneck` on the card gives the
bits of :func:`bottleneck_library`, PyTorch's own chain.

On the CPU :func:`bottleneck` is :func:`bottleneck_library` (the CPU convs
fold the bias in themselves), and :func:`epilogue` runs its plain version,
:func:`epilogue_plain`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import LL, I, P, Kernel

KERNEL = Kernel("mimamo_bottleneck_epilogue", [P, P, P, P, LL, I, I, P])
MAX_C = 2048        # kMaxC of csrc/bottleneck_epilogue.cu: the biases' room
LANES = {torch.bfloat16: 8, torch.float32: 4}   # channels a 16-byte vector

# (OIHW channels_last weight, bias, stride, padding) of one conv, keyed by
# conv1, conv2, conv3 and, in block 0 of a stage, downsample
Block = Dict[str, Tuple[torch.Tensor, torch.Tensor, int, int]]


def epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                   res: Optional[torch.Tensor] = None,
                   res_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points:
    each add in fp32, rounded to ``y.dtype``; relu keeps NaN (and, as
    ``torch.relu`` on the CPU, the sign of a zero). Returns a new tensor."""
    f32, dt = torch.float32, y.dtype

    def add(a, b):
        return (a.to(f32) + b.to(f32)).to(dt)

    def per_channel(b):
        return b.reshape(1, -1, 1, 1)

    out = add(y, per_channel(bias))
    if res is not None:
        if res_bias is not None:
            res = add(res, per_channel(res_bias))
        out = add(out, res)
    return torch.where(out < 0, out.new_zeros(()), out)


def _check(y, bias, res, res_bias) -> None:
    if y.dtype not in LANES:
        raise ValueError(f"the epilogue takes bf16 or fp32, got {y.dtype}")
    if y.dim() != 4 or not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"y must be a channels_last contiguous [N, C, H, W] "
                         f"tensor, got {tuple(y.shape)} strides "
                         f"{y.stride()}")
    c = y.shape[1]
    if c % 8 or c > MAX_C:
        raise ValueError(f"the epilogue takes a multiple of 8 channels up "
                         f"to {MAX_C}, got {c}")
    if res_bias is not None and res is None:
        raise ValueError("res_bias needs res")
    for name, t in (("bias", bias), ("res_bias", res_bias)):
        if t is not None and (tuple(t.shape) != (c,)
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{c}] tensor, "
                             f"got {tuple(t.shape)}")
    if res is not None and (
            res.shape != y.shape
            or not res.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"res must be channels_last contiguous like y "
                         f"{tuple(y.shape)}, got {tuple(res.shape)} strides "
                         f"{res.stride()}")
    given = [t for t in (bias, res, res_bias) if t is not None]
    if any(t.dtype != y.dtype for t in given):
        raise ValueError(f"y, bias, res and res_bias must share a dtype, "
                         f"got {[t.dtype for t in (y, *given)]}")
    if any(t.device != y.device for t in given):
        raise ValueError("y, bias, res and res_bias must share a device")


def epilogue(y: torch.Tensor, bias: torch.Tensor,
             res: Optional[torch.Tensor] = None,
             res_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = relu(y + bias)``, or ``relu((y + bias) + (res + res_bias))``
    with ``res`` (``res_bias`` left out: 0), written into ``y`` and
    returned. ``y`` and ``res``: [N, C, H, W] channels_last contiguous,
    C a multiple of 8 up to 2048; biases [C]; one dtype, bf16 or fp32.

    A CUDA tensor goes through the kernel (one launch), a CPU tensor
    through :func:`epilogue_plain`."""
    _check(y, bias, res, res_bias)
    if y.device.type == "cpu":
        return y.copy_(epilogue_plain(y, bias, res, res_bias))
    if y.device.type != "cuda":
        raise ValueError(f"the epilogue kernel runs on a CUDA device, got "
                         f"{y.device}")
    given = [t for t in (y, bias, res, res_bias) if t is not None]
    if any(t.data_ptr() % 16 for t in given):
        raise ValueError("the epilogue kernel moves 16-byte vectors: y, the "
                         "biases and res must be 16-byte aligned")
    lanes = LANES[y.dtype]
    KERNEL(y.data_ptr(), bias.data_ptr(),
           None if res is None else res.data_ptr(),
           None if res_bias is None else res_bias.data_ptr(),
           y.numel() // lanes, y.shape[1] // lanes,
           int(y.dtype == torch.bfloat16),
           torch.cuda.current_stream(y.device).cuda_stream)
    return y


def _conv(x: torch.Tensor, p, bias: bool = True) -> torch.Tensor:
    w, b, stride, pad = p
    return F.conv2d(x, w, b if bias else None, stride=stride, padding=pad)


def bottleneck_library(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """One folded bottleneck as PyTorch's own ops: each conv with its bias
    through ``F.conv2d``, ``F.relu``, the residual add. What
    :func:`bottleneck` computes on the CPU, and the yardstick of the
    probes and ``chip_smoke.py`` on the card."""
    res = _conv(x, blk["downsample"]) if "downsample" in blk else x
    y = F.relu(_conv(x, blk["conv1"]))
    y = F.relu(_conv(y, blk["conv2"]))
    return F.relu(_conv(y, blk["conv3"]) + res)


def bottleneck_epilogues(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """One folded bottleneck as the card runs it: each conv without its
    bias, then :func:`epilogue` in place, three calls (the projection's
    bias inside conv3's). On the card, bit for bit
    :func:`bottleneck_library`."""
    y = epilogue(_conv(x, blk["conv1"], bias=False), blk["conv1"][1])
    y = epilogue(_conv(y, blk["conv2"], bias=False), blk["conv2"][1])
    y = _conv(y, blk["conv3"], bias=False)
    if "downsample" in blk:
        return epilogue(y, blk["conv3"][1],
                        _conv(x, blk["downsample"], bias=False),
                        blk["downsample"][1])
    return epilogue(y, blk["conv3"][1], x)


def bottleneck(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """One folded bottleneck: :func:`bottleneck_epilogues` on the card,
    :func:`bottleneck_library` on the CPU."""
    if x.device.type == "cpu":
        return bottleneck_library(x, blk)
    return bottleneck_epilogues(x, blk)
