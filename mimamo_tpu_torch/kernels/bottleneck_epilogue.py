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

In an SE-ResNet block (``BackboneSpec.se_reduction``; the block's ``se``
entry) a squeeze-and-excitation gate scales conv3's output before the
residual add: ``out = relu(u * g + r)`` with ``u = y + b3`` and ``g =
sigmoid(fc2(relu(fc1(mean_hw(u)))))`` per frame and channel. The gate
needs each frame's whole conv3 map before the first output, so on the card
it takes conv3's pass in two of its own (``csrc/bottleneck_epilogue.cu``):
:func:`se_squeeze` (the per-frame, per-channel means of ``y + b3``, summed
in fp32 in a fixed order), :func:`excite` (the two small fcs, PyTorch's
GEMMs) and :func:`se_scale` (``relu(u * g + r)`` in place), inside the
caller's ``gate_span``. Rounding points, in the kernels and their plain
versions alike: ``u`` rounded to the work dtype; the mean summed in fp32
over the rounded ``u`` and rounded; each fc's output rounded (its bias
inside); relu; the sigmoid rounded; ``u * g`` rounded; ``+ r`` rounded;
relu.

On the CPU :func:`bottleneck` is :func:`bottleneck_library` (the CPU convs
fold the bias in themselves), and :func:`epilogue`, :func:`se_squeeze` and
:func:`se_scale` run their plain versions.
"""

from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import LL, I, P, Kernel

KERNEL = Kernel("mimamo_bottleneck_epilogue", [P, P, P, P, LL, I, I, P])
SQUEEZE = Kernel("mimamo_se_squeeze", [P, P, P, I, I, I, I, P])
SCALE = Kernel("mimamo_se_scale", [P, P, P, P, P, I, I, I, I, P])
MAX_FRAMES = 65535  # the SE kernels' grid.y
MAX_C = 2048        # kMaxC of csrc/bottleneck_epilogue.cu: the biases' room
LANES = {torch.bfloat16: 8, torch.float32: 4}   # channels a 16-byte vector

# (OIHW channels_last weight, bias, stride, padding) of one conv, keyed by
# conv1, conv2, conv3 and, in block 0 of a stage, downsample; in an SE block
# also ``se``, its :data:`Gate`
Block = Dict[str, tuple]
# (fc1 weight [C/r, C], fc1 bias [C/r], fc2 weight [C, C/r], fc2 bias [C])
# of an SE gate, in the work dtype
Gate = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# device -> the context an SE block's gate runs in
GateSpan = Callable[[torch.device], ContextManager]


def _no_span(device: torch.device) -> ContextManager:
    return contextlib.nullcontext()


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` in fp32, rounded to ``a.dtype``."""
    return (a.to(torch.float32) + b.to(torch.float32)).to(a.dtype)


def _per_channel(b: torch.Tensor) -> torch.Tensor:
    return b.reshape(1, -1, 1, 1)


def _relu(x: torch.Tensor) -> torch.Tensor:
    """relu that keeps NaN (and, as ``torch.relu`` on the CPU, the sign of
    a zero)."""
    return torch.where(x < 0, x.new_zeros(()), x)


def epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                   res: Optional[torch.Tensor] = None,
                   res_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points:
    each add in fp32, rounded to ``y.dtype``; relu keeps NaN (and, as
    ``torch.relu`` on the CPU, the sign of a zero). Returns a new tensor."""
    out = _add(y, _per_channel(bias))
    if res is not None:
        if res_bias is not None:
            res = _add(res, _per_channel(res_bias))
        out = _add(out, res)
    return _relu(out)


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


def se_mean(u: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, C]: the mean over space summed in fp32 and
    rounded to ``u``'s dtype (as pool5 and ``jnp.mean``)."""
    return u.to(torch.float32).mean(dim=(2, 3)).to(u.dtype)


def se_squeeze_plain(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The squeeze kernel's function in plain PyTorch: :func:`se_mean` of
    ``y + bias`` rounded to ``y.dtype``. Sums in ``torch.mean``'s order,
    not the kernel's, so the two agree to fp32 round-off before the mean
    is rounded."""
    return se_mean(_add(y, _per_channel(bias)))


def excite(s: torch.Tensor, gate: Gate) -> torch.Tensor:
    """[N, C] squeezed means -> the gate [N, C] in ``s``'s dtype:
    ``sigmoid(fc2(relu(fc1(s))))``, each fc one ``F.linear`` with its bias
    (one rounding), the sigmoid rounded. Two small GEMMs, PyTorch's on
    either device."""
    w1, b1, w2, b2 = gate
    return torch.sigmoid(F.linear(F.relu(F.linear(s, w1, b1)), w2, b2))


def se_scale_plain(y: torch.Tensor, bias: torch.Tensor, gate: torch.Tensor,
                   res: torch.Tensor,
                   res_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scale kernel's function in plain PyTorch, with its rounding
    points: ``relu(rnd(rnd(rnd(y + bias) * gate) + r))``, ``r = rnd(res +
    res_bias)`` or ``res``. Returns a new tensor."""
    u = _add(y, _per_channel(bias))
    out = (u.to(torch.float32) * gate[:, :, None, None].to(torch.float32)
           ).to(y.dtype)
    if res_bias is not None:
        res = _add(res, _per_channel(res_bias))
    return _relu(_add(out, res))


def _check_se(y: torch.Tensor, bias: torch.Tensor,
              gate: Optional[torch.Tensor] = None,
              res: Optional[torch.Tensor] = None,
              res_bias: Optional[torch.Tensor] = None) -> None:
    _check(y, bias, res, res_bias)
    n, c = y.shape[:2]
    if n > MAX_FRAMES:
        raise ValueError(f"the SE kernels take up to {MAX_FRAMES} frames a "
                         f"call, got {n}")
    if gate is not None and (tuple(gate.shape) != (n, c)
                             or not gate.is_contiguous()
                             or gate.dtype != y.dtype
                             or gate.device != y.device):
        raise ValueError(f"gate must be a contiguous [{n}, {c}] tensor of "
                         f"y's dtype and device, got {tuple(gate.shape)} "
                         f"{gate.dtype}")


def _cuda_only(*tensors) -> None:
    if tensors[0].device.type != "cuda":
        raise ValueError(f"the SE kernels run on a CUDA device, got "
                         f"{tensors[0].device}")
    if any(t.data_ptr() % 16 for t in tensors if t is not None):
        raise ValueError("the SE kernels move 16-byte vectors: every "
                         "operand must be 16-byte aligned")


def se_squeeze(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The per-frame, per-channel means of ``y + bias`` ([N, C], a new
    tensor of ``y``'s dtype) of conv3's raw output ``y`` ([N, C, H, W]
    channels_last, as :func:`epilogue` takes it). A CUDA tensor goes
    through the squeeze kernel (one launch; a frame's sums in a fixed
    order, the same bits whatever batch it comes in), a CPU tensor through
    :func:`se_squeeze_plain`."""
    _check_se(y, bias)
    if y.device.type == "cpu":
        return se_squeeze_plain(y, bias)
    n, c, h, w = y.shape
    s = torch.empty((n, c), dtype=y.dtype, device=y.device)
    _cuda_only(y, bias, s)
    lanes = LANES[y.dtype]
    SQUEEZE(y.data_ptr(), bias.data_ptr(), s.data_ptr(), n, h * w,
            c // lanes, int(y.dtype == torch.bfloat16),
            torch.cuda.current_stream(y.device).cuda_stream)
    return s


def se_scale(y: torch.Tensor, bias: torch.Tensor, gate: torch.Tensor,
             res: torch.Tensor,
             res_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = relu((y + bias) * gate + (res + res_bias))`` (``res_bias``
    left out: 0), written into ``y`` and returned; ``gate`` [N, C] from
    :func:`excite`, the rest as :func:`epilogue` takes them. A CUDA tensor
    goes through the scale kernel (one launch), a CPU tensor through
    :func:`se_scale_plain`."""
    if res is None:
        raise ValueError("se_scale needs the residual res")
    _check_se(y, bias, gate, res, res_bias)
    if y.device.type == "cpu":
        return y.copy_(se_scale_plain(y, bias, gate, res, res_bias))
    _cuda_only(y, bias, gate, res, res_bias)
    n, c, h, w = y.shape
    lanes = LANES[y.dtype]
    SCALE(y.data_ptr(), bias.data_ptr(), gate.data_ptr(), res.data_ptr(),
          None if res_bias is None else res_bias.data_ptr(), n, h * w,
          c // lanes, int(y.dtype == torch.bfloat16),
          torch.cuda.current_stream(y.device).cuda_stream)
    return y


def _conv(x: torch.Tensor, p, bias: bool = True) -> torch.Tensor:
    w, b, stride, pad = p
    return F.conv2d(x, w, b if bias else None, stride=stride, padding=pad)


def bottleneck_library(x: torch.Tensor, blk: Block,
                       gate_span: GateSpan = _no_span) -> torch.Tensor:
    """One folded bottleneck as PyTorch's own ops: each conv with its bias
    through ``F.conv2d``, ``F.relu``, in an SE block the gate
    (:func:`se_mean`, :func:`excite`, the product) inside
    ``gate_span(x.device)``, the residual add. What
    :func:`bottleneck` computes on the CPU, and the yardstick of the
    probes and ``chip_smoke.py`` on the card."""
    res = _conv(x, blk["downsample"]) if "downsample" in blk else x
    y = F.relu(_conv(x, blk["conv1"]))
    y = F.relu(_conv(y, blk["conv2"]))
    y = _conv(y, blk["conv3"])
    if "se" in blk:
        with gate_span(x.device):
            y = y * excite(se_mean(y), blk["se"])[:, :, None, None]
    return F.relu(y + res)


def bottleneck_epilogues(x: torch.Tensor, blk: Block,
                         gate_span: GateSpan = _no_span) -> torch.Tensor:
    """One folded bottleneck as the card runs it: each conv without its
    bias, then :func:`epilogue` in place, three calls (the projection's
    bias inside conv3's); in an SE block conv3's call is the gate instead,
    :func:`se_squeeze`, :func:`excite` and :func:`se_scale`, inside
    ``gate_span(x.device)``. On the card,
    bit for bit :func:`bottleneck_library` without a gate; with one, the
    squeeze's sums in another order than ``torch.mean``'s."""
    y = epilogue(_conv(x, blk["conv1"], bias=False), blk["conv1"][1])
    y = epilogue(_conv(y, blk["conv2"], bias=False), blk["conv2"][1])
    y = _conv(y, blk["conv3"], bias=False)
    res, res_bias = ((_conv(x, blk["downsample"], bias=False),
                      blk["downsample"][1]) if "downsample" in blk
                     else (x, None))
    b3 = blk["conv3"][1]
    if "se" in blk:
        with gate_span(x.device):
            return se_scale(y, b3, excite(se_squeeze(y, b3), blk["se"]),
                            res, res_bias)
    return epilogue(y, b3, res, res_bias)


def bottleneck(x: torch.Tensor, blk: Block,
               gate_span: GateSpan = _no_span) -> torch.Tensor:
    """One folded bottleneck: :func:`bottleneck_epilogues` on the card,
    :func:`bottleneck_library` on the CPU."""
    if x.device.type == "cpu":
        return bottleneck_library(x, blk, gate_span)
    return bottleneck_epilogues(x, blk, gate_span)
