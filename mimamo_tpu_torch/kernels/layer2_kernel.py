"""ResNet-50 layer2 (four BN-folded bottlenecks): CUDA kernel and its plain
version.

Counterpart of ``mimamo_tpu/pallas/layer2_kernel.py`` (``layer2_fused``,
``pack_layer2_params``): ``[N, 2H, 2W, 256] -> [N, H, W, 512]`` NHWC, with
the TPU kernel's rounding points. Block 0 strides its 1x1 conv1 and its
downsample projection by 2 (``stride_in_1x1``); every block is
1x1 -> 3x3 -> 1x1 with bias and relu, then relu(y3 + residual). y1 and y2
round to the activation dtype; the projection, the residual add and the
relu run in fp32; the residual stream is stored in the activation dtype.

The kernel is ``csrc/layer2.cu``: one launch per bottleneck block (4 per
call), each CTA computing conv1 -> conv2 -> conv3 (+ block 0's projection)
for 4 output rows and a tile of at most 30 output columns of a frame with
wgmma and TMA, y1 and y2 kept in shared memory. It takes any output size:
a frame wider than 30 columns is cut into column tiles.

Under the torchvision placement (``stride_in_1x1=False``: block 0 strides
its 3x3 conv2, not its 1x1 conv1) the kernel computes the stride-1 tail,
blocks 1-3, ``[N, H, W, 512] -> [N, H, W, 512]``: each of those blocks is
the same function in both placements, and the kernel takes its stride from
the block's input width (512: stride 1, the residual is the input). Block 0
of that placement is a function no TPU kernel computes (the Pallas kernel
takes only the 1x1 placement, ``mimamo_tpu/pallas/layer2_kernel.py``), so
the caller runs it as plain convs. The JAX package's ``_pallas_layer2_ok``
does not look at the placement and would run the 1x1 kernel on such a
backbone; the port routes by placement and never does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ._build import I, P, Kernel

KERNEL = Kernel("mimamo_layer2_block", [P] * 10 + [I, I, I, I, P])
BLOCKS, C_IN, WIDTH, OUT_W = 4, 256, 128, 512


@dataclasses.dataclass(frozen=True)
class Conv:
    """One folded conv: OHWI weights in the activation dtype, fp32 bias."""

    weight: torch.Tensor     # [Cout, KH, KW, Cin]
    bias: torch.Tensor       # [Cout] float32
    stride: int


Block = Dict[str, Conv]      # conv1, conv2, conv3 (+ downsample in block 0)


def pack_layer2_params(folded: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                       dtype: torch.dtype, stride_in_1x1: bool = True
                       ) -> Tuple[Block, ...]:
    """Folded backbone convs (``backbone.fold_batchnorm``: name ->
    (OIHW weight, bias)) -> the layer2 blocks the kernel computes, in its
    layout: all four under the 1x1 stride placement, the stride-1 tail
    (blocks 1-3) under the 3x3 one (module docstring)."""
    blocks = []
    for i in range(0 if stride_in_1x1 else 1, BLOCKS):
        blk = {}
        for name in ("conv1", "conv2", "conv3", "downsample"):
            key = f"layer2.{i}.{name}"
            if key not in folded:
                continue
            w, b = folded[key]
            stride = 2 if i == 0 and name in ("conv1", "downsample") else 1
            blk[name] = Conv(w.permute(0, 2, 3, 1).to(dtype).contiguous(),
                             b.to(torch.float32).contiguous(), stride)
        blocks.append(blk)
    return tuple(blocks)


def _check(x: torch.Tensor, blocks: Tuple[Block, ...]) -> None:
    first = BLOCKS - len(blocks)          # 0: all four; 1: the tail
    if first == 0 and (x.dim() != 4 or x.shape[3] != C_IN or x.shape[1] % 2
                       or x.shape[2] % 2 or x.shape[1] < 2
                       or x.shape[2] < 2):
        raise ValueError(f"expected [N, 2H, 2W, {C_IN}] input, got "
                         f"{tuple(x.shape)}")
    if first == 1 and (x.dim() != 4 or x.shape[3] != OUT_W
                       or x.shape[1] < 1 or x.shape[2] < 1):
        raise ValueError(f"expected [N, H, W, {OUT_W}] input to the "
                         f"stride-1 tail, got {tuple(x.shape)}")
    shapes = [
        {name: (tuple(c.weight.shape), c.stride) for name, c in blk.items()}
        for blk in blocks]
    want = [{"conv1": ((WIDTH, 1, 1, C_IN if i == 0 else OUT_W), 2 - (i > 0)),
             "conv2": ((WIDTH, 3, 3, WIDTH), 1),
             "conv3": ((OUT_W, 1, 1, WIDTH), 1)} for i in range(BLOCKS)]
    want[0]["downsample"] = ((OUT_W, 1, 1, C_IN), 2)
    if first not in (0, 1) or shapes != want[first:]:
        raise ValueError(f"layer2 params do not have the ResNet-50 layer2 "
                         f"shapes: {shapes}")
    for blk in blocks:
        for c in blk.values():
            if (c.weight.dtype != x.dtype or c.bias.dtype != torch.float32
                    or c.weight.device != x.device
                    or not c.weight.is_contiguous()
                    or not c.bias.is_contiguous()):
                raise ValueError(
                    f"weights must be contiguous {x.dtype} with float32 "
                    f"biases on {x.device}, got {c.weight.dtype}/"
                    f"{c.bias.dtype} on {c.weight.device}")


def _conv_plain(x: torch.Tensor, c: Conv) -> torch.Tensor:
    """NHWC conv + bias in fp32 on the (rounded) operand values."""
    w = c.weight.to(torch.float32).permute(0, 3, 1, 2)
    y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), w, c.bias,
                 stride=c.stride, padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def layer2_plain(x: torch.Tensor, blocks: Tuple[Block, ...]) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points."""
    dt = x.dtype
    for blk in blocks:
        res = (_conv_plain(x, blk["downsample"]) if "downsample" in blk
               else x.to(torch.float32))
        y1 = F.relu(_conv_plain(x, blk["conv1"])).to(dt)
        y2 = F.relu(_conv_plain(y1, blk["conv2"])).to(dt)
        x = F.relu(_conv_plain(y2, blk["conv3"]) + res).to(dt)
    return x.contiguous()


def layer2_fused(x: torch.Tensor, blocks: Tuple[Block, ...]) -> torch.Tensor:
    """[N, 2H, 2W, 256] layer1 output -> [N, H, W, 512] layer2 output, in
    ``x.dtype`` (NHWC); with the three tail blocks, [N, H, W, 512] block 0
    output -> [N, H, W, 512].

    ``blocks``: :func:`pack_layer2_params` output. A CUDA tensor goes
    through the kernel (bf16 only, one launch per block); a CPU tensor
    through :func:`layer2_plain`.
    """
    _check(x, blocks)
    if x.device.type == "cpu":
        return layer2_plain(x, blocks)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"the layer2 kernel takes bf16 on a CUDA device, "
                         f"got {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    stride = blocks[0]["conv1"].stride
    n, h, w = x.shape[0], x.shape[1] // stride, x.shape[2] // stride
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for blk in blocks:
        ds = blk.get("downsample")
        out = torch.empty((n, h, w, OUT_W), dtype=x.dtype, device=x.device)
        KERNEL(x.data_ptr(), blk["conv1"].weight.data_ptr(),
               blk["conv2"].weight.data_ptr(), blk["conv3"].weight.data_ptr(),
               None if ds is None else ds.weight.data_ptr(),
               blk["conv1"].bias.data_ptr(), blk["conv2"].bias.data_ptr(),
               blk["conv3"].bias.data_ptr(),
               None if ds is None else ds.bias.data_ptr(), out.data_ptr(),
               n, h, w, x.shape[3], stream)
        x = out
    return x
