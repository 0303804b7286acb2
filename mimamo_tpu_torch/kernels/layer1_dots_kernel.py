"""layer1_dots: the dot sequence of a fused ResNet-50 layer1, a floor probe.
CUDA kernel and its plain version.

Counterpart of ``layer1_dots`` in ``bench/layer1_probe.py`` (body
``make_kernel_dots``): 3 unrolled bottleneck blocks at width 64 on the
padded 58 x 64 grid (P = 3,712 positions a frame), with conv2's dx taps
packed into K = 192 and no tap shift or pad mask, so the output values are
well defined but mean nothing; a real fused layer1 of this shape executes
these dots and more. ``[N, 56, 56, 64] -> [N, 56, 56, 256]`` bf16:

- the input is repeated to P rows, ``x64 = [x; x[:576]]``;
- block 0: ``y1 = relu(x64 . w1a + b1[0])``, residual ``x64 . wd`` (no
  bias); blocks 1-2: ``y1 = relu(x . w1b[b-1] + b1[b])``, residual ``x``;
- conv2: ``[y1, y1, y1]`` (K = 192, zero outside the grid) at row offsets
  -64, 0, +64 against ``w2[b, dy]``; ``y2 = relu(acc + b2)``;
- ``x = relu(y2 . w3 + b3 + residual)``; the output is grid rows 1..56,
  columns 0..55.

fp32 accumulation, bf16 at y1, y2 and x. The kernel is ``csrc/layer1_dots.cu``
(``csrc/dots_block.cuh``), one launch per block.

Grid columns 56..63 never reach the output (conv2 shifts by grid rows
only), nor do the products of the repeated input rows that equal earlier
ones: :func:`needed_work` counts what the output needs (1.212 GFLOP a
frame), :func:`dot_flops_per_frame` what the probe executes (1.581).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import dots_block
from ._build import Kernel
from .dots_block import DotsBlock

KERNEL = Kernel("mimamo_layer1_dots_block", dots_block.ARGTYPES)
GRID_H, GRID_W = 58, 64          # padded 56 x 56 grid, row stride 64
P = GRID_H * GRID_W              # 3,712 positions a frame
WIDTH, OUT_W, C_IN = 64, 256, 64
BLOCKS = 3
IN_HW = 56
CROP = (IN_HW, IN_HW, 1, 0)      # output: grid rows 1..56, columns 0..55
ANALYTIC_GFLOP_PER_FRAME = 513.0 / 384   # the true 56 x 56 layer1


def dot_flops_per_frame() -> float:
    """FLOPs the dot sequence executes a frame (1.581 GFLOP; the padded
    grid carries an 18% row overcount against the analytic 1.336)."""
    fl = 2.0 * P * C_IN * WIDTH                      # block 0 conv1
    fl += 2.0 * P * C_IN * OUT_W                     # block 0 projection
    fl += 2.0 * (BLOCKS - 1) * P * OUT_W * WIDTH     # blocks 1-2 conv1
    fl += 2.0 * BLOCKS * 3 * P * (3 * WIDTH) * WIDTH  # conv2, 3 dots K = 192
    fl += 2.0 * BLOCKS * P * WIDTH * OUT_W           # conv3
    return fl


def needed_work() -> Tuple[float, np.ndarray]:
    """The dot FLOPs a frame the output needs, and the mask of the 3,136
    input pixels it reads (``dots_block.needed_work``)."""
    dims = [(C_IN if b == 0 else OUT_W, WIDTH, OUT_W, b == 0)
            for b in range(BLOCKS)]
    return dots_block.needed_work(np.arange(P) % (IN_HW * IN_HW), GRID_W,
                                  CROP, dims)


def pack_layer1_dots(weights: Sequence, device=None) -> Tuple[DotsBlock, ...]:
    """The probe's weights ``(wd [64, 256], w1a [64, 64], w1b [2, 256, 64],
    w2 [3, 3, 192, 64], w3 [3, 64, 256], b1 [3, 1, 64], b2 [3, 1, 64],
    b3 [3, 1, 256])`` (arrays or tensors, bf16 values) -> the three blocks in
    the kernel's layout on ``device``."""
    wd, w1a, w1b, w2, w3, b1, b2, b3 = (torch.as_tensor(w) for w in weights)

    def mat(w):
        return w.to(device=device, dtype=torch.bfloat16).contiguous()

    def vec(b):
        return b.to(device=device, dtype=torch.bfloat16).to(
            torch.float32).reshape(-1).contiguous()

    blocks = []
    for b in range(BLOCKS):
        w1 = w1a if b == 0 else w1b[b - 1]
        blocks.append(DotsBlock(
            w1=mat(w1.T), w2=mat(w2[b].permute(2, 0, 1).reshape(WIDTH, -1)),
            w3=mat(w3[b].T), b1=vec(b1[b]), b2=vec(b2[b]), b3=vec(b3[b]),
            wd=mat(wd.T) if b == 0 else None))
    return tuple(blocks)


def _check(x: torch.Tensor, blocks: Tuple[DotsBlock, ...]) -> None:
    if x.dim() != 4 or tuple(x.shape[1:]) != (IN_HW, IN_HW, C_IN):
        raise ValueError(f"expected [N, {IN_HW}, {IN_HW}, {C_IN}] input, "
                         f"got {tuple(x.shape)}")
    dots_block.check_blocks(blocks, x.device, (C_IN,) + (OUT_W,) * 2,
                            WIDTH, OUT_W)


def layer1_dots_plain(x: torch.Tensor, blocks: Tuple[DotsBlock, ...],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points
    (``dtype``: see ``dots_block.dots_block_plain``)."""
    flat = x.reshape(x.shape[0], IN_HW * IN_HW, C_IN)
    s = torch.cat([flat, flat[:, :P - IN_HW * IN_HW]], dim=1)
    return dots_block.chain_plain(s, blocks, GRID_H, GRID_W, CROP, dtype)


def source_rows() -> Tuple[dots_block.RowMap, ...]:
    """Each block's row map: block 0 reads the ``[N, 56, 56, 64]`` input,
    repeated after its 3,136 pixels; blocks 1-2 the stored ``[N, P, 256]``
    state."""
    pixels = IN_HW * IN_HW
    return ((dots_block.RowMap(pixels * C_IN, pixels, pixels, 0, C_IN),)
            + (dots_block.contiguous_rows(P, OUT_W),) * (BLOCKS - 1))


def layer1_dots(x: torch.Tensor, blocks: Tuple[DotsBlock, ...]
                ) -> torch.Tensor:
    """``[N, 56, 56, 64]`` bf16 -> ``[N, 56, 56, 256]`` bf16 (NHWC).

    ``blocks``: :func:`pack_layer1_dots` output. A CUDA tensor goes through
    the kernel (3 launches); a CPU tensor through :func:`layer1_dots_plain`.
    """
    _check(x, blocks)
    if x.device.type == "cpu":
        return layer1_dots_plain(x, blocks)
    return dots_block.run(KERNEL, x, blocks, source_rows(), P, CROP)
