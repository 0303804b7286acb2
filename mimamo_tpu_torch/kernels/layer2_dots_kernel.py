"""The layer2 probe's dots-only block: CUDA kernel and its plain version.

Counterpart of ``layer2_fused_g4(dots_only=True)`` in
``bench/layer2_probe.py`` (body ``make_kernel_dots``): the g4 kernel's
five dots a block with no tap shift, pad or mask, 4 blocks at width 128 on
the padded 30 x 32 grid (P = 960 positions a frame).
``[N, 28, 2, 28, 512] -> [N, 28, 28, 512]`` bf16:

- block 0's state is the even-row plane, all 512 lanes, repeated to P
  positions;
- every block: ``y1 = relu(s . w1p[b] + b1[b])`` (block 0's conv1 padded to
  K = 512), conv2 as ``[y1, y1, y1]`` (K = 384) at row offsets -32, 0, +32,
  ``y3 = y2 . w3 + b3``, ``s = relu(y3 + s . wdp + bdp)``: block 0's
  projection in every block;
- the output is grid rows and columns 1..28.

One repair against the probe: y1 is zero outside the grid. The probe leaves
its conv2 halo unwritten, so its output rows 0-2 and 25-27 are undefined.
The rounding points are the probe's: fp32 sums, bf16 at y1, y2 and s. The
kernel is ``csrc/layer2_dots.cu`` (``csrc/dots_block.cuh``), one launch per
block; the production layer2 kernel is ``layer2_kernel``.

The dots execute 4.152 GFLOP a frame, 2.18x layer2's own 1.90 (the padded
grid, K = 512 in block 0, the projection in every block), so their time is
no floor of layer2. Of those, :func:`needed_work` counts what the output
needs (3.313 GFLOP): grid columns 0 and 29..31 never reach it, nor do the
products of the repeated plane positions that equal earlier ones.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import dots_block
from ._build import Kernel
from .dots_block import DotsBlock

KERNEL = Kernel("mimamo_layer2_dots_block", dots_block.ARGTYPES)
PLAN = "mimamo_layer2_dots_plan"   # C entry: the persistent grid
BLOCKS, C_IN, WIDTH, OUT_W = 4, 256, 128, 512
GRID_H, GRID_W = 30, 32          # padded 28 x 28 grid, row stride 32
P = GRID_H * GRID_W              # 960 positions a frame
CROP = (28, 28, 1, 1)            # output: grid rows and columns 1..28
PLANE = 28 * 28                  # block 0's positions, then repeated


def dot_flops_per_frame() -> float:
    """FLOPs the dot sequence executes a frame (4.152 GFLOP)."""
    per_block = (OUT_W * WIDTH + 3 * 3 * WIDTH * WIDTH + WIDTH * OUT_W
                 + OUT_W * OUT_W)
    return 2.0 * BLOCKS * P * per_block


def hbm_floor_bytes() -> int:
    """Bytes a frame the 4-launch chain must move: the 784 x 512 even-row
    plane, the [960, 512] state written and read three times, the 28 x 28 x
    512 output (7.50 MB; 0.86 ms at 384 frames at 3.35 TB/s)."""
    return dots_block.chain_bytes(PLANE * OUT_W, P * OUT_W, 28 * 28 * OUT_W,
                                  BLOCKS)


def needed_work() -> Tuple[float, np.ndarray]:
    """The dot FLOPs a frame the output needs, and the mask of the input
    pixels it reads, indexed ``56 row + column`` of the ``[28, 2, 28]``
    pixels (``dots_block.needed_work``)."""
    f = np.arange(P) % PLANE
    return dots_block.needed_work((f // 28) * 56 + f % 28, GRID_W, CROP,
                                  [(OUT_W, WIDTH, OUT_W, True)] * BLOCKS)


def pack_layer2_dots(weights: Sequence, device=None
                     ) -> Tuple[DotsBlock, ...]:
    """The probe's packing ``((wd [256, 512], bd), (w1a [256, 128], _), w1b
    [3, 512, 128], b1 [4, 1, 128], w2 [4, 3, 384, 128], b2, w3 [4, 128,
    512], b3)`` (arrays or tensors, ``[K, N]``) -> the four blocks as
    ``layer2_fused_g4`` pads them: block 0's conv1 and the projection take
    all 512 lanes (rows 256..511 zero), and every block applies block 0's
    projection."""
    (wd, bd), (w1a, _), w1b, b1, w2, b2, w3, b3 = weights
    wd, bd, w1a, w1b, b1, w2, b2, w3, b3 = map(
        torch.as_tensor, (wd, bd, w1a, w1b, b1, w2, b2, w3, b3))
    pad = OUT_W - C_IN

    def mat(w):
        return w.to(device=device, dtype=torch.bfloat16).contiguous()

    def vec(b):
        return b.to(device=device, dtype=torch.float32).reshape(-1).contiguous()

    w1p = torch.cat([F.pad(w1a, (0, 0, 0, pad))[None], w1b])
    wdp = mat(F.pad(wd, (0, 0, 0, pad)).T)
    return tuple(DotsBlock(
        w1=mat(w1p[b].T), w2=mat(w2[b].permute(2, 0, 1).reshape(WIDTH, -1)),
        w3=mat(w3[b].T), b1=vec(b1[b]), b2=vec(b2[b]), b3=vec(b3[b]),
        wd=wdp, bd=vec(bd)) for b in range(BLOCKS))


def _check(x: torch.Tensor, blocks: Tuple[DotsBlock, ...]) -> None:
    if x.dim() != 5 or tuple(x.shape[1:]) != (28, 2, 28, 2 * C_IN):
        raise ValueError(f"expected [N, 28, 2, 28, 512] input, got "
                         f"{tuple(x.shape)}")
    dots_block.check_blocks(blocks, x.device, (OUT_W,) * BLOCKS, WIDTH,
                            OUT_W)


def layer2_dots_plain(x: torch.Tensor, blocks: Tuple[DotsBlock, ...],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points
    (``dtype``: see ``dots_block.dots_block_plain``)."""
    plane = x[:, :, 0].reshape(x.shape[0], PLANE, OUT_W)
    s = torch.cat([plane, plane], dim=1)[:, :P]
    return dots_block.chain_plain(s, blocks, GRID_H, GRID_W, CROP, dtype)


def source_rows() -> Tuple[dots_block.RowMap, ...]:
    """Each block's row map: block 0 reads the even-row plane of the
    ``[N, 28, 2, 28, 512]`` input (rows of 28 pixels, 2 x 28 pixels apart),
    repeated after 784 positions; blocks 1-3 the stored ``[N, 960, 512]``
    state."""
    row = 28 * OUT_W
    return ((dots_block.RowMap(28 * 2 * row, PLANE, 28, 2 * row, OUT_W),)
            + (dots_block.contiguous_rows(P, OUT_W),) * (BLOCKS - 1))


def layer2_dots(x: torch.Tensor, blocks: Tuple[DotsBlock, ...]
                ) -> torch.Tensor:
    """``[N, 28, 2, 28, 512]`` bf16 -> ``[N, 28, 28, 512]`` bf16.

    ``blocks``: :func:`pack_layer2_dots` output. A CUDA tensor goes through
    the kernel (4 launches); a CPU tensor through :func:`layer2_dots_plain`.
    """
    _check(x, blocks)
    if x.device.type == "cpu":
        return layer2_dots_plain(x, blocks)
    return dots_block.run(KERNEL, x, blocks, source_rows(), GRID_W, P,
                          CROP)
