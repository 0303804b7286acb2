"""One block of the floor probes' dot sequence (``csrc/dots_block.cuh``):
its weights in the kernel's layout, its plain version and its launch.

``layer1_dots_kernel`` and ``layer2_dots_kernel`` chain these blocks
(:func:`run`, :func:`chain_plain`). A frame's state is P grid positions (a padded grid of row stride G,
flattened) x cin channels, bf16. Per block, with fp32 accumulation and the
probes' rounding points::

    y1  = relu(s . W1 + b1)                   bf16, 0 outside [0, P)
    acc = sum_dy [y1, y1, y1][f + G (dy - 1)] . W2[dy]    (K = 3 W)
    y2  = relu(acc + b2)                      bf16
    out = relu(y2 . W3 + b3 + res)            bf16

where ``res`` is the projection ``s . Wd (+ bd)`` or the identity ``s``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ._build import LL, I, P, Kernel, library

# the C entry points' arguments: src, w1, w2, w3, wd, b1, b2, b3, bd, out,
# the box table; N, cin, wrap, seg, box rows; seg_stride, frame_stride; the
# crop; the stream
ARGTYPES = [P] * 11 + [I] * 5 + [LL] * 2 + [I] * 4 + [P]
TILE_M = 128          # output positions a CTA's tile (the kernel's kM)
MAX_BOXES = 64        # box table entries a window (the kernel's lanes x 2)


@dataclasses.dataclass(frozen=True)
class DotsBlock:
    """One block's weights, K-major bf16 (``[N_out, K]``), fp32 biases."""

    w1: torch.Tensor                    # [W, cin]
    w2: torch.Tensor                    # [W, 9 W]: K = (3 dy + dx block) W + c
    w3: torch.Tensor                    # [OUT, W]
    b1: torch.Tensor                    # [W]
    b2: torch.Tensor                    # [W]
    b3: torch.Tensor                    # [OUT]
    wd: Optional[torch.Tensor] = None   # [OUT, cin]: projection residual
    bd: Optional[torch.Tensor] = None   # [OUT]


@dataclasses.dataclass(frozen=True)
class RowMap:
    """Where the kernel reads position f of frame n of a block's input (in
    elements of the source tensor)::

        n * frame + ((f % wrap) // seg) * seg_stride + ((f % wrap) % seg) * cin
    """

    frame: int
    wrap: int
    seg: int
    seg_stride: int
    cin: int


def contiguous_rows(positions: int, cin: int) -> RowMap:
    """A contiguous ``[N, positions, cin]`` source."""
    return RowMap(positions * cin, positions, positions, 0, cin)


def dots_block_plain(s: torch.Tensor, blk: DotsBlock, grid_w: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One block in plain PyTorch: ``s`` [N, P, cin] bf16 -> [N, P, OUT]
    bf16. The products run in ``dtype`` on the bf16 operands: float32 is
    the plain version, rounding where the kernel rounds; bfloat16 is the
    same sequence as library (cuBLAS) calls, rounding every result."""
    n, p, _ = s.shape
    width = blk.w1.shape[0]
    cast = lambda t: t.to(dtype)
    v = cast(s)
    y1 = F.relu(v @ cast(blk.w1).T + cast(blk.b1)).to(s.dtype)
    res = v
    if blk.wd is not None:
        res = v @ cast(blk.wd).T
        if blk.bd is not None:
            res = res + cast(blk.bd)
    a = F.pad(torch.cat([y1] * 3, dim=2), (0, 0, grid_w, grid_w))
    w2 = cast(blk.w2).reshape(width, 3, 3 * width)
    acc = sum(cast(a[:, dy * grid_w:dy * grid_w + p]) @ w2[:, dy].T
              for dy in range(3))
    y2 = F.relu(acc + cast(blk.b2)).to(s.dtype)
    y3 = cast(y2) @ cast(blk.w3).T + cast(blk.b3)
    return F.relu(y3 + res).to(s.dtype)


def chain_plain(s: torch.Tensor, blocks: Sequence[DotsBlock], grid_h: int,
                grid_w: int, crop: Tuple[int, int, int, int],
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``blocks`` in plain PyTorch on the ``[N, grid_h * grid_w, cin]``
    state ``s``, then the ``crop`` (rows, columns, first grid row, first
    grid column) of the last block's grid."""
    for blk in blocks:
        s = dots_block_plain(s, blk, grid_w, dtype)
    rows, cols, r0, c0 = crop
    return s.reshape(s.shape[0], grid_h, grid_w, s.shape[-1])[
        :, r0:r0 + rows, c0:c0 + cols].contiguous()


def check_blocks(blocks: Tuple[DotsBlock, ...], device: torch.device,
                 cins: Tuple[int, ...], width: int, out_w: int) -> None:
    """Raise unless ``blocks`` have the probe's shapes (block b reads
    ``cins[b]`` channels), types and device."""
    if len(blocks) != len(cins):
        raise ValueError(f"expected {len(cins)} blocks, got {len(blocks)}")
    for b, (blk, cin) in enumerate(zip(blocks, cins)):
        want = {"w1": (width, cin), "w2": (width, 9 * width),
                "w3": (out_w, width), "b1": (width,), "b2": (width,),
                "b3": (out_w,)}
        if blk.wd is not None:
            want["wd"] = (out_w, cin)
        if blk.bd is not None:
            want["bd"] = (out_w,)
        for name, shape in want.items():
            t = getattr(blk, name)
            dtype = torch.float32 if name.startswith("b") else torch.bfloat16
            if (tuple(t.shape) != shape or t.dtype != dtype
                    or t.device != device or not t.is_contiguous()):
                raise ValueError(
                    f"block {b} {name}: want contiguous {dtype} {shape} on "
                    f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if blk.wd is None and (cin != out_w or blk.bd is not None):
            raise ValueError(f"block {b}: an identity residual needs "
                             f"cin == {out_w} and no projection bias")


def launch(kernel: Kernel, src: torch.Tensor, rows: RowMap, blk: DotsBlock,
           out: torch.Tensor, grid_w: int, positions: int,
           crop: Tuple[int, int, int, int] = (0, 0, 0, 0)) -> None:
    """One launch of ``kernel`` on the current stream: ``src`` read through
    ``rows`` by the boxes of :func:`box_table`, ``out`` the whole ``[N, P,
    OUT]`` state or, with ``crop`` = (rows, columns, first grid row, first
    grid column), that crop."""
    table = _table_on(src.device, rows, grid_w, positions)
    kernel(src.data_ptr(), blk.w1.data_ptr(), blk.w2.data_ptr(),
           blk.w3.data_ptr(), None if blk.wd is None else blk.wd.data_ptr(),
           blk.b1.data_ptr(), blk.b2.data_ptr(), blk.b3.data_ptr(),
           None if blk.bd is None else blk.bd.data_ptr(), out.data_ptr(),
           table.data_ptr(), src.shape[0], rows.cin, rows.wrap, rows.seg,
           box_rows(rows, grid_w, positions), rows.seg_stride, rows.frame,
           *crop, torch.cuda.current_stream(src.device).cuda_stream)


def run(kernel: Kernel, x: torch.Tensor, blocks: Sequence[DotsBlock],
        rows: Sequence[RowMap], grid_w: int, positions: int,
        crop: Tuple[int, int, int, int]) -> torch.Tensor:
    """``blocks`` through ``kernel``, one launch each: block 0 reads ``x``
    (bf16, contiguous, on a CUDA device) through ``rows[0]``, every block
    but the last writes the whole ``[N, positions, OUT]`` state, the last
    the ``crop``, ``[N, rows, columns, OUT]``."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"the dots kernels take bf16 on a CUDA device, got "
                         f"{x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n, out_w = x.shape[0], blocks[-1].w3.shape[0]
    src = x
    for b, (blk, r) in enumerate(zip(blocks, rows)):
        last = b == len(blocks) - 1
        out = torch.empty((n, *crop[:2], out_w) if last
                          else (n, positions, out_w),
                          dtype=x.dtype, device=x.device)
        launch(kernel, src, r, blk, out, grid_w, positions,
               crop if last else (0, 0, 0, 0))
        src = out
    return src


def chain_bytes(first_in: int, state: int, last_out: int,
                blocks: int) -> int:
    """Bytes a frame that a chain of ``blocks`` launches must move through
    device memory, bf16: block 0 reads its ``first_in`` input elements once,
    every launch but the last writes the ``state`` elements the next one
    reads, the last writes ``last_out``. The floor of any one-launch-a-
    block design (weights left out: read once, they are a few MB)."""
    return 2 * (first_in + 2 * (blocks - 1) * state + last_out)


def needed_work(source: np.ndarray, grid_w: int,
                crop: Tuple[int, int, int, int],
                dims: Sequence[Tuple[int, int, int, bool]]
                ) -> Tuple[float, np.ndarray]:
    """The dot FLOPs a frame that the output needs, and which input rows.

    ``source[f]``: the input row that position f of block 0 reads;
    ``dims``: (cin, W, OUT, projection) per block. A product counts where
    its position reaches the ``crop`` (conv2 moves along grid rows only, so
    a grid column feeds only itself, and each block widens the rows by
    one), not where conv2's operand is the zero halo, and once per distinct
    value: positions whose inputs are equal (the repeated input rows) give
    equal products. Elementwise work is not counted."""
    p = len(source)
    rows, cols, r0, c0 = crop
    live = np.zeros((p // grid_w, grid_w), bool)
    live[r0:r0 + rows, c0:c0 + cols] = True
    live = live.reshape(-1)
    halo = np.full(grid_w, -1)

    def shift(a, dy):     # a[f + grid_w dy]; -1 (the halo) outside the grid
        return np.r_[halo, a[:-grid_w]] if dy < 0 else np.r_[a[grid_w:], halo]

    def number(*keys):    # one id per distinct tuple of keys
        return np.unique(np.stack(keys, 1), axis=0,
                         return_inverse=True)[1].reshape(-1)

    def distinct(ids, mask):
        return len(np.unique(ids[mask]))

    # value ids of each block's input and of its y2, forward
    ids, y2s = [number(np.asarray(source))], []
    for _ in dims:
        s = ids[-1]
        y2s.append(number(shift(s, -1), s, shift(s, 1)))
        ids.append(number(y2s[-1], s))
    # the products the live positions need, backward
    flops = 0.0
    for (cin, width, out, proj), s, y2 in zip(dims[::-1], ids[-2::-1],
                                              y2s[::-1]):
        flops += 2.0 * distinct(y2, live) * width * out            # conv3
        if proj:
            flops += 2.0 * distinct(s, live) * cin * out
        for tap in (shift(s, -1), s, shift(s, 1)):                  # conv2
            flops += 2.0 * distinct(tap, live & (tap >= 0)) * 3 * width ** 2
        grown = live.copy()         # y1 rows conv2 reads: one grid row out
        grown[grid_w:] |= live[:-grid_w]
        grown[:-grid_w] |= live[grid_w:]
        live = grown
        flops += 2.0 * distinct(s, live) * cin * width              # conv1
    rows_needed = np.zeros(int(np.max(source)) + 1, bool)
    rows_needed[np.asarray(source)[live]] = True
    return flops, rows_needed


# -- the kernel's source boxes, planned on the host ---------------------------


def box_rows(rows: RowMap, grid_w: int, positions: int) -> int:
    """Source rows a TMA box: the largest power of two up to 64 that
    divides ``grid_w`` and, for a wrapped source, wrap, seg and the grid's
    positions, so that no box crosses a segment, the wrap or the grid's end
    (the kernel's ``launch`` refuses any other)."""
    wrapped = rows.wrap < positions
    box = 64
    while grid_w % box or (wrapped and (rows.wrap % box or rows.seg % box
                                        or positions % box)):
        box //= 2
    return box


def segment_boxes(rows: RowMap, box: int, positions: int) -> bool:
    """Whether the kernel reads this source's whole segments as one box
    each (a wrapped source with segments of at most 256 rows, longer than
    ``box``: the layer2 plane's 28-pixel rows)."""
    return rows.wrap < positions and rows.seg <= 256 and rows.seg > box


@functools.lru_cache(maxsize=None)
def box_table(rows: RowMap, grid_w: int, positions: int) -> np.ndarray:
    """The box table the kernel reads (``Params::boxes`` in
    ``csrc/dots_block.cuh``): int32 ``[tiles, 2, 64, 4]``, for each tile of
    a frame and each of its windows (0: conv1's rows ``[tile0 - grid_w,
    tile0 + 128 + grid_w)``, 1: the projection's ``[tile0, tile0 + 128)``),
    entry b the box whose rows start at window row ``b * box``: (row in
    segment, segment, kind, 0), kind 0 none, 1 a box of ``box`` rows, 2 a
    whole segment.

    An unwrapped source takes a box as it falls (TMA zero-fills rows
    outside ``[0, P)``); a wrapped one is all zeros outside ``[0, P)`` (row
    ``-box``), and where :func:`segment_boxes` holds, a segment that lies
    whole in the window and the frame comes as one box from its first
    row's entry."""
    box = box_rows(rows, grid_w, positions)
    wrapped = rows.wrap < positions
    whole = segment_boxes(rows, box, positions)
    tiles = -(-positions // TILE_M)
    table = np.zeros((tiles, 2, MAX_BOXES, 4), np.int32)
    for t in range(tiles):
        tile0 = t * TILE_M
        windows = ((tile0 - grid_w, TILE_M + 2 * grid_w), (tile0, TILE_M))
        for w, (f, count) in enumerate(windows):
            if count // box > MAX_BOXES:
                raise ValueError(f"{count // box} boxes of {box} rows in a "
                                 f"window: the kernel takes {MAX_BOXES}")
            for b in range(count // box):
                fb = f + b * box
                c1, c2, kind = fb, 0, 1
                if wrapped:
                    inside = 0 <= fb < positions
                    c1 = fb % rows.wrap % rows.seg if inside else -box
                    c2 = fb % rows.wrap // rows.seg if inside else 0
                    s0 = fb - c1              # the segment's first row
                    if (whole and inside and s0 >= f
                            and s0 + rows.seg <= min(f + count, positions)):
                        kind = 0 if c1 else 2
                table[t, w, b] = (c1, c2, kind, 0) if kind else 0
    table.flags.writeable = False
    return table


_tables: dict = {}     # (rows, grid_w, positions, device) -> the table there


def _table_on(device: torch.device, rows: RowMap, grid_w: int,
              positions: int) -> torch.Tensor:
    """:func:`box_table` on ``device``, uploaded once."""
    key = (rows, grid_w, positions, device)
    table = _tables.get(key)
    if table is None:
        table = torch.from_numpy(box_table(rows, grid_w, positions).copy())
        table = _tables[key] = table.to(device)
    return table


def launch_plan(symbol: str, n: int) -> int:
    """CTAs of the persistent grid that a launch on n frames takes on the
    current card: the C entry ``symbol`` (``mimamo_layer1_dots_plan``,
    ``mimamo_layer2_dots_plan``)."""
    fn = getattr(library(), symbol)
    fn.argtypes = [I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    ctas = ctypes.c_int()
    err = fn(n, ctypes.byref(ctas))
    if err:
        raise RuntimeError(f"{symbol}: CUDA error {err}")
    return ctas.value
