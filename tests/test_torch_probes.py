"""The port's probes (``mimamo_tpu_torch/bench``) and their kernels' plain
versions against the JAX probes (``bench/layer1_probe.py``,
``bench/layer2_probe.py``, loaded by file path, Pallas in interpret mode),
on the same seeded inputs and weights at N = 2. The CUDA kernels are held
against these plain versions on the card by chip_smoke.py.

Tolerances are max |d| / max |ref|, measured here and kept well under the
probes' own 2e-2: the port rounds at the probes' points (fp32 sums, bf16
at y1, y2 and the block outputs), so what differs is fp32 summation order
and the bf16 rounding it flips."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mimamo_tpu_torch.bench import layer1_probe, layer2_probe
from mimamo_tpu_torch.kernels import dots_block
from mimamo_tpu_torch.kernels import layer1_dots_kernel as l1
from mimamo_tpu_torch.kernels import layer2_dots_kernel as l2d

REPO = Path(__file__).resolve().parent.parent
N = 2


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "bench" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _max_rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(rng, shape, scale):
    return layer2_probe._bf16(rng.normal(0, scale, shape).astype(np.float32))


def _jax(a):
    return None if a is None else jnp.asarray(a, jnp.bfloat16)


# -- layer1_dots -------------------------------------------------------------

@pytest.fixture(scope="module")
def layer1_case():
    """Seeded bf16 weights N(0, 0.05) and inputs N(0, 1) (numpy float32
    holding bf16 values), and the JAX probe's interpret-mode output."""
    rng = np.random.default_rng(5)
    w = tuple(_bf16(rng, s, 0.05) for s in (
        (64, 256), (64, 64), (2, 256, 64), (3, 3, 192, 64), (3, 64, 256),
        (3, 1, 64), (3, 1, 64), (3, 1, 256)))
    x = _bf16(rng, (N, 56, 56, 64), 1.0)
    probe = _load("layer1_probe")
    want = np.asarray(probe.layer1_dots(
        jax, jnp, pl, pltpu, _jax(x), tuple(_jax(a) for a in w),
        interpret=True), np.float32)
    return w, x, want


def test_layer1_dots_matches_jax_probe(layer1_case):
    """Measured 3.2e-3 (max |d| 7.8e-3 at outputs up to 2.5)."""
    w, x, want = layer1_case
    got = l1.layer1_dots(torch.from_numpy(x).to(torch.bfloat16),
                         l1.pack_layer1_dots(w))
    assert tuple(got.shape) == want.shape == (N, 56, 56, 256)
    assert got.dtype == torch.bfloat16
    assert _max_rel(got.float(), want) < 8e-3


def _layer1_dots_numpy(x, w):
    """The probe's dot sequence written out in numpy float64, with bf16
    rounding at y1, y2 and x, independent of the port's code."""
    wd, w1a, w1b, w2, w3, b1, b2, b3 = (a.astype(np.float64) for a in w)
    r = lambda a: torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16).to(torch.float64).numpy()
    flat = x.reshape(56 * 56, 64).astype(np.float64)
    s = np.concatenate([flat, flat[:3712 - 3136]])
    for b in range(3):
        if b == 0:
            y1 = r(np.maximum(s @ w1a + b1[b], 0))
            res = s @ wd
        else:
            y1 = r(np.maximum(s @ w1b[b - 1] + b1[b], 0))
            res = s
        a = np.zeros((3712 + 128, 192))
        a[64:64 + 3712] = np.concatenate([y1] * 3, axis=1)
        acc = sum(a[64 * dy:64 * dy + 3712] @ w2[b, dy] for dy in range(3))
        y2 = r(np.maximum(acc + b2[b], 0))
        s = r(np.maximum(y2 @ w3[b] + b3[b] + res, 0))
    return s.reshape(58, 64, 256)[1:57, :56]


def test_layer1_dots_plain_matches_numpy():
    """N = 1 against a float64 numpy version: only the fp32 sums of the
    plain version differ (measured 3.7e-3, max |d| 7.8e-3: bf16 flips
    at y1, y2 and x)."""
    rng = np.random.default_rng(6)
    w = tuple(_bf16(rng, s, 0.05) for s in (
        (64, 256), (64, 64), (2, 256, 64), (3, 3, 192, 64), (3, 64, 256),
        (3, 1, 64), (3, 1, 64), (3, 1, 256)))
    x = _bf16(rng, (1, 56, 56, 64), 1.0)
    got = l1.layer1_dots_plain(torch.from_numpy(x).to(torch.bfloat16),
                               l1.pack_layer1_dots(w))
    assert _max_rel(got[0].float(), _layer1_dots_numpy(x[0], w)) < 8e-3


# -- layer2: the three full variants and the dots-only kernel ----------------

@pytest.fixture(scope="module")
def layer2_case():
    """The port probe's seeded weights (drawn as the JAX probe draws them)
    and inputs, with the JAX probe module."""
    raw, packed = layer2_probe.probe_weights(0)
    x = _bf16(np.random.default_rng(7), (N, 28, 2, 28, 512), 1.0)
    jw = tuple(tuple(_jax(a) for a in p) if isinstance(p, tuple) else _jax(p)
               for p in packed)
    # the probe keeps its biases in fp32
    (wd, bd), (w1a, _), w1b, b1, w2, b2, w3, b3 = jw
    f32 = lambda a: a.astype(jnp.float32)
    jw = ((wd, f32(bd)), (w1a, None), w1b, f32(b1), w2, f32(b2), w3, f32(b3))
    return packed, x, jw, _load("layer2_probe")


@pytest.mark.parametrize("variant", ["layer2_fused", "layer2_fused_batched",
                                     "layer2_fused_g4"])
def test_layer2_variants_match_jax_probe(layer2_case, variant):
    """The port's layer2 kernel (plain on the CPU) through
    ``blocks_from_probe_weights`` against each probe variant (batched at
    2 frames a step). Measured 6.4e-3 for all three (max |d| 0.031)."""
    packed, x, jw, probe = layer2_case
    kw = {"frames": 2} if variant == "layer2_fused_batched" else {}
    want = np.asarray(getattr(probe, variant)(
        jax, jnp, pl, pltpu, _jax(x), jw, interpret=True, **kw), np.float32)
    w = layer2_probe.prepare(packed, "cpu")
    got = getattr(layer2_probe, variant)(
        torch.from_numpy(x).to(torch.bfloat16), w, **kw)
    assert tuple(got.shape) == want.shape == (N, 28, 28, 512)
    assert _max_rel(got.float(), want) < 1e-2


def test_layer2_dots_matches_jax_probe(layer2_case):
    """The port's dots-only layer2 against ``layer2_fused_g4(dots_only=
    True)`` on output rows 3-24: the JAX probe never writes its conv2
    halo, and interpret mode fills it with NaN, which the dy taps carry
    to rows 0-2 and 25-27. The port zeroes the halo: its output is finite
    in all 28 rows. Measured 6.1e-3 (max |d| 7.8e-3)."""
    packed, x, jw, probe = layer2_case
    want = np.asarray(probe.layer2_fused_g4(
        jax, jnp, pl, pltpu, _jax(x), jw, interpret=True, dots_only=True),
        np.float32)
    got = layer2_probe.layer2_fused_g4(
        torch.from_numpy(x).to(torch.bfloat16),
        layer2_probe.prepare(packed, "cpu"), dots_only=True).float()
    assert tuple(got.shape) == want.shape == (N, 28, 28, 512)
    assert torch.isfinite(got).all()
    assert np.isfinite(want[:, 3:25]).all()
    assert _max_rel(got[:, 3:25], want[:, 3:25]) < 1e-2


# -- what surrounds the kernels: row maps, weight layouts, work counts -------

def gather_rows(src, rows, positions):
    """The ``[N, positions, cin]`` block input the kernel reads from ``src``
    through the row map ``rows`` (csrc/dots_block.cuh), in plain
    indexing."""
    n = src.shape[0]
    f = torch.arange(positions) % rows.wrap
    off = (f // rows.seg) * rows.seg_stride + (f % rows.seg) * rows.cin
    idx = (torch.arange(n)[:, None, None] * rows.frame + off[None, :, None]
           + torch.arange(rows.cin)[None, None, :])
    return src.reshape(-1)[idx]


def test_row_maps_give_the_plain_inputs():
    """The row maps the wrappers hand the kernel read exactly the inputs
    the plain versions build: layer1's [x; x[:576]], the layer2 probe's
    even-row plane repeated to 960 positions, and the stored states."""
    x = torch.randn((2, 56, 56, 64)).to(torch.bfloat16)
    flat = x.reshape(2, 3136, 64)
    rows = l1.source_rows()
    assert torch.equal(gather_rows(x, rows[0], l1.P),
                       torch.cat([flat, flat[:, :576]], dim=1))
    x5 = torch.randn((2, 28, 2, 28, 512)).to(torch.bfloat16)
    plane = x5[:, :, 0].reshape(2, 784, 512)
    rows2 = l2d.source_rows()
    assert torch.equal(gather_rows(x5, rows2[0], l2d.P),
                       torch.cat([plane, plane], dim=1)[:, :960])
    for rows_b, p, c in ((rows[1], l1.P, 256), (rows2[1], l2d.P, 512)):
        state = torch.randn((3, p, c))
        assert torch.equal(gather_rows(state, rows_b, p), state)


def test_probe_weight_layouts():
    """``blocks_from_probe_weights``: row 128 dx + c_in of w2[b, dy]
    becomes OHWI [c_out, dy, dx, c_in], the 1x1s transpose; the dots
    blocks pad block 0's conv1 and the projection to 512 lanes and apply
    the projection in every block."""
    _raw, packed = layer2_probe.probe_weights(0)
    blocks = layer2_probe.blocks_from_probe_weights(packed,
                                                    dtype=torch.float32)
    w2 = packed[4]
    for b, dy, dx, ci, co in ((0, 0, 0, 0, 0), (1, 2, 1, 5, 77),
                              (3, 1, 2, 127, 3)):
        assert blocks[b]["conv2"].weight[co, dy, dx, ci] == w2[b, dy,
                                                               128 * dx + ci,
                                                               co]
    assert blocks[0]["conv1"].stride == blocks[0]["downsample"].stride == 2
    assert torch.equal(blocks[0]["downsample"].weight[:, 0, 0],
                       torch.from_numpy(packed[0][0]).T)
    dots = l2d.pack_layer2_dots(packed)
    assert not dots[0].w1[:, 256:].any() and dots[0].w1[:, :256].any()
    assert all(blk.wd is dots[0].wd for blk in dots)
    assert not dots[0].wd[:, 256:].any()
    l1_blocks = l1.pack_layer1_dots(layer1_probe.dots_weights())
    assert [blk.wd is not None for blk in l1_blocks] == [True, False, False]
    assert [tuple(blk.w1.shape) for blk in l1_blocks] == [(64, 64),
                                                          (64, 256),
                                                          (64, 256)]


def test_executed_work():
    """The work the kernels execute, as the probes count it."""
    assert l1.dot_flops_per_frame() == pytest.approx(1.581e9, rel=1e-3)
    assert l2d.dot_flops_per_frame() == pytest.approx(4.152e9, rel=1e-3)
    assert l2d.dot_flops_per_frame() / 1.90e9 == pytest.approx(2.185,
                                                                rel=1e-3)
    for k, n in layer1_probe.GEMM_SHAPES:
        m = layer1_probe.gemm_rows(k, n)
        assert m % 256 == 0 and m > 0


def _live_grid_flops(grid_h, cols, dims):
    """The dot FLOPs a frame on a grid whose input rows are all distinct:
    ``cols`` live grid columns; every block but the last on all ``grid_h``
    rows, the last on the ``grid_h - 2`` output rows; conv1 on all rows;
    conv2 skips the two rows whose dy neighbour is the halo, except in the
    last block, whose neighbours all lie in the grid."""
    fl = 0.0
    for b, (cin, w, out, proj) in enumerate(dims):
        last = b == len(dims) - 1
        r = grid_h - 2 if last else grid_h
        fl += 2.0 * r * cols * (w * out + (cin * out if proj else 0))
        fl += 2.0 * (3 * r - (0 if last else 2)) * cols * 3 * w * w
        fl += 2.0 * grid_h * cols * cin * w
    return fl


def _dots_case(mod):
    """(blocks, input shape, plain version) of a dots module."""
    if mod is l1:
        return (l1.pack_layer1_dots(layer1_probe.dots_weights()),
                (1, 56, 56, 64), l1.layer1_dots_plain)
    return (l2d.pack_layer2_dots(layer2_probe.probe_weights(0)[1]),
            (1, 28, 2, 28, 512), l2d.layer2_dots_plain)


@pytest.mark.parametrize("mod", [l1, l2d], ids=["layer1", "layer2"])
def test_needed_work_without_repeats_is_the_live_grid(mod):
    """``dots_block.needed_work`` on distinct input rows counts the live
    columns and rows by hand; the repeated rows only take work away."""
    dims = [(blk.w1.shape[1], blk.w1.shape[0], blk.w3.shape[0],
             blk.wd is not None) for blk in _dots_case(mod)[0]]
    distinct, rows = dots_block.needed_work(np.arange(mod.P), mod.GRID_W,
                                            mod.CROP, dims)
    assert distinct == _live_grid_flops(mod.GRID_H, mod.CROP[1], dims)
    assert rows.sum() == mod.GRID_H * mod.CROP[1]
    needed = mod.needed_work()[0]
    assert needed < distinct < mod.dot_flops_per_frame()


@pytest.mark.parametrize("mod", [l1, l2d], ids=["layer1", "layer2"])
def test_unneeded_input_pixels_do_not_reach_the_output(mod):
    """The input pixels ``needed_work`` leaves out can change freely
    without moving the plain output by a bit; the ones it keeps move it."""
    blocks, shape, plain = _dots_case(mod)
    gen = torch.Generator().manual_seed(8)
    pixels = torch.randn(shape, generator=gen).to(torch.bfloat16).reshape(
        -1, shape[-1])
    noise = torch.randn(pixels.shape, generator=gen).to(torch.bfloat16)
    keep = torch.from_numpy(mod.needed_work()[1])
    keep = F.pad(keep, (0, pixels.shape[0] - len(keep)))[:, None]
    run = lambda p: plain(p.reshape(shape), blocks)
    base = run(pixels)
    assert torch.equal(run(torch.where(keep, pixels, noise)), base)
    assert not torch.equal(run(torch.where(keep, noise, pixels)), base)


def test_dots_wrappers_reject_bad_input():
    blocks = l1.pack_layer1_dots(layer1_probe.dots_weights())
    with pytest.raises(ValueError):
        l1.layer1_dots(torch.zeros((1, 56, 56, 32), dtype=torch.bfloat16),
                       blocks)
    with pytest.raises(ValueError):          # blocks out of order
        l1.layer1_dots(torch.zeros((1, 56, 56, 64), dtype=torch.bfloat16),
                       blocks[::-1])
    dots = l2d.pack_layer2_dots(layer2_probe.probe_weights(0)[1])
    with pytest.raises(ValueError):
        l2d.layer2_dots(torch.zeros((1, 56, 56, 256), dtype=torch.bfloat16),
                       dots)
    with pytest.raises(ValueError):          # weights on another device
        l2d.layer2_dots(torch.zeros((1, 28, 2, 28, 512), device="meta",
                                   dtype=torch.bfloat16), dots)


# -- the kernels' persistent grid and box table (csrc/dots_block.cuh) -------

def _cta_tiles(tiles, ctas):
    """The tiles each CTA of the persistent grid computes, in order: the
    kernel's loop ``for (tile = blockIdx.x; tile < tiles; tile +=
    gridDim.x)``."""
    return [list(range(k, tiles, ctas)) for k in range(ctas)]


def _windows(mod):
    """Each window of a tile the box table plans: (first position relative
    to the tile, positions), conv1's rows then the projection's."""
    t, g = dots_block.TILE_M, mod.GRID_W
    return ((-g, t + 2 * g), (0, t))


def _table_boxes(table, box, rows, t, w):
    """The boxes of window w of tile t in the kernel's table: (first row in
    the window, rows, row in segment, segment) of every entry of kind 1 or
    2, as the producer issues them."""
    return [(b * box, box if kind == 1 else rows.seg, c1, c2)
            for b, (c1, c2, kind, _) in enumerate(table[t, w].tolist())
            if kind]


@pytest.mark.parametrize("n", [1, 3, 5, 384])
@pytest.mark.parametrize("mod", [l1, l2d], ids=["layer1", "layer2"])
def test_dots_schedule_covers_every_tile_once(mod, n):
    """The persistent grid at N frames, with the CTAs that a card of 132 SMs
    holds (one an SM) and with 2: every output tile is computed by exactly
    one CTA, every CTA has a tile and no CTA has two more than another; the
    box table of every block plans each tile of a frame."""
    per_frame = -(-mod.P // dots_block.TILE_M)
    tiles = n * per_frame
    for fits in (132, 2):
        plan = _cta_tiles(tiles, min(tiles, fits))
        done = [t for cta in plan for t in cta]
        assert sorted(done) == list(range(tiles))
        counts = [len(cta) for cta in plan]
        assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    for rows in mod.source_rows():
        table = dots_block.box_table(rows, mod.GRID_W, mod.P)
        assert table.shape == (per_frame, 2, dots_block.MAX_BOXES, 4)


@pytest.mark.parametrize("mod", [l1, l2d], ids=["layer1", "layer2"])
def test_dots_box_plan_covers_each_window_row_once(mod):
    """The box table the kernel reads (``dots_block.box_table``), for every
    conv1 and projection window of a frame: each window row once, each box
    inside one segment of the map, no entry past the window's boxes; the
    layer2 plane (28-pixel segments) in whole segments and 4-row pieces, at
    most 18 boxes for the frame's rows of a 192-row window where 4-row boxes
    alone took 48."""
    for rows in mod.source_rows()[:2]:
        box = dots_block.box_rows(rows, mod.GRID_W, mod.P)
        pieces = dots_block.segment_boxes(rows, box, mod.P)
        table = dots_block.box_table(rows, mod.GRID_W, mod.P)
        for t in range(table.shape[0]):
            for w, (df, count) in enumerate(_windows(mod)):
                f = t * dots_block.TILE_M + df
                plan = _table_boxes(table, box, rows, t, w)
                covered = sorted(q + i for q, n, _, _ in plan
                                 for i in range(n))
                assert covered == list(range(count))
                assert not table[t, w, count // box:].any()
                for q, n, c1, c2 in plan:
                    assert n in ((box, rows.seg) if pieces else (box,))
                    if rows.wrap < mod.P and c1 >= 0:
                        assert c1 + n <= rows.seg
                if pieces and w == 0:
                    assert sum(0 <= f + q < mod.P
                               for q, _, _, _ in plan) <= 18


def _read_window(src, rows, table, box, positions, n, t, w, count):
    """Window w of tile t of frame n of a block's input, ``[count, cin]``,
    read as the kernel's TMA boxes of the table read it from the 4-D map
    ``[N, segments, seg, cin]``: rows outside the map zero."""
    flat = src.reshape(-1)
    wrapped = rows.wrap < positions
    seg_len = rows.seg if wrapped else positions
    segs = rows.wrap // rows.seg if wrapped else 1
    seg_stride = rows.seg_stride if segs > 1 else rows.seg * rows.cin
    out = torch.zeros((count, rows.cin), dtype=src.dtype)
    for q, n_rows, c1, c2 in _table_boxes(table, box, rows, t, w):
        for i in range(n_rows):
            if 0 <= c1 + i < seg_len and c2 < segs:
                at = n * rows.frame + c2 * seg_stride + (c1 + i) * rows.cin
                out[q + i] = flat[at:at + rows.cin]
    return out


def _block_by_tiles(src, rows, blk, grid_w, positions, ctas, dtype):
    """One block computed as the kernel computes it: tile by tile in the
    persistent grid's order, each tile from the source rows that the box
    table's boxes read (y1 on the tile and one grid row either side, zero
    outside the frame). Same arithmetic as ``dots_block_plain``; ``[N, P,
    OUT]`` bf16, NaN where no tile wrote."""
    n_frames, tile_m = src.shape[0], dots_block.TILE_M
    per_frame = -(-positions // tile_m)
    box = dots_block.box_rows(rows, grid_w, positions)
    table = dots_block.box_table(rows, grid_w, positions)
    width, out_w = blk.w1.shape[0], blk.w3.shape[0]
    cast = lambda t: t.to(dtype)
    w2 = cast(blk.w2).reshape(width, 3, 3 * width)
    out = torch.full((n_frames, positions, out_w), float("nan"),
                     dtype=src.dtype)
    rows1 = tile_m + 2 * grid_w
    for cta in _cta_tiles(n_frames * per_frame, ctas):
        for tile in cta:
            n, t = divmod(tile, per_frame)
            tile0 = t * tile_m
            f = np.arange(tile0 - grid_w, tile0 - grid_w + rows1)
            v = cast(_read_window(src, rows, table, box, positions, n, t, 0,
                                  rows1))
            y1 = F.relu(v @ cast(blk.w1).T + cast(blk.b1)).to(src.dtype)
            y1[torch.from_numpy((f < 0) | (f >= positions))] = 0
            a = torch.cat([y1] * 3, dim=1)
            acc = sum(cast(a[dy * grid_w:dy * grid_w + tile_m]) @ w2[:, dy].T
                      for dy in range(3))
            y2 = F.relu(acc + cast(blk.b2)).to(src.dtype)
            x = cast(_read_window(src, rows, table, box, positions, n, t, 1,
                                  tile_m))
            res = x
            if blk.wd is not None:
                res = x @ cast(blk.wd).T
                if blk.bd is not None:
                    res = res + cast(blk.bd)
            y3 = cast(y2) @ cast(blk.w3).T + cast(blk.b3)
            keep = min(tile_m, positions - tile0)
            assert torch.isnan(out[n, tile0:tile0 + keep].float()).all()
            out[n, tile0:tile0 + keep] = F.relu(y3 + res).to(
                src.dtype)[:keep]
    return out


def _plan_cases():
    l1_blocks = l1.pack_layer1_dots(layer1_probe.dots_weights())
    l2_blocks = l2d.pack_layer2_dots(layer2_probe.probe_weights(0)[1])
    gen = torch.Generator().manual_seed(11)
    x1 = torch.randn((2, 56, 56, 64), generator=gen).to(torch.bfloat16)
    state1 = torch.randn((2, l1.P, 256), generator=gen).to(torch.bfloat16)
    x2 = torch.randn((1, 28, 2, 28, 512), generator=gen).to(torch.bfloat16)
    return {
        "layer1-block0": (l1, x1, l1.source_rows()[0], l1_blocks[0]),
        "layer1-block1": (l1, state1, l1.source_rows()[1], l1_blocks[1]),
        "layer2-block0": (l2d, x2, l2d.source_rows()[0], l2_blocks[0]),
    }


@pytest.mark.parametrize("case", ["layer1-block0", "layer1-block1",
                                  "layer2-block0"])
def test_dots_plan_emulation_is_the_plain_block(case):
    """A block computed as the kernel computes it (tile by tile in the
    persistent order of 3 CTAs, sources read box by box from the box table
    the kernel is given, y1 zero outside the frame) gives
    ``dots_block_plain``'s output bit for bit: the wrapped layer1 input
    with the projection, a stored state with the identity residual, the
    layer2 plane (4-row boxes and whole segments) with the projection.
    Both in float64: a float32 product on the CPU rounds differently on 128
    rows than on a frame's, which moved 19 of 491,520 layer2 outputs by a
    bf16 ulp."""
    mod, src, rows, blk = _plan_cases()[case]
    want = dots_block.dots_block_plain(gather_rows(src, rows, mod.P), blk,
                                       mod.GRID_W, torch.float64)
    got = _block_by_tiles(src, rows, blk, mod.GRID_W, mod.P, 3,
                          torch.float64)
    assert dots_block.box_rows(rows, mod.GRID_W, mod.P) == (
        {l1: 64, l2d: 4}[mod] if rows.wrap < mod.P else {l1: 64, l2d: 32}[mod])
    assert torch.equal(got, want)


# -- the entry points -------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["mimamo_tpu_torch.bench.layer1_probe", "--cpu", "--batch-frames", "2"],
    ["mimamo_tpu_torch.bench.layer2_probe", "--cpu", "--check-only"]])
def test_probe_entry_points_on_cpu(argv):
    out = subprocess.run([sys.executable, "-m", *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines and all('"card": "cpu' in line for line in lines)


@pytest.mark.parametrize("probe", [layer1_probe, layer2_probe])
def test_probes_without_card_raise(monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        probe.main([])
