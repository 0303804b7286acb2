"""Layer2 probe: the fused-layer2 variants and their dot sequence alone.

Port of ``bench/layer2_probe.py``. Its three full variants (``layer2_fused``,
one frame a grid step; ``layer2_fused_batched``, frames batched a step;
``layer2_fused_g4``, one block a step) are one function on the TPU grid,
ResNet-50 layer2 (4 BN-folded bottlenecks, ``[N, 28, 2, 28, 512]`` ->
``[N, 28, 28, 512]`` bf16): here all three run the port's layer2 kernel
(``kernels/layer2_kernel.layer2_fused``), its weights converted from the
probe's packing by :func:`blocks_from_probe_weights`. With ``dots_only``,
``layer2_fused_g4`` is the dots-only kernel
(``kernels/layer2_dots_kernel.py``): the g4 kernel's five dots a block with
no shifts, pads or masks, whose executed work (4.152 GFLOP a frame) is
2.18x layer2's, so its time is no floor of layer2.

Numeric check (the probe's own): each variant against the library chain
(cuDNN bf16 bottlenecks) on seeded inputs, max |d| / max |ref| < 2e-2; it
raises when one fails. Timing at ``--batch`` frames: the library layer2 and
the port's layer2 kernel, once, since every variant runs it; with
``--dots-only`` also the dots kernel, with its bound at the work its
output needs.

    python -m mimamo_tpu_torch.bench.layer2_probe [--batch 384] [--dots-only]
        [--variant both|unrolled|g4] [--frames 2 4 8] [--check-only]
    python -m mimamo_tpu_torch.bench.layer2_probe --cpu --check-only

``--cpu`` runs the check through the plain versions and times nothing.
Without it the probe needs a card and raises without one. Every line
carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Sequence, Tuple

import numpy as np
import torch

from mimamo_tpu_torch.bench._timing import (PEAK_BF16_FLOP_PER_S, card,
                                            device, max_rel, time_ms)
from mimamo_tpu_torch.kernels.bottleneck_epilogue import bottleneck_library
from mimamo_tpu_torch.kernels import layer2_dots_kernel as l2d
from mimamo_tpu_torch.kernels import layer2_kernel as l2
from mimamo_tpu_torch.kernels.dots_block import DotsBlock
from mimamo_tpu_torch.kernels.layer2_kernel import (BLOCKS, C_IN, OUT_W,
                                                    WIDTH, Conv)

LAYER2_GFLOP_384 = 730.0          # layer2 at 384 frames of 28^2 outputs
CHECK_REL_TOL = 2e-2              # the probe's gate, max |d| / max |ref|


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (round to nearest even)."""
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


def probe_weights(seed: int = 0):
    """The probe's seeded weights, drawn in its order: ``(raw, packed)``.
    ``raw``: per block ``{"conv1", "conv2", "conv3"(, "down")}: (HWIO
    weight, bias)``, N(0, 0.05) in bf16 values (float32 arrays); ``packed``:
    its kernel packing ``((wd, bd), (w1a, None), w1b, b1, w2, b2, w3,
    b3)``."""
    rng = np.random.default_rng(seed)

    def mk(shape, scale=0.05):
        return _bf16(rng.normal(0, scale, shape).astype(np.float32))

    raw, c = [], C_IN
    for b in range(BLOCKS):
        p = {"conv1": (mk((1, 1, c, WIDTH)), mk((WIDTH,))),
             "conv2": (mk((3, 3, WIDTH, WIDTH)), mk((WIDTH,))),
             "conv3": (mk((1, 1, WIDTH, OUT_W)), mk((OUT_W,)))}
        if b == 0:
            p["down"] = (mk((1, 1, c, OUT_W)), mk((OUT_W,)))
        raw.append(p)
        c = OUT_W
    stack = lambda f: np.stack([f(raw[b]) for b in range(BLOCKS)])
    packed = (
        (raw[0]["down"][0].reshape(C_IN, OUT_W),
         raw[0]["down"][1].reshape(1, OUT_W)),
        (raw[0]["conv1"][0].reshape(C_IN, WIDTH), None),
        np.stack([raw[b]["conv1"][0].reshape(OUT_W, WIDTH)
                  for b in range(1, BLOCKS)]),
        stack(lambda p: p["conv1"][1].reshape(1, WIDTH)),
        # w2[b, dy]: rows 128 dx + c_in, the probe's lane blocks
        stack(lambda p: p["conv2"][0].reshape(3, 3 * WIDTH, WIDTH)),
        stack(lambda p: p["conv2"][1].reshape(1, WIDTH)),
        stack(lambda p: p["conv3"][0].reshape(WIDTH, OUT_W)),
        stack(lambda p: p["conv3"][1].reshape(1, OUT_W)))
    return raw, packed


@dataclasses.dataclass(frozen=True)
class ProbeWeights:
    """The probe's packing converted once, for the variants (``blocks``)
    and for the dots-only kernel (``dots``)."""

    blocks: Tuple[l2.Block, ...]
    dots: Tuple[DotsBlock, ...]


def blocks_from_probe_weights(weights: Sequence, dtype=torch.bfloat16,
                              device=None) -> Tuple[l2.Block, ...]:
    """The probe's packing ``((wd [256, 512], bd), (w1a [256, 128], _), w1b
    [3, 512, 128], b1 [4, 1, 128], w2 [4, 3, 384, 128], b2, w3 [4, 128,
    512], b3)`` (arrays or tensors, ``[K, N]``) -> the
    ``layer2_kernel.pack_layer2_params`` blocks. Row ``128 dx + c_in`` of
    ``w2[b, dy]`` becomes OHWI ``[:, dy, dx, c_in]``."""
    (wd, bd), (w1a, _), w1b, b1, w2, b2, w3, b3 = weights
    t = lambda a: torch.as_tensor(a).to(device)

    def conv(w, b, stride):
        return Conv(w.to(dtype).contiguous(),
                    t(b).to(torch.float32).reshape(-1).contiguous(), stride)

    blocks = []
    for i in range(BLOCKS):
        w1 = t(w1a) if i == 0 else t(w1b)[i - 1]
        blk = {"conv1": conv(w1.T[:, None, None], b1[i], 2 if i == 0 else 1),
               "conv2": conv(t(w2)[i].reshape(3, 3, WIDTH, WIDTH)
                             .permute(3, 0, 1, 2), b2[i], 1),
               "conv3": conv(t(w3)[i].T[:, None, None], b3[i], 1)}
        if i == 0:
            blk["downsample"] = conv(t(wd).T[:, None, None], bd, 2)
        blocks.append(blk)
    return tuple(blocks)


def prepare(packed, dev) -> ProbeWeights:
    return ProbeWeights(blocks_from_probe_weights(packed, device=dev),
                        l2d.pack_layer2_dots(packed, dev))


def library_blocks(raw, dev) -> list:
    """The raw weights as ``FoldedResNet50`` bottlenecks (OIHW
    channels_last bf16, bf16 bias, stride, padding)."""
    names = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
             "down": "downsample"}
    blocks = []
    for b, p in enumerate(raw):
        blk = {}
        for name, (w, bias) in p.items():
            k = torch.from_numpy(w).permute(3, 2, 0, 1).to(
                device=dev, dtype=torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            stride = 2 if b == 0 and name in ("conv1", "down") else 1
            blk[names[name]] = (k, torch.from_numpy(bias).to(
                device=dev, dtype=torch.bfloat16), stride, w.shape[0] // 2)
        blocks.append(blk)
    return blocks


def library_layer2(x: torch.Tensor, blocks: list) -> torch.Tensor:
    """``[N, 56, 56, 256]`` NHWC -> NCHW view of ``[N, 28, 28, 512]``,
    through the backbone's bottlenecks as PyTorch's own ops (cuDNN convs
    with their biases, relu, residual add)."""
    v = x.permute(0, 3, 1, 2)
    for blk in blocks:
        v = bottleneck_library(v, blk)
    return v


def layer2_fused(x: torch.Tensor, w: ProbeWeights) -> torch.Tensor:
    """``[N, 28, 2, 28, 512]`` bf16 (the reshaped layer1 output) ->
    ``[N, 28, 28, 512]``: the port's layer2 kernel."""
    return l2.layer2_fused(x.reshape(x.shape[0], 56, 56, C_IN), w.blocks)


def layer2_fused_batched(x: torch.Tensor, w: ProbeWeights, frames: int = 4
                         ) -> torch.Tensor:
    """The frames-batched variant: the same function (the TPU grid's
    grouping of frames has no counterpart in the port's kernel)."""
    if x.shape[0] % frames:
        raise ValueError(f"{x.shape[0]} frames are no multiple of {frames}")
    return layer2_fused(x, w)


def layer2_fused_g4(x: torch.Tensor, w: ProbeWeights, dots_only: bool = False
                    ) -> torch.Tensor:
    """The one-block-a-step variant; with ``dots_only`` its dot sequence
    alone, through the dots-only kernel."""
    if dots_only:
        return l2d.layer2_dots(x, w.dots)
    return layer2_fused(x, w)


def variants(which: str = "both", frames=()) -> dict:
    """The probe's variants by name, as ``(x, weights) -> out``."""
    fns = {}
    if which in ("both", "unrolled"):
        fns["unrolled"] = layer2_fused
    if which in ("both", "g4"):
        fns["g4"] = layer2_fused_g4
    for f in frames:
        fns[f"batched_f{f}"] = (
            lambda x, w, _f=f: layer2_fused_batched(x, w, frames=_f))
    return fns


def inputs(n: int, seed: int, dev) -> torch.Tensor:
    """``[n, 56, 56, 256]`` bf16 N(0, 1) on ``dev``, from a seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, 56, 56, C_IN), generator=gen, device=dev).to(
        torch.bfloat16)


def check(fns: dict, w: ProbeWeights, lib: list, n: int, dev) -> dict:
    """Each variant against the library chain on ``n`` seeded frames;
    raises when max-rel reaches CHECK_REL_TOL. Returns the errors."""
    xs = inputs(n, 1, dev)
    with torch.no_grad():
        ref = library_layer2(xs, lib).permute(0, 2, 3, 1)
        errs = {name: max_rel(fn(xs.reshape(n, 28, 2, 28, 2 * C_IN), w), ref)
                for name, fn in fns.items()}
    if not all(e < CHECK_REL_TOL for e in errs.values()):
        raise AssertionError(f"layer2 variants against the library chain: "
                             f"{errs} (gate {CHECK_REL_TOL})")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=384)
    ap.add_argument("--iters", type=int, default=5,
                    help="timed batches of back-to-back calls")
    ap.add_argument("--cpu", action="store_true",
                    help="check through the plain versions (times nothing)")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--variant", choices=("both", "unrolled", "g4"),
                    default="both")
    ap.add_argument("--frames", type=int, nargs="*", default=[],
                    help="also run the frames-batched variant at these "
                         "frames-per-step counts")
    ap.add_argument("--dots-only", action="store_true",
                    help="also check and time the dots-only kernel")
    args = ap.parse_args(argv)
    dev = device(args.cpu)
    label = "cpu (plain versions, not timed)" if args.cpu else card()

    def emit(row):
        print(json.dumps(dict(row, card=label)), flush=True)

    raw, packed = probe_weights(0)
    w = prepare(packed, dev)
    lib = library_blocks(raw, dev)
    fns = variants(args.variant, args.frames)
    nchk = max([2] + list(args.frames))
    for name, err in check(fns, w, lib, nchk, dev).items():
        emit({"check": f"{name}_vs_library", "frames": nchk, "max_rel": err,
              "tol": CHECK_REL_TOL})
    if args.dots_only:
        x = inputs(nchk, 1, dev).reshape(nchk, 28, 2, 28, 2 * C_IN)
        with torch.no_grad():
            got = layer2_fused_g4(x, w, dots_only=True)
            want = l2d.layer2_dots_plain(x, w.dots)
        err = max_rel(got, want)
        finite = bool(torch.isfinite(got.float()).all())
        emit({"check": "g4_dots_vs_plain", "frames": nchk, "max_rel": err,
              "finite": finite, "tol": CHECK_REL_TOL})
        if not (err < CHECK_REL_TOL and finite):
            raise AssertionError(f"layer2 dots kernel: max-rel {err}, "
                                 f"finite {finite}")
    if args.check_only or args.cpu:
        return 0

    n = args.batch
    x = inputs(n, 2, dev)
    x5 = x.reshape(n, 28, 2, 28, 2 * C_IN)
    # every variant is the port's one layer2 kernel: timed once
    rows = [("library", lambda: library_layer2(x, lib)),
            ("fused (" + ", ".join(fns) + ")",
             lambda: layer2_fused(x5, w))]
    gflop = LAYER2_GFLOP_384 * n / 384
    with torch.no_grad():
        for name, fn in rows:
            ms = time_ms(fn, iters=args.iters)
            emit({"layer2": name, "frames": n, "ms": ms,
                  "tflops": gflop / ms})
        if args.dots_only:
            ms = time_ms(lambda: layer2_fused_g4(x5, w, dots_only=True),
                         iters=args.iters)
            executed = l2d.dot_flops_per_frame() * n
            needed = l2d.needed_work()[0] * n
            bound = needed / PEAK_BF16_FLOP_PER_S * 1e3
            emit({"layer2": "g4_dots_only", "frames": n, "ms": ms,
                  "tflops_executed": executed / ms / 1e9,
                  "executed_gflop_per_frame": executed / n / 1e9,
                  "needed_gflop_per_frame": needed / n / 1e9,
                  "bound_ms": bound, "bound_by": "operations",
                  "share_of_bound": bound / ms,
                  "executed_over_layer2": executed / (gflop * 1e9)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
