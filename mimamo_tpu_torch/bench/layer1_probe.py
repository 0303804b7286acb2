"""Layer1 floor probe: how fast could a fused layer1 be on this card?

Port of ``bench/layer1_probe.py``. cuDNN's layer1 is the largest stage of
the port's clip steps. Three measurements:

  1. **The library layer1 stage**: three BN-folded bottlenecks of
     ``bottleneck_epilogue.bottleneck_library`` (cuDNN bf16, channels_last,
     PyTorch's bias add, relu and residual add) on seeded weights,
     reported at the analytic 513 GFLOP per 384 frames.
  2. **The layer1_dots kernel** (``kernels/layer1_dots_kernel.py``): the dot
     sequence of a fused layer1 with no tap shifts or masks, a lower bound
     on any real kernel of that shape, with its executed, needed and
     analytic GFLOP a frame and its bound (the needed work at 989
     TFLOP/s).
  3. **The narrow-GEMM ceiling**: ``torch.matmul`` in bf16 at the dots'
     (K, N) = (64, 64), (256, 64), (192, 64), (64, 256) and a 2048 cube,
     M sized so that each runs about 5 ms at its own bound on this card
     (989 TFLOP/s, 3.35 TB/s).

    python -m mimamo_tpu_torch.bench.layer1_probe [--batch-frames 384]
        [--only-gemm | --no-gemm]
    python -m mimamo_tpu_torch.bench.layer1_probe --cpu --batch-frames 2

``--cpu`` runs sections 1-2 once through the plain versions, a smoke test
of shapes and finiteness that times nothing. Without it the probe needs a
card and raises without one. Every line carries the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from mimamo_tpu_torch.bench._timing import (PEAK_BF16_FLOP_PER_S,
                                            PEAK_BYTES_PER_S, card, device,
                                            time_ms)
from mimamo_tpu_torch.kernels.bottleneck_epilogue import bottleneck_library
from mimamo_tpu_torch.kernels import layer1_dots_kernel as l1
from mimamo_tpu_torch.kernels.layer1_dots_kernel import (BLOCKS, C_IN, IN_HW,
                                                         OUT_W, WIDTH)

STAGE_GFLOP_384 = 513.0           # analytic layer1 at 384 frames of 56^2
GEMM_SHAPES = ((64, 64), (256, 64), (192, 64), (64, 256), (2048, 2048))
GEMM_TARGET_S = 0.005


def _randn(gen: torch.Generator, shape, scale: float, dev) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            ).to(device=dev, dtype=torch.bfloat16)


def dots_weights(seed: int = 1) -> tuple:
    """The probe's dot weights, N(0, 0.05) in bf16 on the CPU: ``(wd, w1a,
    w1b, w2, w3, b1, b2, b3)`` in the layout of ``bench/layer1_probe.py``."""
    gen = torch.Generator().manual_seed(seed)
    shapes = ((C_IN, OUT_W), (C_IN, WIDTH), (BLOCKS - 1, OUT_W, WIDTH),
              (BLOCKS, 3, 3 * WIDTH, WIDTH), (BLOCKS, WIDTH, OUT_W),
              (BLOCKS, 1, WIDTH), (BLOCKS, 1, WIDTH), (BLOCKS, 1, OUT_W))
    return tuple(_randn(gen, s, 0.05, "cpu") for s in shapes)


def stage_blocks(seed: int, dev) -> list:
    """Three layer1 bottlenecks with seeded N(0, 0.05) weights and biases,
    in ``FoldedResNet50``'s layout (OIHW channels_last bf16, bf16 bias,
    stride, padding)."""
    gen = torch.Generator().manual_seed(seed)

    def conv(cout, cin, k):
        w = _randn(gen, (cout, cin, k, k), 0.05, dev).contiguous(
            memory_format=torch.channels_last)
        return w, _randn(gen, (cout,), 0.05, dev), 1, k // 2

    blocks, c = [], C_IN
    for b in range(BLOCKS):
        blk = {"conv1": conv(WIDTH, c, 1), "conv2": conv(WIDTH, WIDTH, 3),
               "conv3": conv(OUT_W, WIDTH, 1)}
        if b == 0:
            blk["downsample"] = conv(OUT_W, c, 1)
        blocks.append(blk)
        c = OUT_W
    return blocks


def library_layer1(x: torch.Tensor, blocks: list) -> torch.Tensor:
    """``[N, 56, 56, 64]`` NHWC -> NCHW view of the ``[N, 56, 56, 256]``
    layer1 output, through the backbone's bottlenecks as PyTorch's own ops
    (cuDNN convs with their biases, relu, residual add)."""
    v = x.permute(0, 3, 1, 2)
    for blk in blocks:
        v = bottleneck_library(v, blk)
    return v


def inputs(n: int, seed: int, dev) -> torch.Tensor:
    """``[n, 56, 56, 64]`` bf16 N(0, 1) on ``dev``, from a seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _randn(gen, (n, IN_HW, IN_HW, C_IN), 1.0, dev)


def gemm_rows(k: int, n: int) -> int:
    """M such that [M, k] x [k, n] takes GEMM_TARGET_S at its own bound:
    operations at the bf16 peak, or its rows' bytes at the memory rate
    (the narrow shapes are bytes-bound)."""
    row_s = max(2.0 * k * n / PEAK_BF16_FLOP_PER_S,
                2.0 * (k + n) / PEAK_BYTES_PER_S)
    return int(GEMM_TARGET_S / row_s) // 256 * 256


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t.float()).all())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch-frames", type=int, default=384)
    ap.add_argument("--iters", type=int, default=5,
                    help="timed batches of back-to-back calls")
    ap.add_argument("--cpu", action="store_true",
                    help="smoke run of sections 1-2 through the plain "
                         "versions (times nothing)")
    ap.add_argument("--only-gemm", action="store_true",
                    help="run section 3 alone")
    ap.add_argument("--no-gemm", action="store_true",
                    help="skip section 3")
    args = ap.parse_args(argv)
    dev = device(args.cpu)
    label = "cpu (plain versions, not timed)" if args.cpu else card()
    n = args.batch_frames

    def emit(row):
        print(json.dumps(dict(row, card=label)), flush=True)

    if not args.only_gemm:
        x = inputs(n, 0, dev)
        blocks = l1.pack_layer1_dots(dots_weights(), dev)
        stage = stage_blocks(2, dev)
        with torch.no_grad():
            y = library_layer1(x, stage)
            got = l1.layer1_dots(x, blocks)
        if (tuple(y.shape) != (n, OUT_W, IN_HW, IN_HW)
                or tuple(got.shape) != (n, IN_HW, IN_HW, OUT_W)
                or not _finite(y) or not _finite(got)):
            raise AssertionError(f"layer1 shapes {tuple(y.shape)}, "
                                 f"{tuple(got.shape)} or non-finite values")
        executed = l1.dot_flops_per_frame() / 1e9
        needed = l1.needed_work()[0] / 1e9
        analytic = l1.ANALYTIC_GFLOP_PER_FRAME
        if args.cpu:
            emit({"which": "library_layer1", "frames": n, "ok": True})
            emit({"which": "layer1_dots", "frames": n, "ok": True,
                  "executed_gflop_per_frame": executed,
                  "needed_gflop_per_frame": needed,
                  "analytic_gflop_per_frame": analytic})
            return 0
        with torch.no_grad():
            lib_ms = time_ms(lambda: library_layer1(x, stage),
                             iters=args.iters)
            dots_ms = time_ms(lambda: l1.layer1_dots(x, blocks),
                              iters=args.iters)
        stage_flop = STAGE_GFLOP_384 * 1e9 / 384 * n
        emit({"which": "library_layer1", "frames": n, "ms": lib_ms,
              "tflops": stage_flop / lib_ms / 1e9,
              "us_per_frame": lib_ms / n * 1e3})
        bound = needed * 1e9 * n / PEAK_BF16_FLOP_PER_S * 1e3
        emit({"which": "layer1_dots", "frames": n, "ms": dots_ms,
              "tflops_executed": executed * n / dots_ms,
              "us_per_frame": dots_ms / n * 1e3,
              "executed_gflop_per_frame": executed,
              "needed_gflop_per_frame": needed,
              "analytic_gflop_per_frame": analytic,
              "bound_ms": bound, "bound_by": "operations",
              "share_of_bound": bound / dots_ms,
              "library_layer1_over_dots": lib_ms / dots_ms})
    if args.cpu or args.no_gemm:
        return 0

    gen = torch.Generator(device=dev).manual_seed(3)
    for k, nn in GEMM_SHAPES:
        m = gemm_rows(k, nn)
        a = torch.randn((m, k), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        w = torch.randn((k, nn), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        ms = time_ms(lambda: torch.matmul(a, w), warmup=1, iters=args.iters,
                     batch=2)
        bound = max(2.0 * m * k * nn / PEAK_BF16_FLOP_PER_S,
                    2.0 * m * (k + nn) / PEAK_BYTES_PER_S) * 1e3
        emit({"which": f"gemm_K{k}_N{nn}", "m": m, "ms": ms,
              "tflops": 2.0 * m * k * nn / ms / 1e9, "bound_ms": bound,
              "share_of_bound": bound / ms})
        del a, w
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
