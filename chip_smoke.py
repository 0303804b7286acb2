"""Smoke run of the PyTorch/CUDA port (mimamo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``mimamo_tpu_torch/csrc`` (into the
gitignored ``mimamo_tpu_torch/_build/``), then:

  1. prints the card's name and power limit (nvidia-smi);
  2. holds each kernel against its plain PyTorch version on the card at
     small ragged shapes and at the flagship shapes (B=8 clips x T=48
     frames of 112^2 crops, bf16 backbone), the phase kernel also at the
     streaming step's shapes (8 slots x 17 frames, all scales), at T = 2,
     at a non-square plane, at planes that are only 8-byte aligned and at
     the special values of atan2; times the kernel, the plain version
     and, where PyTorch computes the same function, the library call (a
     yardstick only; the port never calls it). A time is the median of 5
     event-timed batches of 10 back-to-back calls, after 2 warm-up calls;
  3. drives ``Mimamo.predict_clips`` at the flagship shape with random
     weights from a seed, checks shape and finiteness, and checks that
     every kernel was launched on that run (phase 1: all scales in one
     launch; stem 1; layer2 4 per forward: one launch per bottleneck
     block);
  4. drives a ``StreamingSession`` at capacity 8 x chunk 16 (uint8): 8
     streams fed 3 chunks equal ``predict_clips`` of the same clips; a
     slot removed, added again and fed starts fresh; a slot left out of a
     feed is not moved by it; checks the launch counts of one feed and
     times the feed;
  5. runs ``predict_from_crops`` over 120 frames (4 windows in one padded
     batch of 8) and over 20 frames (padded to one clip, trimmed back)
     against ``merge_window_predictions`` over direct ``predict_clips``,
     with the launch counts of one call;
  6. ``video``: a seeded synthetic source of 240 uint8 frames at
     1280 x 720 with drifting face boxes (side 300-400 px, some past the
     frame's edge) through ``predict_video`` with the boxes and with eye
     points made from them with a small rotation: the card's crops of a
     chunk against ``crop_and_resize`` / ``warp_similarity`` on the CPU
     (max |d| <= 1e-3 on 0..255, also with TF32 switched on globally), the
     series against ``predict_from_crops`` of the card's crops, the launch
     counts; wall time, source frames/s, and the crop and the alignment of
     one 64-frame chunk with the copy and the compute apart;
  7. ``api``: ``MimamoAPI.predict_crops`` on a seeded ``.npy`` of 300
     crops, accumulated (against ``predict_from_crops``) and streamed
     (against one long-clip forward), with emotions (rows summing to 1, a
     CSV of 1 + 300 lines), and ``FeatureExtractor.extract`` against
     ``embed_frames``; ``api_video`` (only where OpenCV imports): a
     120-frame video with a boxes sidecar through ``MimamoAPI.predict``
     and ``VideoProcessor.process``;
  8. runs the same weights on one clip x 8 frames on the CPU, in fp32,
     and compares the card's embeddings and outputs with it;
  9. ``fp32``: the default config (``MimamoConfig()``, fp32 backbone)
     through ``predict_clips`` at the flagship shape: launches (phase 1,
     fp32 stem 1, layer2 kernel 0: fp32 layer2 runs on cuDNN), frames/s,
     the stage split, and the card against the CPU on one clip x 8
     frames; the fp32 stem kernel against its plain version (TF32 off) at
     the flagship shape, N = 64, 256, 300 and small ragged shapes, its
     times and the bounds of the FFMA and 3xTF32 designs;
 10. ``train``: the default config on a synthetic Aff-Wild2 corpus of
     112^2 crops (2 videos of 120 frames): ``train.fit`` for one epoch
     with eval and checkpoints, 20 frozen steps on one batch at lr 1e-3
     (the loss falls, the backbone stays bit-equal), the launches of one
     frozen step, that step against cached features and against the CPU
     (1 clip x 8 frames), 2 fine-tuning steps with ``remat_backbone``
     (the weights, the BN stats and ``predict_clips`` move), save /
     restore / ``MimamoAPI(checkpoint_dir=...)``, ``evaluate_affwild2``,
     and the step times;
 11. prints ``{"kernels": [...]}`` (``max_rel_err``, ``max_abs_err`` and the
     gate's bound under ``tol_max_rel`` or ``tol_abs``) and, last, the
     device line.

Any failure exits non-zero. Needs one CUDA card; imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mimamo_tpu_torch import (StreamingSession, api, checkpoints, phase,
                              preprocess, pyramid, train, weights)
from mimamo_tpu_torch.config import BackboneSpec, MimamoConfig, TrainSpec
from mimamo_tpu_torch.data import datasets
from mimamo_tpu_torch.data.eval import evaluate_affwild2
from mimamo_tpu_torch.kernels import (_build, layer2_kernel, phase_kernel,
                                      stem_kernel)
from mimamo_tpu_torch.kernels.layer2_kernel import C_IN, OUT_W, WIDTH
from mimamo_tpu_torch.preprocess import (for_backbone,
                                         merge_window_predictions,
                                         pad_short_clip, to_grayscale,
                                         window_starts)
from mimamo_tpu_torch.runner import Mimamo

B, T, S = 8, 48, 112          # flagship step: 384 frames of 112^2 crops
CAPACITY, CHUNK = 8, 16       # streaming step: 8 slots x 16 frames a feed
SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet), at a 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12     # tensor cores, dense
PEAK_FP32_FLOP_PER_S = 67e12      # outside the tensor cores
PEAK_TF32_FLOP_PER_S = 495e12     # tensor cores, dense
PHASE_TOL = 1e-4              # max |kernel - plain|, radians
BF16_REL_TOL = 2e-2           # max |kernel - plain| / max |plain|
# Card (bf16) vs CPU (fp32) on one 8-frame clip: bf16 rounding of the
# ResNet activations moves the embeddings by under 1% and the outputs by
# several % of their (small, random-weight) range on the CPU alone.
EMB_REL_TOL = 2e-2
OUT_REL_TOL = 1.5e-1
# Streamed chunks vs the whole clip on the card (max |d| / max |ref|): the
# same kernels on the same frames; what may differ is the order in which
# cuDNN and the GRU sum at 128 frames x 16 steps and at 384 x 48. Seen:
# 8e-6 on an H100.
STREAM_REL_TOL = 1e-4
# A slot left out of a feed, and a batch of windows against the same
# batch: the same shapes and lanes, so the same numbers.
SAME_SHAPE_REL_TOL = 1e-6
# Crops of the card against the CPU's, 0..255 scale: the warp is the same
# fp32 operations; the crop's GEMMs sum two non-zero hat weights per
# output value in another order. TF32 would be off by up to ~0.2.
CROP_ATOL = 1e-3
VIDEO_T, VIDEO_H, VIDEO_W = 240, 720, 1280    # the video phase's source
CROP_CHUNK = 64                               # crop_video_chunked's chunk
API_T = 300                                   # crops of the api phase
API_CHUNK = 256           # MimamoAPI.predict_crops's chunk (streamed feed)
API_BATCH = 64            # classify and FeatureExtractor batches
# Probabilities of one frame sum to 1.
PROB_SUM_TOL = 1e-5
# The fp32 stem kernel against stem_plain with TF32 off: the CPU test's
# bound against the Pallas f32 kernel (tests/test_torch_kernels.py).
STEM_F32_REL_TOL = 1e-5           # max |d| / max |plain|
STEM_F32_ATOL = 1e-3              # max |d|, stem outputs reach the hundreds
# The default fp32 backbone on the card against the CPU, one 8-frame clip:
# fp32 on both sides, the sums in another order. Seen on an H100:
# embeddings 3.4e-7, outputs 3.6e-6.
FP32_EMB_REL_TOL = 1e-5
FP32_OUT_REL_TOL = 5e-5
TRAIN_T = 120        # frames of each synthetic video: 4 clips of 48 at 24
# A frozen step on cached features against the online step: the same
# kernels on the same frames; the temporal backward's sums may land in
# another order. Seen: loss 0.0, temporal weights 5.6e-9.
CACHED_TOL = 1e-6
# One frozen step on the card against the CPU, 1 clip x 8 frames: loss,
# temporal gradients (max |d| / max |g| per tensor), temporal BN running
# stats, and the parameters with a well-determined gradient. Seen: 4.8e-7,
# 2.9e-5, 1.2e-7, 7.5e-9.
STEP_LOSS_ATOL = 1e-5
STEP_GRAD_REL_TOL = 3e-4
STEP_BN_ATOL = 1e-5
STEP_PARAM_ATOL = 1e-6


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 2, iters: int = 5, batch: int = 10) -> float:
    """Time of one run of ``fn`` on the current stream: the median over
    ``iters`` batches of ``batch`` back-to-back runs between two CUDA
    events, after ``warmup`` runs. Back to back, so that the card is not
    idle while the host prepares a launch and a short kernel's time is
    the card's, not the host's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def max_rel(got, want) -> float:
    """max |got - want| / max |want| of two tensors or arrays, on the
    device of the first tensor among them."""
    dev = next((x.device for x in (got, want)
                if isinstance(x, torch.Tensor)), None)
    got = torch.as_tensor(got, device=dev).float()
    want = torch.as_tensor(want, device=dev).float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-12)
            ).item()


def bound_ms(nbytes: float, flops: float,
             peak_flop_per_s: float = PEAK_BF16_FLOP_PER_S):
    """The least time (ms) the card could take: the larger of the bytes
    over its memory rate and the operations over its peak rate for their
    type; and which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flop_per_s * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def errors(got, want) -> dict:
    """The two error measures of the ``kernels`` line: max |got - want| /
    max |want| and max |got - want|."""
    return {"max_rel_err": max_rel(got, want),
            "max_abs_err": (got.float() - want.float()).abs().max().item()}


def record(name, source, replaces, errs, tols, ms, plain_ms, nbytes, flops,
           library_ms, peak_flop_per_s=PEAK_BF16_FLOP_PER_S):
    """One kernel's entry of the ``kernels`` line. ``errs``:
    :func:`errors`; ``tols``: the gate's bounds, keyed by unit
    (``tol_max_rel``, ``tol_abs``)."""
    bound, bound_by = bound_ms(nbytes, flops, peak_flop_per_s)
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": None, **errs, **tols, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
           "library_ms": library_ms}
    print(json.dumps(dict(rec, kernel_ms=ms)), flush=True)
    return rec


def phase_bands(frames: torch.Tensor, cfg: MimamoConfig) -> list:
    return list(pyramid.bands(
        frames, cfg.pyramid, pyramid.band_masks(cfg.pyramid, frames.device)))


def phase_work(bands: list, out: torch.Tensor):
    """Bytes the phase kernel must move (every complex64 band value read
    once, every output written once) and its fp32 operations: per source
    pixel of a pair 6 for the complex product and 24 for the angle (a
    division, the octant fold, an 8-term polynomial), per output pixel 9
    for the 2 x 2 taps."""
    nbytes = sum(b.numel() * 8 for b in bands) + out.numel() * 4
    pairs = sum(b.numel() // b.shape[1] * (b.shape[1] - 1) for b in bands)
    return nbytes, 30.0 * pairs + 9.0 * out.numel()


def phase_errs(bands: list, cfg: MimamoConfig, what: str) -> dict:
    """:func:`errors` of one launch over all ``bands`` against the plain
    version, without and with amplitude weighting; raises when max |d|
    exceeds PHASE_TOL."""
    k, p = cfg.pyramid.orientations, cfg.phase.phase_size
    b, t = bands[0].shape[:2]
    errs = {}
    for weighting in (False, True):
        out = torch.empty((b, t - 1, len(bands) * k, p, p),
                          device=bands[0].device)
        phase_kernel.phase_diff_resize_scales(
            bands, out, [s * k for s in range(len(bands))], weighting)
        want = torch.cat([phase.phase_diff_resize(band, p, weighting)
                          for band in bands], dim=2)
        torch.cuda.synchronize()
        errs[weighting] = errors(out, want)
        if not errs[weighting]["max_abs_err"] <= PHASE_TOL:
            raise AssertionError(f"phase kernel at {what} (weighting="
                                 f"{weighting}): max |err| {errs[weighting]}"
                                 f" > {PHASE_TOL}")
    return errs


def check_phase(frames: torch.Tensor, cfg: MimamoConfig) -> dict:
    """The phase kernel at the flagship step: all scales in one launch
    against the plain version, and its times."""
    p, k = cfg.phase.phase_size, cfg.pyramid.orientations
    bands = phase_bands(frames, cfg)
    channels = [s * k for s in range(len(bands))]
    out = torch.empty((B, T - 1, len(bands) * k, p, p), device=frames.device)

    def kernel(weighting=False):
        return phase_kernel.phase_diff_resize_scales(bands, out, channels,
                                                     weighting)

    def plain(weighting=False):
        return torch.cat([phase.phase_diff_resize(band, p, weighting)
                          for band in bands], dim=2)

    errs = phase_errs(bands, cfg, "the flagship step")
    print(json.dumps({"phase_weighted_max_abs_err":
                      errs[True]["max_abs_err"],
                      "phase_weighted_ms": time_ms(lambda: kernel(True)),
                      "phase_weighted_plain_ms":
                      time_ms(lambda: plain(True), batch=2)}), flush=True)
    nbytes, flops = phase_work(bands, out)
    return record(
        "phase_diff_resize", "mimamo_tpu_torch/csrc/phase_diff_resize.cu",
        "mimamo_tpu/pallas/phase_kernel.py:112", errs[False],
        {"tol_abs": PHASE_TOL},
        time_ms(kernel), time_ms(plain, batch=2), nbytes, flops, None,
        PEAK_FP32_FLOP_PER_S)


def check_phase_shapes(cfg: MimamoConfig, frames: torch.Tensor) -> None:
    """The phase kernel away from the flagship step, against the plain
    version (PHASE_TOL): the streaming step (8 slots x 17 frames of real
    bands, all scales in one launch) with its bound and time; the api
    phase's one-video shapes on real bands (1 x 256 frames: the first
    streamed chunk, 1 x 257: a later chunk with its context frame,
    1 x 300: the long-clip forward); a single
    pair (T = 2); a partial channel slice, whose neighbours must stay
    untouched; a non-square plane; planes of 7 x 5, an odd number of
    values, so that every other plane starts at 8 but not 16 bytes, and
    planes of 34 x 34 that all do; products on the axes and at signed
    zeros; a frame against itself and an all-zero lane (a fresh slot and
    an unfed lane)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p, k = cfg.phase.phase_size, cfg.pyramid.orientations
    errs = {}

    def randn(shape):
        return torch.randn(shape, dtype=torch.complex64, device="cuda",
                           generator=gen)

    bands = phase_bands(frames[:CAPACITY, :CHUNK + 1], cfg)
    errs["stream_step"] = phase_errs(bands, cfg, "the streaming step")
    out = torch.empty((CAPACITY, CHUNK, len(bands) * k, p, p), device="cuda")
    channels = [s * k for s in range(len(bands))]
    print(json.dumps({
        "phase_stream_step_ms": time_ms(
            lambda: phase_kernel.phase_diff_resize_scales(
                bands, out, channels, False)),
        "phase_stream_step_plain_ms": time_ms(lambda: torch.cat(
            [phase.phase_diff_resize(b, p, False) for b in bands], dim=2)),
        "phase_stream_step_bound_ms": bound_ms(
            *phase_work(bands, out), PEAK_FP32_FLOP_PER_S)[0]}), flush=True)
    errs["t2"] = phase_errs(phase_bands(frames[:CAPACITY, :2], cfg), cfg,
                            "T = 2")
    one_video = frames.reshape((1, -1) + tuple(frames.shape[2:]))
    for t in (API_CHUNK, API_CHUNK + 1, API_T):
        errs[f"b1_t{t}"] = phase_errs(phase_bands(one_video[:, :t], cfg),
                                      cfg, f"1 x {t} frames")
    misaligned = randn(2 * 4 * 2 * 34 * 34 + 1)[1:].view(2, 4, 2, 34, 34)
    if misaligned.data_ptr() % 16 != 8:
        raise AssertionError("the 34 x 34 band should start 8 bytes off")
    for name, band in (("partial_channels", randn((3, 6, 2, 32, 32))),
                       ("non_square", randn((2, 5, 3, 20, 28))),
                       ("odd_7x5", randn((2, 4, 3, 7, 5))),
                       ("misaligned_34", misaligned)):
        kb = band.shape[2]
        for weighting in (False, True):
            out = torch.zeros((band.shape[0], band.shape[1] - 1, kb + 2, p,
                               p), device="cuda")
            phase_kernel.phase_diff_resize(band, out, 1, weighting)
            want = phase.phase_diff_resize(band, p, weighting)
            err = (out[:, :, 1:1 + kb] - want).abs().max().item()
            errs[f"{name}_w{int(weighting)}"] = err
            if not (err <= PHASE_TOL and not out[:, :, 0].any()
                    and not out[:, :, -1].any()):
                raise AssertionError(f"phase kernel at {name}: {errs}")
    # prod = c * conj(1) = c over the axes, the wrap and signed zeros,
    # resized 10 -> 10 (the identity)
    vals = torch.tensor([0.0, -0.0, 1.0, -1.0, 1e-30, -1e-30, 3.0, -3.0,
                         1e-20, 1e20], device="cuda")
    re, im = torch.meshgrid(vals, vals, indexing="ij")
    cur = torch.complex(re, im).reshape(1, 1, 1, 10, 10)
    band = torch.cat([torch.ones_like(cur), cur], dim=1).contiguous()
    out = torch.zeros((1, 1, 1, 10, 10), device="cuda")
    phase_kernel.phase_diff_resize(band, out, 0, False)
    want = phase.phase_diff_resize(band, 10, False)
    errs["special_values"] = (out - want).abs().max().item()
    flips = int((torch.signbit(out) != torch.signbit(want)).sum())
    if not errs["special_values"] <= PHASE_TOL or flips:
        raise AssertionError(f"phase kernel at special values: {errs}, "
                             f"{flips} sign flips")
    band = randn((2, 3, 2, 32, 32))
    band[:, 1] = band[:, 0]
    band[1] = 0
    for weighting in (False, True):
        out = torch.full((2, 2, 2, p, p), 7.0, device="cuda")
        phase_kernel.phase_diff_resize(band, out, 0, weighting)
        want = phase.phase_diff_resize(band, p, weighting)
        err = (out - want).abs().max().item()
        errs[f"self_pair_w{int(weighting)}"] = err
        if not (err <= PHASE_TOL and out[0, 0].abs().max() <= 1e-6
                and not out[1].any()):
            raise AssertionError(f"phase kernel on a frame against itself "
                                 f"or on zero lanes: {errs}")
    print(json.dumps({"phase_shapes_err": errs}), flush=True)


def check_stem(crops: torch.Tensor, model: Mimamo) -> dict:
    folded = model._backbone_folded()
    w2, bias = folded.stem
    mean = model.config.backbone.mean_rgb
    got = stem_kernel.stem_fused(crops, w2, bias, mean)
    want = stem_kernel.stem_plain(crops, w2, bias, mean)
    rel = max_rel(got, want)
    if not rel < BF16_REL_TOL:
        raise AssertionError(f"stem kernel max-rel {rel} >= {BF16_REL_TOL}")
    k = w2.float().reshape(7, 7, 3, 64).permute(3, 2, 0, 1).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bias_bf = bias.to(torch.bfloat16)

    def library():
        x = for_backbone(crops, model.config.backbone).to(torch.bfloat16)
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k, bias_bf,
                                       stride=2, padding=3)
        return torch.nn.functional.max_pool2d(torch.relu(y), 3, 2, 1)

    n = crops.shape[0]
    nbytes = crops.numel() * 4 + got.numel() * 2
    flops = 2.0 * n * S * S * 64 * 147
    return record(
        "stem_fused", "mimamo_tpu_torch/csrc/stem.cu",
        "mimamo_tpu/pallas/stem_kernel.py:153", errors(got, want),
        {"tol_max_rel": BF16_REL_TOL},
        time_ms(lambda: stem_kernel.stem_fused(crops, w2, bias, mean)),
        time_ms(lambda: stem_kernel.stem_plain(crops, w2, bias, mean)),
        nbytes, flops, time_ms(library))


def check_layer2(crops: torch.Tensor, model: Mimamo) -> dict:
    folded = model._backbone_folded()
    w2, bias = folded.stem
    stem = stem_kernel.stem_fused(crops, w2, bias,
                                  model.config.backbone.mean_rgb)
    x = folded._stage(stem.permute(0, 3, 1, 2), 1).permute(
        0, 2, 3, 1).contiguous()                       # layer1 output
    blocks = folded.layer2
    got = layer2_kernel.layer2_fused(x, blocks)
    want = layer2_kernel.layer2_plain(x, blocks)
    rel = max_rel(got, want)
    if not rel < BF16_REL_TOL:
        raise AssertionError(f"layer2 kernel max-rel {rel} >= "
                             f"{BF16_REL_TOL}")
    lib = []
    for blk in blocks:
        lib.append({name: (c.weight.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last), c.bias.to(torch.bfloat16),
            c.stride, c.weight.shape[1] // 2) for name, c in blk.items()})

    def library():
        v = x.permute(0, 3, 1, 2)
        for blk in lib:
            v = folded._bottleneck(v, blk)
        return v

    # every layer2 conv writes the output grid (block 0 strides its 1x1s)
    pixels = got.shape[0] * got.shape[1] * got.shape[2]
    print(json.dumps({"layer2_byte_floor_ms": layer2_byte_floors(pixels)}),
          flush=True)
    flops = sum(2.0 * pixels * c.weight.numel()
                for blk in blocks for c in blk.values())
    nbytes = x.numel() * 2 + got.numel() * 2 + sum(
        c.weight.numel() * 2 + c.bias.numel() * 4
        for blk in blocks for c in blk.values())
    return record(
        "layer2_fused", "mimamo_tpu_torch/csrc/layer2.cu",
        "mimamo_tpu/pallas/layer2_kernel.py:174", errors(got, want),
        {"tol_max_rel": BF16_REL_TOL},
        time_ms(lambda: layer2_kernel.layer2_fused(x, blocks)),
        time_ms(lambda: layer2_kernel.layer2_plain(x, blocks)),
        nbytes, flops, time_ms(library))


def layer2_byte_floors(pixels: int) -> dict:
    """Least time to move layer2's activations at 3.35 TB/s (weights left
    out), for the 13-launch unfused design (each conv reads its input and
    writes its output, block 0's projection stored and read back in fp32)
    and for one fused launch per block (x read once, out written once).
    ``pixels``: output pixels, N x H x W."""
    mb = lambda ch, size=2: pixels * ch * size       # bytes of one map
    x_even, y, out, proj = mb(C_IN), mb(WIDTH), mb(OUT_W), mb(OUT_W, 4)
    unfused = ((x_even + proj) + (x_even + y) + 2 * y + (y + proj + out)
               + 3 * ((out + y) + 2 * y + (y + out + out)))
    fused = (x_even + out) + 3 * (out + out)
    return {"unfused_13_launches": unfused / PEAK_BYTES_PER_S * 1e3,
            "fused_4_launches": fused / PEAK_BYTES_PER_S * 1e3,
            "unfused_gb": unfused / 1e9, "fused_gb": fused / 1e9}


def check_small_shapes(model: Mimamo) -> None:
    """The stem and layer2 kernels at shapes other than the flagship's,
    against their plain versions: a crop size with an odd number of pooled
    rows and 5 crops at 112; the stem and layer2 at the frame counts of
    the other paths: the streaming feed's 128, the api phase's batches of
    64 (``classify_frames``, ``FeatureExtractor``), its streamed chunk of
    256 and its long clip of 300; layer2 at 8 x 6 output
    pixels (ragged width), at 9 x 31 (a partial 4-row tile, the widest
    output the kernel takes), and at 1 and 3 frames of 56 x 56 (frame
    counts that are no multiple of any per-CTA grouping)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    w2, bias = model._backbone_folded().stem
    crops = torch.rand((3, 34, 34, 3), device="cuda", generator=gen) * 255
    mean = model.config.backbone.mean_rgb
    errs["stem_s34"] = max_rel(stem_kernel.stem_fused(crops, w2, bias, mean),
                               stem_kernel.stem_plain(crops, w2, bias, mean))
    crops = torch.rand((5, S, S, 3), device="cuda", generator=gen) * 255
    errs["stem_n5"] = max_rel(stem_kernel.stem_fused(crops, w2, bias, mean),
                              stem_kernel.stem_plain(crops, w2, bias, mean))
    counts = (CAPACITY * CHUNK, API_BATCH, API_CHUNK, API_T)
    for n in counts:
        crops = torch.rand((n, S, S, 3), device="cuda", generator=gen) * 255
        errs[f"stem_n{n}"] = max_rel(
            stem_kernel.stem_fused(crops, w2, bias, mean),
            stem_kernel.stem_plain(crops, w2, bias, mean))
    del crops
    blocks = model._backbone_folded().layer2
    shapes = [(f"layer2_n{n}", (n, 56, 56, 256)) for n in counts] + [
        ("layer2_16x12", (2, 16, 12, 256)), ("layer2_18x62", (2, 18, 62, 256)),
        ("layer2_n1", (1, 56, 56, 256)), ("layer2_n3", (3, 56, 56, 256))]
    for name, shape in shapes:
        x = torch.randn(shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        errs[name] = max_rel(layer2_kernel.layer2_fused(x, blocks),
                             layer2_kernel.layer2_plain(x, blocks))
    print(json.dumps({"small_shapes_err": errs}), flush=True)
    if not all(err < BF16_REL_TOL for err in errs.values()):
        raise AssertionError(f"kernels at small shapes: {errs}")


def stage_breakdown(model: Mimamo, clips: np.ndarray,
                    context: torch.Tensor = None) -> dict:
    """Device time (ms) of each stage of one forward over uint8 ``clips``
    [B, T, S, S, 3]: the calls ``Mimamo.forward`` makes, with CUDA events
    recorded between stages. With ``context`` ([B, 1, S, S, 3] on the card)
    it is a streaming forward: the context frame is prepended for the micro
    stream only, and the GRUs start from given carries."""
    cfg, folded = model.config, model._backbone_folded()
    b, t = clips.shape[:2]
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    with torch.no_grad():
        carries = None
        if context is not None:
            carries = tuple(torch.zeros((b, cfg.temporal.gru_hidden),
                                        device="cuda") for _ in range(2))
        mark("start")
        crops = torch.from_numpy(clips).cuda()
        if context is not None:
            crops = torch.cat([context, crops], dim=1)
        crops = crops.float()
        mark("h2d_cast")
        gray = to_grayscale(crops)
        mark("grayscale")
        k, p = cfg.pyramid.orientations, cfg.phase.phase_size
        bands = phase_bands(gray, cfg)
        mark("fft_bands")
        stacks = torch.empty((b, crops.shape[1] - 1, cfg.num_phase, p, p),
                             device=gray.device)
        phase_kernel.phase_diff_resize_scales(
            bands, stacks, [s * k for s in range(len(bands))], False)
        mark("phase_kernel")
        own = crops[:, 1:] if context is not None else crops
        stem = stem_kernel.stem_fused(own.reshape(b * t, S, S, 3),
                                      *folded.stem, cfg.backbone.mean_rgb)
        mark("stem_kernel")
        x = folded._stage(stem.permute(0, 3, 1, 2), 1)
        mark("layer1")
        x = folded.run_layer2(x)
        mark("layer2_kernel" if folded.layer2 is not None
             else "layer2_cudnn")
        x = folded._stage(x, 3)
        mark("layer3")
        x = folded._stage(x, 4)
        mark("layer4")
        emb = x.to(torch.float32).mean(dim=(2, 3)).to(x.dtype).float()
        mark("pool5")
        model.temporal(stacks, emb.reshape(b, t, -1), carries)
        mark("temporal")
    torch.cuda.synchronize()
    return {name: prev.elapsed_time(event)
            for (_, prev), (name, event) in zip(marks, marks[1:])}


def median_stages(runs: list) -> dict:
    return {name: statistics.median(r[name] for r in runs)
            for name in runs[0]}


KERNELS = {"phase_diff_resize": phase_kernel.KERNEL,
           "stem_fused": stem_kernel.KERNEL,
           "layer2_fused": layer2_kernel.KERNEL,
           "stem_fused[f32]": stem_kernel.KERNEL_F32}


def expected_launches(forwards: int = 1, classify: int = 0,
                      fp32: bool = False) -> dict:
    """Launches of ``forwards`` forwards, clip or streaming (the phase
    kernel takes all scales in one launch), and ``classify`` backbone-only
    calls (``classify_frames``: the backbone, no phase). A bf16 backbone
    launches the bf16 stem and layer2 (one launch per bottleneck block);
    an fp32 one the fp32 stem, with layer2 on cuDNN."""
    backbone = forwards + classify
    return {"phase_diff_resize": forwards,
            "stem_fused": 0 if fp32 else backbone,
            "layer2_fused": 0 if fp32 else 4 * backbone,
            "stem_fused[f32]": backbone if fp32 else 0}


def counted(fn, expected: dict = None):
    """Run ``fn`` with the kernels' launch counts set to 0 just before, and
    return (its result, the counts just after); raises unless they are
    ``expected`` (default: one forward)."""
    expected = expected or expected_launches()
    for kern in KERNELS.values():
        kern.launches = 0
    result = fn()
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    return result, launches


def fill_session(model: Mimamo, clips: np.ndarray):
    """A uint8 session with all slots claimed and fed ``clips`` chunk by
    chunk; returns (session, outputs [CAPACITY, T, 2])."""
    sess = StreamingSession(model, capacity=CAPACITY, chunk=CHUNK,
                            dtype=np.uint8)
    slots = [sess.add_stream() for _ in range(CAPACITY)]
    outs = []
    for start in range(0, clips.shape[1], CHUNK):
        got = sess.feed({slot: clips[slot, start:start + CHUNK]
                         for slot in slots})
        outs.append(np.stack([got[slot] for slot in slots]))
    return sess, np.concatenate(outs, axis=1)


def check_streaming(model: Mimamo, clips: np.ndarray, line: str) -> dict:
    """The streaming path at capacity 8 x chunk 16; returns the launch
    counts of one feed."""
    whole = model.predict_clips(clips).cpu().numpy()
    sess, streamed = fill_session(model, clips)
    if streamed.shape != (CAPACITY, T, 2) or not np.isfinite(streamed).all():
        raise AssertionError(f"streamed outputs {streamed.shape}")
    rel = max_rel(streamed, whole)
    # a slot removed, added again and fed starts fresh; the slots left out
    # of that feed are not moved by it
    extra = np.random.default_rng(SEED + 1).integers(
        0, 256, (CAPACITY, CHUNK, S, S, 3), dtype=np.uint8)
    twin, _ = fill_session(model, clips)
    undisturbed = twin.feed({slot: extra[slot] for slot in range(CAPACITY)})
    sess.remove_stream(3)
    if sess.add_stream() != 3 or sess.free_slots != 0:
        raise AssertionError("the freed slot was not reused")
    fed = {0: extra[0], 1: extra[1], 3: clips[3, :CHUNK]}
    got = sess.feed(fed)
    fresh_rel = max_rel(got[3], whole[3, :CHUNK])
    later = sess.feed({slot: extra[slot] for slot in (2, 4, 5, 6, 7)})
    unfed_rel = max(max_rel(later[slot], undisturbed[slot])
                    for slot in later)
    fed_rel = max(max_rel(got[slot], undisturbed[slot])
                  for slot in (0, 1))
    print(json.dumps({"stream_vs_clips_max_rel": rel,
                      "fresh_slot_vs_clips_max_rel": fresh_rel,
                      "unfed_slot_max_rel": unfed_rel,
                      "fed_beside_fresh_max_rel": fed_rel,
                      "tol": [STREAM_REL_TOL, SAME_SHAPE_REL_TOL]}),
          flush=True)
    if not (rel < STREAM_REL_TOL and fresh_rel < STREAM_REL_TOL
            and unfed_rel <= SAME_SHAPE_REL_TOL
            and fed_rel <= SAME_SHAPE_REL_TOL):
        raise AssertionError("the streaming session disagrees with clip "
                             "mode or with an undisturbed session")

    feeds = [{slot: clips[slot, start:start + CHUNK]
              for slot in range(CAPACITY)} for start in range(0, T, CHUNK)]
    for i in range(2):
        sess.feed(feeds[i])                              # warm-up
    _, launches = counted(lambda: sess.feed(feeds[2]))
    times = []
    for i in range(10):
        t = time.perf_counter()
        sess.feed(feeds[i % len(feeds)])     # ends with the result's .cpu()
        times.append(time.perf_counter() - t)
    feed = statistics.median(times)
    print(json.dumps({"stream_feed_ms": feed * 1e3,
                      "frames_per_s": CAPACITY * CHUNK / feed,
                      "feeds_ms": [x * 1e3 for x in times],
                      "capacity": CAPACITY, "chunk": CHUNK, "card": line}),
          flush=True)
    context = torch.from_numpy(clips[:, :1]).cuda()
    stages = median_stages([stage_breakdown(model, clips[:, :CHUNK], context)
                            for _ in range(5)])
    print(json.dumps({"stream_stage_ms": stages,
                      "stream_stage_sum_ms": sum(stages.values()),
                      "card": line}), flush=True)
    return launches


def check_from_crops(model: Mimamo, line: str) -> dict:
    """``predict_from_crops`` over 120 frames (windows at 0, 24, 48, 72 in
    one batch of 8, padded by repeats) and over 20 frames (padded to one
    clip, trimmed back), against the overlap average of direct
    ``predict_clips`` calls on the same padded batches; returns the launch
    counts of one call (one batch, so one forward)."""
    cfg = model.config.clip
    rng = np.random.default_rng(SEED + 2)
    for frames in (120, 20):
        crops = rng.integers(0, 256, (frames, S, S, 3), dtype=np.uint8)
        got, launches = counted(lambda: model.predict_from_crops(crops))
        padded = pad_short_clip(crops, cfg.clip_len)
        starts = window_starts(padded.shape[0], cfg.clip_len, cfg.stride)
        idx = starts[:, None] + np.arange(cfg.clip_len)[None, :]
        idx = np.concatenate([idx, np.repeat(idx[-1:], 8 - len(idx), axis=0)])
        direct = model.predict_clips(padded[idx])[:len(starts)].cpu().numpy()
        want = merge_window_predictions(direct, starts,
                                        padded.shape[0])[:frames]
        rel = max_rel(got, want)
        t = time.perf_counter()
        model.predict_from_crops(crops)
        ms = (time.perf_counter() - t) * 1e3
        print(json.dumps({"predict_from_crops_frames": frames,
                          "windows": len(starts), "max_rel": rel, "ms": ms,
                          "card": line}), flush=True)
        if (got.shape != (frames, 2) or got.dtype != np.float32
                or not np.isfinite(got).all()
                or not rel <= SAME_SHAPE_REL_TOL):
            raise AssertionError(f"predict_from_crops over {frames} frames: "
                                 f"{got.shape} {got.dtype}, max-rel {rel}")
    return launches


class MatmulTF32(TorchDispatchMode):
    """Records the TF32 switch as it stands at each matmul run inside."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in ("mm", "bmm", "addmm", "baddbmm",
                                            "matmul"):
            self.seen.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


def video_source(t: int, h: int, w: int, seed: int):
    """A seeded synthetic source: [t, h, w, 3] uint8 frames, [t, 4] square
    face boxes (y0, x0, side, side) that drift smoothly, with a side of
    300-400 px at 720p (scaled with h) and past the frame's edges at
    times, and [t, 2, 2] eye points made from the boxes with a small
    rotation (up to 8 degrees)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    i = np.arange(t)
    scale = h / VIDEO_H
    side = scale * (350 + 50 * np.sin(i / 19))
    y0 = (h - side) / 2 + scale * 240 * np.sin(i / 23 + 1.0)
    x0 = (w - side) / 2 + scale * 520 * np.sin(i / 37 - 1.2)
    boxes = np.stack([y0, x0, side, side], 1).astype(np.float32)
    th = np.deg2rad(rng.uniform(-8, 8, t))
    cy, cx, half = y0 + 0.38 * side, x0 + 0.5 * side, 0.28 * side
    eyes = np.stack([
        np.stack([cy + half * np.sin(th), cx - half * np.cos(th)], -1),
        np.stack([cy - half * np.sin(th), cx + half * np.cos(th)], -1)],
        1).astype(np.float32)
    return frames, boxes, eyes


def chunk_ms(frames: np.ndarray, params: np.ndarray, align: bool) -> tuple:
    """Device time of one CROP_CHUNK-frame chunk of ``crop_video_chunked``:
    (the pageable uint8 copy to the card, the crop or alignment), medians
    of 5 after a warm-up."""
    crop = (preprocess.warp_similarity if align
            else preprocess.crop_and_resize)
    host = frames[:CROP_CHUNK]
    p = torch.from_numpy(params[:CROP_CHUNK]).cuda()
    copy, compute = [], []
    for i in range(6):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        dev = torch.from_numpy(host).cuda()
        marks[1].record()
        crop(dev, p, S)
        marks[2].record()
        marks[2].synchronize()
        if i:
            copy.append(marks[0].elapsed_time(marks[1]))
            compute.append(marks[1].elapsed_time(marks[2]))
    return statistics.median(copy), statistics.median(compute)


def check_video(model: Mimamo, line: str) -> dict:
    """``predict_video`` over VIDEO_T frames at 1280 x 720, with boxes and
    with eye points; returns the launch counts of one call."""
    cfg = model.config.clip
    frames, boxes, eyes = video_source(VIDEO_T, VIDEO_H, VIDEO_W, SEED + 3)
    batches = -(-len(window_starts(VIDEO_T, cfg.clip_len, cfg.stride)) // 8)
    launches = None
    for mode, kw in (("boxes", {"boxes": boxes}),
                     ("eyes", {"landmarks": eyes})):
        align = mode == "eyes"
        model.predict_video(frames, **kw)                  # warm-up
        got, launches = counted(lambda: model.predict_video(frames, **kw),
                                expected_launches(batches))
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            model.predict_video(frames, **kw)               # ends on the host
            walls.append(time.perf_counter() - t)
        wall = statistics.median(walls)
        params = (preprocess.similarity_from_landmarks(eyes, cfg.crop_size)
                  if align else boxes)
        crops = model.crop_video_chunked(frames, params, align=align)
        rel = max_rel(got, model.predict_from_crops(crops, t_real=VIDEO_T))
        crop = (preprocess.warp_similarity if align
                else preprocess.crop_and_resize)
        cpu = crop(torch.from_numpy(frames[:CROP_CHUNK]),
                   torch.from_numpy(params[:CROP_CHUNK]), cfg.crop_size)
        err = (crops[:CROP_CHUNK].cpu() - cpu).abs().max().item()
        rec = MatmulTF32()
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True      # globally on
        try:
            with rec:
                crops_on = model.crop_video_chunked(
                    frames[:CROP_CHUNK], params[:CROP_CHUNK], align=align)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        err_on = (crops_on.cpu() - cpu).abs().max().item()
        copy_ms, compute_ms = chunk_ms(frames, params, align)
        report = {
            "video": mode, "frames": VIDEO_T, "source": [VIDEO_H, VIDEO_W],
            "wall_ms": wall * 1e3, "walls_ms": [x * 1e3 for x in walls],
            "source_frames_per_s": VIDEO_T / wall,
            "series_vs_from_crops_max_rel": rel,
            "crop_vs_cpu_max_abs": err,
            "crop_vs_cpu_max_abs_tf32_switched_on": err_on,
            "tf32_at_each_matmul_inside_crop": rec.seen,
            "chunk_frames": CROP_CHUNK, "chunk_copy_ms": copy_ms,
            "chunk_compute_ms": compute_ms, "launches": launches,
            "card": line}
        print(json.dumps(report), flush=True)
        # the crop runs two matmuls, both with TF32 off; the warp none
        if (got.shape != (VIDEO_T, 2) or not np.isfinite(got).all()
                or not rel <= SAME_SHAPE_REL_TOL or not err <= CROP_ATOL
                or not err_on <= CROP_ATOL
                or rec.seen != ([] if align else [False, False])):
            raise AssertionError(f"predict_video with {mode}: {report}")
    return launches


def check_api(model: Mimamo, state: dict, line: str) -> dict:
    """``MimamoAPI.predict_crops`` and ``FeatureExtractor.extract`` on a
    seeded ``.npy`` of API_T crops; returns the launch counts of one
    ``classify_frames`` call."""
    cfg = model.config
    crops = np.random.default_rng(SEED + 4).integers(
        0, 256, (API_T, S, S, 3), dtype=np.uint8)
    starts = window_starts(API_T, cfg.clip.clip_len, cfg.clip.stride)
    batches = -(-len(starts) // 8)
    report = {"api_crops": API_T, "card": line}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "crops.npy")
        np.save(path, crops)
        a = api.MimamoAPI(config=cfg, state_dict=state, device="cuda")
        a.predict_crops(path, streaming_threshold=None)      # warm-up
        acc, report["launches_predict_crops"] = counted(
            lambda: a.predict_crops(path, streaming_threshold=None),
            expected_launches(batches))
        report["accumulated_vs_from_crops_max_rel"] = max_rel(
            acc, a.model.predict_from_crops(crops))
        t = time.perf_counter()
        a.predict_crops(path, streaming_threshold=None)
        report["predict_crops_ms"] = (time.perf_counter() - t) * 1e3
        streamed = a.predict_crops(path, streaming_threshold=0)
        t = time.perf_counter()
        a.predict_crops(path, streaming_threshold=0)
        report["predict_crops_streamed_ms"] = (time.perf_counter() - t) * 1e3
        report["streamed_vs_long_clip_max_rel"] = max_rel(
            streamed, a.model.predict_clips(crops[None])[0])
        csv = os.path.join(tmp, "out.csv")
        (series, probs), report["launches_emotions"] = counted(
            lambda: a.predict_crops(path, streaming_threshold=None,
                                    emotions=True, out_csv=csv),
            expected_launches(batches, classify=-(-API_T // API_BATCH)))
        with open(csv) as f:
            report["csv_lines"] = len(f.read().splitlines())
        report["prob_row_sum_max_abs_err"] = float(
            np.abs(probs.sum(-1) - 1).max())
        _, classify_launches = counted(
            lambda: a.model.classify_frames(crops[None, :API_BATCH]),
            expected_launches(0, 1))
        fx = api.FeatureExtractor(config=cfg, state_dict=state,
                                  device="cuda")
        feats = np.load(fx.extract(path))
        with torch.no_grad():
            dev = torch.from_numpy(crops).cuda().float()
            per_batch = torch.cat([fx.model.embed_frames(
                preprocess.pad_short_clip(piece, API_BATCH)[None])[0, :len(
                    piece)] for piece in dev.split(API_BATCH)])
            # one call of 300 frames: cuDNN's bf16 layers 1, 3 and 4 may
            # pick other algorithms at another batch, so bf16 rounding
            # differs (the kernels at N = 300 are held against their plain
            # versions in check_small_shapes)
            whole = fx.model.embed_frames(dev[None])[0]
        report["features_vs_embed_frames_max_rel"] = max_rel(feats,
                                                             per_batch)
        report["features_vs_one_call_max_rel"] = max_rel(feats, whole)
    print(json.dumps(report), flush=True)
    if not (acc.shape == (API_T, 2) and np.isfinite(acc).all()
            and report["accumulated_vs_from_crops_max_rel"]
            <= SAME_SHAPE_REL_TOL
            and report["streamed_vs_long_clip_max_rel"] < STREAM_REL_TOL
            and series.shape == (API_T, 2) and probs.shape == (API_T, 8)
            and report["prob_row_sum_max_abs_err"] <= PROB_SUM_TOL
            and report["csv_lines"] == 1 + API_T
            and feats.shape == (API_T, 2048)
            and report["features_vs_embed_frames_max_rel"]
            <= SAME_SHAPE_REL_TOL
            and report["features_vs_one_call_max_rel"] < EMB_REL_TOL):
        raise AssertionError(f"api phase: {report}")
    return classify_launches


def check_api_video(model: Mimamo, state: dict, line: str) -> None:
    """A 120-frame 640 x 360 video with a boxes sidecar through
    ``MimamoAPI.predict`` and ``VideoProcessor.process``; only where OpenCV
    imports (it decodes and encodes the file)."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        print(json.dumps({"api_video": "skipped: no cv2"}), flush=True)
        return
    from mimamo_tpu_torch.io import decode
    frames, boxes, _ = video_source(120, 360, 640, SEED + 5)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.mp4")
        decode.write_video(path, frames)
        np.save(path + ".boxes.npy", boxes)
        a = api.MimamoAPI(config=model.config, state_dict=state,
                          device="cuda")
        t = time.perf_counter()
        series = a.predict(path)
        wall = time.perf_counter() - t
        decoded = decode.decode_video(path)
        rel = max_rel(series, a.model.predict_video(decoded, boxes))
        out = api.VideoProcessor(save_size=S, config=model.config,
                                 device="cuda").process(path, tmp)
        crops = np.load(out)
        want = a.model.crop_video_chunked(decoded, boxes).cpu().numpy()
        lsb = int(np.abs(crops.astype(int) - np.rint(want)).max())
    report = {"api_video_frames": 120, "predict_ms": wall * 1e3,
              "series_vs_predict_video_max_rel": rel,
              "processor_crops_max_lsb": lsb, "card": line}
    print(json.dumps(report), flush=True)
    if not (series.shape == (120, 2) and np.isfinite(series).all()
            and rel <= SAME_SHAPE_REL_TOL and crops.shape == (120, S, S, 3)
            and crops.dtype == np.uint8 and lsb <= 1):
        raise AssertionError(f"api_video phase: {report}")


def check_stem_f32(crops: torch.Tensor, model: Mimamo) -> dict:
    """The fp32 stem kernel against its plain version (TF32 off) at the
    flagship step, at the api phase's frame counts (64, 256, 300) and at
    small ragged shapes (34^2 with an odd pooled-row count, 5 x 112^2, the
    widest crop the form takes, 128^2, and the narrowest, 8^2); its times
    and the bounds of both designs the kernel could have (fp32 FMAs, which
    it uses, and 3xTF32 tensor-core products)."""
    w2, bias = model._backbone_folded().stem
    if w2.dtype != torch.float32:
        raise AssertionError(f"the default config's stem is {w2.dtype}")
    mean = model.config.backbone.mean_rgb
    got = stem_kernel.stem_fused(crops, w2, bias, mean)
    want = stem_kernel.stem_plain(crops, w2, bias, mean)
    errs = {"flagship": errors(got, want)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for n, s in ((API_BATCH, S), (API_CHUNK, S), (API_T, S), (3, 34), (5, S),
                 (2, stem_kernel.MAX_CROP_F32), (2, 8)):
        c = torch.rand((n, s, s, 3), device="cuda", generator=gen) * 255
        errs[f"n{n}_s{s}"] = errors(stem_kernel.stem_fused(c, w2, bias, mean),
                                    stem_kernel.stem_plain(c, w2, bias, mean))
    del c
    print(json.dumps({"stem_f32_err": errs, "plain_max_abs":
                      want.abs().max().item(), "tol": [STEM_F32_REL_TOL,
                                                       STEM_F32_ATOL]}),
          flush=True)
    if not all(e["max_rel_err"] <= STEM_F32_REL_TOL
               and e["max_abs_err"] <= STEM_F32_ATOL for e in errs.values()):
        raise AssertionError(f"fp32 stem kernel: {errs}")
    k = w2.reshape(7, 7, 3, 64).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)

    def library():
        x = for_backbone(crops, model.config.backbone)
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k, bias,
                                       stride=2, padding=3)
        return torch.nn.functional.max_pool2d(torch.relu(y), 3, 2, 1)

    n = crops.shape[0]
    nbytes = crops.numel() * 4 + got.numel() * 4
    flops = 2.0 * n * S * S * 64 * 147
    print(json.dumps({"stem_f32_bound_ms": {
        "ffma": bound_ms(nbytes, flops, PEAK_FP32_FLOP_PER_S)[0],
        "3xtf32": bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)[0],
        "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}}), flush=True)
    return record(
        "stem_fused[f32]", "mimamo_tpu_torch/csrc/stem.cu",
        "mimamo_tpu/pallas/stem_kernel.py:153", errs["flagship"],
        {"tol_max_rel": STEM_F32_REL_TOL, "tol_abs": STEM_F32_ATOL},
        time_ms(lambda: stem_kernel.stem_fused(crops, w2, bias, mean)),
        time_ms(lambda: stem_kernel.stem_plain(crops, w2, bias, mean)),
        nbytes, flops, time_ms(library), PEAK_FP32_FLOP_PER_S)


def check_fp32(state: dict, clips: np.ndarray, small_cpu: tuple,
               line: str) -> tuple:
    """``Mimamo(MimamoConfig())``, the default fp32 backbone, through
    ``predict_clips`` at the flagship step: shape, finite values, launches
    (phase 1, fp32 stem 1, layer2 kernel 0: fp32 layer2 runs on cuDNN),
    frames/s and the stage split, and the card against the CPU's fp32
    forward on one clip x 8 frames. Returns (model, launches)."""
    model = Mimamo(MimamoConfig())                       # on the card
    model.load_state_dict(state)
    model.predict_clips(clips)                           # warm-up
    torch.cuda.synchronize()
    out, launches = counted(lambda: model.predict_clips(clips),
                            expected_launches(fp32=True))
    if tuple(out.shape) != (B, T, 2) or not torch.isfinite(out).all():
        raise AssertionError(f"fp32 predict_clips gave {tuple(out.shape)}")
    times = []
    for _ in range(5):
        t = time.perf_counter()
        model.predict_clips(clips)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    step = statistics.median(times)
    stages = median_stages([stage_breakdown(model, clips) for _ in range(3)])
    rates = {name: flops / (stages["layer2_cudnn" if name == "layer2"
                                   else name] * 1e-3) / 1e12
             for name, flops in conv_flops(B * T).items()}
    # what keeping TF32 off costs: the same step with cuDNN's TF32 on (a
    # yardstick only; the port keeps it off)
    torch.backends.cudnn.allow_tf32 = True
    try:
        model.predict_clips(clips)
        tf32 = []
        for _ in range(5):
            t = time.perf_counter()
            model.predict_clips(clips)
            torch.cuda.synchronize()
            tf32.append(time.perf_counter() - t)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    small = clips[:1, :8]
    with torch.no_grad():
        card_out = model.predict_clips(small).cpu()
        card_emb = model.embed_frames(torch.from_numpy(small).cuda().float()
                                      ).cpu()
    cpu_out, cpu_emb = small_cpu
    report = {"fp32_frames_per_s": B * T / step, "fp32_step_ms": step * 1e3,
              "fp32_steps_ms": [x * 1e3 for x in times],
              "fp32_stage_ms": stages,
              "fp32_stage_sum_ms": sum(stages.values()),
              "fp32_conv_tflop_per_s": rates,
              "fp32_step_ms_cudnn_tf32_on": statistics.median(tf32) * 1e3,
              "fp32_launches": launches,
              "fp32_card_vs_cpu_emb_max_rel": max_rel(card_emb, cpu_emb),
              "fp32_card_vs_cpu_out_max_rel": max_rel(card_out, cpu_out),
              "tol": [FP32_EMB_REL_TOL, FP32_OUT_REL_TOL], "card": line}
    print(json.dumps(report), flush=True)
    if not (report["fp32_card_vs_cpu_emb_max_rel"] <= FP32_EMB_REL_TOL
            and report["fp32_card_vs_cpu_out_max_rel"] <= FP32_OUT_REL_TOL):
        raise AssertionError("fp32: card and CPU disagree beyond tolerance")
    return model, launches


def conv_flops(frames: int, size: int = 2 * S) -> dict:
    """Operations of the convs of ResNet-50 layers 1-4 over ``frames``
    frames of ``size``^2 (stride in the first 1x1 of a stage's block 0):
    2 per multiply-add."""
    out, inplanes, side = {}, 64, size // 4
    for i, (blocks, width) in enumerate(zip((3, 4, 6, 3),
                                            (64, 128, 256, 512))):
        side = side if i == 0 else side // 2
        macs = 0
        for b in range(blocks):
            cin = inplanes if b == 0 else 4 * width
            macs += side * side * (cin * width + 9 * width * width
                                   + 4 * width * width)
            if b == 0:
                macs += side * side * cin * 4 * width
        inplanes = 4 * width
        out[f"layer{i + 1}"] = 2.0 * macs * frames
    return out


def _train_model(state: dict, device="cuda", **train_kw):
    cfg = dataclasses.replace(MimamoConfig(), train=TrainSpec(**train_kw))
    model = Mimamo(cfg, device=device)
    model.load_state_dict(state)
    return model, train.create_train_state(model), train.make_train_step(model)


def step_ms(step, st, batch, n: int) -> list:
    """Wall times (ms) of ``n`` synchronised train steps."""
    times = []
    for _ in range(n):
        t = time.perf_counter()
        step(st, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def state_diff(a: dict, b: dict, keys=None) -> float:
    """max |a - b| over the entries ``keys`` (default: all) of two
    state_dicts."""
    keys = a.keys() if keys is None else keys
    return max((a[k].float() - b[k].float().to(a[k].device)).abs().max()
               .item() for k in keys)


def step_vs_cpu(state: dict, batch: dict) -> dict:
    """One frozen step on the card and on the CPU from the same weights on
    ``batch``: loss, each temporal gradient (max |d| / its max |g|), the
    temporal BN running stats, and the parameters whose gradient is well
    above rounding noise (|g| >= 1e-3 of its tensor's largest: Adam's first
    update moves the others by up to lr either way)."""
    runs = []
    for device in ("cuda", "cpu"):
        model, st, step = _train_model(state, device)
        _, metrics = step(st, batch)
        grads = {n: p.grad.detach().cpu() for n, p in
                 model.temporal.named_parameters()}
        runs.append((float(metrics["loss"]), grads,
                     {k: v.cpu() for k, v in model.temporal.state_dict()
                      .items()}))
    (loss_c, g_c, sd_c), (loss_h, g_h, sd_h) = runs
    sure = {k: g.abs() >= 1e-3 * g.abs().max() for k, g in g_h.items()}
    return {
        "loss_abs": abs(loss_c - loss_h),
        "grad_rel": max(((g_c[k] - g).abs().max() / g.abs().max()).item()
                        for k, g in g_h.items()),
        "bn_stats_abs": state_diff(sd_c, sd_h, [k for k in sd_h
                                                if "running" in k]),
        "params_abs": max((sd_c[k] - sd_h[k]).abs()[sure[k]].max().item()
                          for k in g_h)}


def check_train(state: dict, line: str) -> dict:
    """The training path under the default config (fp32 backbone at 224,
    48-frame clips, ``TrainSpec()`` batch 4) on a synthetic Aff-Wild2
    corpus of 112^2 crops: ``train.fit`` for one epoch with eval and
    checkpoints; 20 frozen steps on one batch at lr 1e-3 lower the loss
    and leave the backbone as it was; the launches of one frozen step; a
    frozen online step against the same step on cached features and
    against the CPU (1 clip x 8 frames); 2 fine-tuning steps with
    ``remat_backbone``; save, restore and ``MimamoAPI(checkpoint_dir=...)``;
    ``evaluate_affwild2``; the step times. Returns the launches of one
    frozen step."""
    report = {"card": line}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "aff")
        datasets.make_synthetic_affwild2(root, n_videos=2, frames=TRAIN_T,
                                         size=S, seed=SEED)
        cfg = MimamoConfig()
        ds = datasets.AffWild2Dataset(root, clip=cfg.clip)
        ckpt = os.path.join(tmp, "ckpt")
        t = time.perf_counter()
        _, rows = train.fit(cfg, ds, ckpt=ckpt, eval_dataset=ds, epochs=1)
        report["fit_s"] = time.perf_counter() - t
        report["fit_rows"] = rows
        fit_ok = (rows[0]["steps"] == len(ds) // cfg.train.batch_size > 0
                  and np.isfinite(rows[0]["loss"]) and rows[0].get("best")
                  and np.isfinite(rows[0]["val_mean_ccc"])
                  and train_ckpt_ok(ckpt, rows[0]["steps"]))
        batch = next(ds.batches(cfg.train.batch_size))

        model, st, step = _train_model(state, learning_rate=1e-3)
        backbone0 = {k: v.clone() for k, v in
                     model.backbone.state_dict().items()}
        losses = [float(step(st, batch)[1]["loss"])]        # warm-up
        (_, first), launches = counted(lambda: step(st, batch),
                                       expected_launches(fp32=True))
        losses += [float(first["loss"])] + [
            float(step(st, batch)[1]["loss"]) for _ in range(18)]
        report["fixed_batch_losses"] = losses
        report["backbone_moved_by_frozen_steps"] = state_diff(
            model.backbone.state_dict(), backbone0)
        report["frozen_step_launches"] = launches

        online, st_o, step_o = _train_model(state)
        cached, st_c, step_c = _train_model(state)
        with torch.no_grad():
            feats = cached.embed_frames(
                torch.from_numpy(batch["clips"]).cuda()).cpu().numpy()
        m_o = step_o(st_o, batch)[1]
        m_c = step_c(st_c, dict(batch, features=feats))[1]
        report["online_vs_cached"] = {
            "loss_abs": abs(float(m_o["loss"]) - float(m_c["loss"])),
            "temporal_abs": state_diff(online.temporal.state_dict(),
                                       cached.temporal.state_dict())}
        report["card_vs_cpu_step"] = step_vs_cpu(state, {
            k: v[:1, :8] for k, v in batch.items()})
        report["step_ms"] = {
            "frozen_online": step_ms(step_o, st_o, batch, 5),
            "cached_features": step_ms(step_c, st_c,
                                       dict(batch, features=feats), 5)}

        fine, st_f, step_f = _train_model(state, freeze_backbone=False,
                                          remat_backbone=True)
        before = fine.predict_clips(batch["clips"])
        bb0 = {k: v.clone() for k, v in fine.backbone.state_dict().items()}
        torch.cuda.reset_peak_memory_stats()
        ft_losses = [float(step_f(st_f, batch)[1]["loss"]) for _ in range(2)]
        report["finetune_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        after = fine.predict_clips(batch["clips"])
        bb1 = fine.backbone.state_dict()
        refit = Mimamo(fine.config)
        refit.load_state_dict(fine.state_dict())
        report["finetune"] = {
            "losses": ft_losses,
            "weights_moved": state_diff(bb1, bb0, [k for k in bb0 if
                                                   "running" not in k
                                                   and "num_b" not in k]),
            "bn_stats_moved": state_diff(bb1, bb0, [k for k in bb0
                                                    if "running" in k]),
            "predict_before_vs_after_max_rel": max_rel(after, before),
            "predict_vs_refolded_max_rel": max_rel(
                after, refit.predict_clips(batch["clips"]))}
        del refit
        report["step_ms"]["finetune_remat"] = step_ms(step_f, st_f, batch, 3)

        saved = os.path.join(tmp, "saved")
        checkpoints.save(saved, st_f)
        checkpoints.save_backbone_meta(saved, fine.config.backbone.mean_rgb,
                                       fine.config.backbone.channel_order)
        fresh, st_r, _ = _train_model(weights.init_variables(
            fine.config, SEED + 1), freeze_backbone=False)
        checkpoints.restore(saved, st_r)
        a = api.MimamoAPI(config=fine.config, checkpoint_dir=saved,
                          device="cuda")
        small = batch["clips"][:1, :8]
        report["restore"] = {
            "step": st_r.step, "weights_abs": state_diff(
                fresh.state_dict(), fine.state_dict()),
            "api_weights_abs": state_diff(a.model.state_dict(),
                                          fresh.state_dict()),
            "api_vs_restored_max_rel": max_rel(
                a.model.predict_clips(small), fresh.predict_clips(small))}
        ev = evaluate_affwild2(fine, ds, chunk=cfg.clip.clip_len)
        report["evaluate_affwild2"] = ev
    report["step_ms_median"] = {k: statistics.median(v) for k, v in
                                report["step_ms"].items()}
    print(json.dumps(report), flush=True)
    cmp_, ft, rs = (report["card_vs_cpu_step"], report["finetune"],
                    report["restore"])
    if not (fit_ok and losses[-1] < losses[0]
            and report["backbone_moved_by_frozen_steps"] == 0.0
            and report["online_vs_cached"]["loss_abs"] <= CACHED_TOL
            and report["online_vs_cached"]["temporal_abs"] <= CACHED_TOL
            and cmp_["loss_abs"] <= STEP_LOSS_ATOL
            and cmp_["grad_rel"] <= STEP_GRAD_REL_TOL
            and cmp_["bn_stats_abs"] <= STEP_BN_ATOL
            and cmp_["params_abs"] <= STEP_PARAM_ATOL
            and all(np.isfinite(ft["losses"])) and ft["weights_moved"] > 0
            and ft["bn_stats_moved"] > 0
            and ft["predict_before_vs_after_max_rel"] > 0
            and ft["predict_vs_refolded_max_rel"] <= SAME_SHAPE_REL_TOL
            and rs["step"] == st_f.step and rs["weights_abs"] == 0.0
            and rs["api_weights_abs"] == 0.0
            and rs["api_vs_restored_max_rel"] == 0.0
            and all(np.isfinite(ev[k]) for k in ("valence_ccc",
                                                 "arousal_ccc"))):
        raise AssertionError(f"train phase: {report}")
    return launches


def train_ckpt_ok(ckpt: str, steps: int) -> bool:
    """``fit`` left the epoch's checkpoint, the best-val one, both with
    their backbone meta, and the metrics file."""
    return (checkpoints.latest_step(ckpt) == steps
            and checkpoints.latest_step(ckpt + "_best") == steps
            and checkpoints.load_backbone_meta(ckpt) is not None
            and checkpoints.load_backbone_meta(ckpt + "_best") is not None
            and os.path.exists(ckpt + ".metrics.jsonl"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    line = card()
    print(line, flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "library": str(lib)}), flush=True)
    print(lib.with_suffix(".log").read_text(), file=sys.stderr)

    cfg = MimamoConfig(backbone=BackboneSpec(dtype="bfloat16"))
    state = weights.init_variables(cfg, SEED)
    model = Mimamo(cfg)                                  # on the card
    model.load_state_dict(state)
    rng = np.random.default_rng(SEED)
    clips = rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
    crops = torch.from_numpy(clips).cuda().float()

    with torch.no_grad():
        check_small_shapes(model)
        check_phase_shapes(cfg, to_grayscale(crops))
        recs = [check_phase(to_grayscale(crops), cfg),
                check_stem(crops.reshape(B * T, S, S, 3), model),
                check_layer2(crops.reshape(B * T, S, S, 3), model)]
    del crops
    torch.cuda.empty_cache()

    # -- the main path -----------------------------------------------------
    model.predict_clips(clips)                           # warm-up
    torch.cuda.synchronize()
    out, launches = counted(lambda: model.predict_clips(clips))
    if tuple(out.shape) != (B, T, 2) or not torch.isfinite(out).all():
        raise AssertionError(f"predict_clips gave {tuple(out.shape)}, "
                             f"finite={bool(torch.isfinite(out).all())}")
    step_times = []
    for _ in range(5):
        t = time.perf_counter()
        model.predict_clips(clips)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t)
    step = statistics.median(step_times)
    print(json.dumps({"predict_clips_frames_per_s": B * T / step,
                      "step_ms": step * 1e3, "steps_ms":
                      [s * 1e3 for s in step_times], "card": line}),
          flush=True)
    stages = median_stages([stage_breakdown(model, clips) for _ in range(3)])
    print(json.dumps({"stage_ms": stages,
                      "stage_sum_ms": sum(stages.values()),
                      "card": line}), flush=True)

    # -- the streaming path and the windowed path ---------------------------
    feed_launches = check_streaming(model, clips, line)
    crops_launches = check_from_crops(model, line)

    # -- the video path and the user API -------------------------------------
    video_launches = check_video(model, line)
    classify_launches = check_api(model, state, line)
    check_api_video(model, state, line)
    for rec in recs:
        rec["launches"] = launches[rec["name"]]
        rec["launches_stream_feed"] = feed_launches[rec["name"]]
        rec["launches_from_crops"] = crops_launches[rec["name"]]
        rec["launches_predict_video"] = video_launches[rec["name"]]
        rec["launches_classify_frames"] = classify_launches[rec["name"]]

    # -- the same weights on the CPU, one clip x 8 frames --------------------
    small = clips[:1, :8]
    with torch.no_grad():
        card_out = model.predict_clips(small).cpu()
        card_emb = model.embed_frames(
            torch.from_numpy(small).cuda().float()).cpu()
    cpu = Mimamo(MimamoConfig(), device="cpu")           # fp32 reference
    cpu.load_state_dict(state)
    with torch.no_grad():
        cpu_out = cpu.predict_clips(small)
        cpu_emb = cpu.embed_frames(torch.from_numpy(small).float())
    del cpu
    emb_rel, out_rel = max_rel(card_emb, cpu_emb), max_rel(card_out, cpu_out)
    print(json.dumps({"card_vs_cpu_emb_max_rel": emb_rel,
                      "card_vs_cpu_out_max_rel": out_rel,
                      "tol": [EMB_REL_TOL, OUT_REL_TOL]}), flush=True)
    if not (emb_rel < EMB_REL_TOL and out_rel < OUT_REL_TOL):
        raise AssertionError("card and CPU disagree beyond tolerance")
    del model
    torch.cuda.empty_cache()

    # -- the default config: fp32 backbone ------------------------------------
    model32, fp32_launches = check_fp32(state, clips, (cpu_out, cpu_emb), line)
    with torch.no_grad():
        stem_rec = check_stem_f32(
            torch.from_numpy(clips).cuda().float().reshape(B * T, S, S, 3),
            model32)
    del model32
    torch.cuda.empty_cache()

    # -- the training path ------------------------------------------------------
    train_launches = check_train(state, line)
    recs.append(stem_rec)
    for rec in recs:
        rec["launches_fp32_forward"] = fp32_launches[rec["name"]]
        rec["launches_train_step"] = train_launches[rec["name"]]
    stem_rec["launches"] = fp32_launches["stem_fused[f32]"]

    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
