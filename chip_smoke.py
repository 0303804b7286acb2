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
     event-timed batches of 10 back-to-back calls, after 2 warm-up calls.
     ``epilogue``: the epilogue of the backbone's cuDNN convs at every
     launch of one backbone call, bf16 at B x T frames and fp32 at 4 x T
     (the benchmark's batches): each launch ``torch.equal`` to its plain
     version and to PyTorch's bias add, relu and residual add on the same
     raw conv output (and no element whose bits differ), each block to
     ``bottleneck_library``; each launch's time, byte bound and PyTorch's
     time, and their sums over a call (record ``bottleneck_epilogue`` at
     layer1's conv3);
     ``fft_invariance``: the phase stage gives a frame the same bits
     whatever batch it arrives in (``bench/fft_invariance.py``: 384 seeded
     crops, each of 3 frames at 4 positions of batches of 1 to 384
     frames; the grey frames, the forward FFT, each scale's inverse and the
     bands end to end, and the phase stacks of an 8 x 48 clip against its
     streamed chunks), bit for bit: any unequal element fails;
  3. drives ``Mimamo.predict_clips`` at the flagship shape with random
     weights from a seed, checks shape and finiteness, and checks that
     every kernel was launched on that run (phase 1: all scales in one
     launch; stem 1; layer2 4 per forward: one launch per bottleneck
     block; the epilogue 36: three per block of layers 1, 3 and 4; 48 in
     fp32, 39 under the torchvision placement);
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
     frames; the fp32 stem kernel (3xTF32 on the tensor cores) against its
     plain version (TF32 off) at the flagship shape, N = 64, 256, 300 and
     small ragged shapes, its times, its 3xTF32 bound and the bound of an
     fp32 FMA design;
 10. ``train``: the default config on a synthetic Aff-Wild2 corpus of
     112^2 crops (2 videos of 120 frames): ``train.fit`` for one epoch
     with eval and checkpoints, 20 frozen steps on one batch at lr 1e-3
     (the loss falls, the backbone stays bit-equal), the launches of one
     frozen step, that step against cached features and against the CPU
     (1 clip x 8 frames), 2 fine-tuning steps with ``remat_backbone``
     (the weights, the BN stats and ``predict_clips`` move), save /
     restore / ``MimamoAPI(checkpoint_dir=...)``, ``evaluate_affwild2``,
     and the step times;
 11. ``serve``, ``cli`` and ``corpus`` (they need OpenCV): three seeded
     640 x 360 videos of 120, 72 and 30 frames with box and eye-point
     sidecars. ``serve``: ``serve.run`` on a thread of this process over a
     pipe, bf16, capacity 8 x chunk 16, uint8 streams: ping, 8 opens, 10
     ``stream_feed_multi`` requests against a ``StreamingSession`` fed the
     same chunks (<= 1e-6) with the launches of one request and the
     latency per request; 10 more with a ``predict`` of the 120-frame
     video in flight (feeds answered before it, its series against
     ``MimamoAPI.predict`` alone); ``python -m mimamo_tpu_torch.cli serve``
     as a subprocess. ``cli``: ``cli.main`` at the default fp32 config:
     ``predict`` of the video and of 300 crops against ``MimamoAPI``
     (<= 1e-6, with launch counts), ``extract`` against ``VideoProcessor``
     and ``FeatureExtractor``, ``eval --batch-streams 8`` against 1 (<
     1e-4), ``train`` for one epoch and its checkpoint restored, ``train
     --tensorboard`` and ``train --debug-nans`` (item 17).
     ``corpus``: ``predict-corpus`` with the Python loader and, where
     ``io.native_loader`` builds the native library at first use, the
     native one (the build's outcome reported either way; each run's
     summary names its loader), a resumed run, and ``--align`` against
     ``cli predict --align`` per video (<= 1e-6), frames/s;
 12. ``probes``: the layer1 and layer2 probes through their entry points
     (``python -m mimamo_tpu_torch.bench.layer1_probe`` / ``layer2_probe``
     at 384 frames, one timed batch each, the layer2 probe's three variants
     checked against cuDNN at 4 frames), with the launch counts of that
     run; the dots kernels (``layer1_dots``, the layer2 probe's dots-only
     block) against their plain versions at 384, 1 and 3 frames (max-rel <
     2e-2, finite everywhere), their times, bounds and the same dot
     sequence as bf16 ``torch.matmul`` calls (the yardstick); the cuDNN
     layer1 stage against the dots kernel;
 13. ``crops``: crop sizes past the kernels' old caps, 128, 160, 200 and
     224 (the stem and layer2 kernels cut wide crops into column tiles):
     at each, ``predict_clips`` of one clip x 8 frames in fp32 on the card
     against the CPU (the ``fp32`` phase's gates) and in bf16 (finite),
     each with its launch counts (fp32: phase 1, fp32 stem 1; bf16: phase
     1, stem 1, layer2 4); the phase kernel on that clip; the bf16 and
     fp32 stem kernels and layer2 against their plain versions at 8 x 48
     frames of the crop (every layer2 width ends in a partial 30-column
     tile), with times and bounds as records ``<kernel>@<crop>`` in the
     ``kernels`` line; the stem kernels at uneven (202) and three (264,
     fp32) column tiles;
 14. ``convert``: ``python -m mimamo_tpu_torch.cli convert --verify`` on
     the card of a seeded ResNet-50 ``.pth`` under the FER+ ``dag`` names
     (with MatConvNet meta) and a seeded two-stream ``.pth`` (the source
     forwarded by ``torch_ref`` on the CPU against the converted model on
     the card), then ``cli predict --crops --ckpt`` on the card against
     ``--cpu`` and the checkpoint's embeddings card against CPU, at the
     ``fp32`` phase's gates, with the launches of the card's predict;
 15. ``variants``: the model variants (``VARIANTS``: micro-only and
     macro-only streams, 2 GRU layers, snippets of 4, appearance stride 2,
     a backbone input of 112 for crops of 112) through ``predict_clips`` at
     the flagship step in bf16 and fp32: finite values, the launches of one
     forward (no phase kernel without the micro stream, no stem or layer2
     without the macro one, no stem kernel at a backbone input other than
     twice the crop), the frames reaching the stem and layer2 (B x T / k at
     stride k), step and backbone times; the fp32 card against the CPU on
     one clip x 8 frames (the ``fp32`` phase's gates); the fp32 streaming
     path at 2 GRU layers and at stride 2 (:func:`variant_stream`: the
     chunks' phase stacks equal the whole clip's, no value jumps, and the
     outputs hold their gates; only against the CPU's FFT may a phase
     difference land on the other side of the +-pi wrap);
     layer2 against its plain
     version on the 14 x 14 grid of the 112 backbone input;
 16. ``parallel``: data parallelism over ``torch.distributed``. A world of
     one over NCCL on the card: ``cli train --data-parallel --coordinator
     127.0.0.1:0 --num-processes 1 --process-id 0`` on a seeded synthetic
     Aff-Wild2 corpus at the default fp32 config against plain ``cli
     train``, both on deterministic algorithms (rows and checkpoint within
     1e-6); ``predict_batch`` of 7
     clips against ``predict_clips`` in bf16 and fp32 (within 1e-6), and
     the step and ``predict_batch`` times at a world of one beside the plain
     ones (the cost of forming the group: every collective takes the local
     path). Two ranks sharing the card over gloo, all started at once
     through ``dryrun``'s launcher: the dry run (both ranks finish with
     identical parameters after each step, each step's loss within 1e-5 of
     a world-one step over the same global batch, the fine-tune step's
     gradient as a whole, every check within its bound; its rank 0 counts
     the launches of its train step and of its ``predict_batch`` per
     dtype); ``cli train --data-parallel`` at the default fp32 config
     against one process stepping the union of the two ranks' slices
     (:func:`check_train_ranks`: rows, Adam's moments, BN stats, one log
     row written by rank 0); ``cli eval --data-parallel`` against one
     process (within 1e-6); ``cli predict-corpus --data-parallel`` over the
     ``serve`` phase's 3 videos (disjoint videos, a manifest each; the CSVs
     of one process within 1e-6); whether each rank's phase stacks equal
     one process's over the union batch, printed beside Adam's cosine;
 17. ``a16b``: the JAX package's last modules. The torchvision stride
     placement (``FoldedResNet50(stride_in_1x1=False)``) in bf16 at B x T
     frames: one backbone call launches the stem once and layer2 3 times
     (block 0 strides its 3x3 conv, a function the kernel does not compute,
     and runs as cuDNN convs), the layer2 kernel's stride-1 tail against
     ``layer2_plain`` (record ``layer2_tail``), the backbone's time beside
     the default placement's, and in fp32 the card against the CPU on one
     clip x 8 frames (the ``fp32`` phase's gates). bf16 fine-tuning at the
     default geometry (4 x 48 frames, remat): one step against the fp32
     step on the same batch (the backbone gradient by direction and norm),
     2 steps move the weights and BN stats, ``predict_clips`` of the
     refolded weights (phase 1, stem 1, layer2 4), step times and peak
     memory of both dtypes. ``pyramid.build`` -> ``reconstruct`` on B x T
     frames (rel-err < 1e-3), the pyramid card against CPU. Both examples
     (``python -m mimamo_tpu_torch.examples.demo`` / ``serve_client``) as
     processes on the card: exit 0 and their files. (The ``cli`` phase runs
     ``train --tensorboard``, its scalars read back against the printed
     rows, and ``train --debug-nans``: against the plain run, the checked
     step's time beside the plain step's, a planted NaN raising
     ``FloatingPointError``.)
 18. prints ``{"kernels": [...]}`` (``max_rel_err``, ``max_abs_err`` and the
     gate's bound under ``tol_max_rel`` or ``tol_abs``, the launch counts of
     each path, each variant's under ``launches_variant_<name>``, rank 0's
     of 2 under ``launches_parallel_train`` and
     ``launches_parallel_predict_batch``, the stride variant's backbone call
     under ``launches_stride_variant``, ``predict_clips`` after a bf16
     fine-tune under ``launches_finetune_bf16_predict``)
     and, last, the device line.

Any failure exits non-zero. Needs one CUDA card; imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mimamo_tpu_torch import (StreamingSession, api, checkpoints, dryrun,
                              parallel, phase, preprocess, pyramid, summary,
                              tracing, train, weights)
from mimamo_tpu_torch.backbone import (FoldedResNet50, ResNet50,
                                       fold_batchnorm)
from mimamo_tpu_torch.bench import fft_invariance, layer1_probe, layer2_probe
from mimamo_tpu_torch.bench.dots_variants import ptxas_report
from mimamo_tpu_torch.bench._timing import (PEAK_BF16_FLOP_PER_S,
                                            PEAK_BYTES_PER_S,
                                            PEAK_FP32_FLOP_PER_S,
                                            PEAK_TF32_FLOP_PER_S, card,
                                            max_rel, time_ms)
from mimamo_tpu_torch.config import (BackboneSpec, ClipSpec, MimamoConfig,
                                     PyramidSpec, TemporalSpec, TrainSpec)
from mimamo_tpu_torch.data import datasets
from mimamo_tpu_torch.data.eval import evaluate_affwild2
from mimamo_tpu_torch.kernels import (_build, bottleneck_epilogue,
                                      dots_block, layer1_dots_kernel,
                                      layer2_dots_kernel, layer2_kernel,
                                      phase_kernel, stem_kernel)
from mimamo_tpu_torch.kernels.layer2_kernel import C_IN, OUT_W, WIDTH
from mimamo_tpu_torch.preprocess import (for_backbone,
                                         merge_window_predictions,
                                         pad_short_clip, to_grayscale,
                                         window_starts)
from mimamo_tpu_torch.runner import Mimamo

B, T, S = 8, 48, 112          # flagship step: 384 frames of 112^2 crops
CAPACITY, CHUNK = 8, 16       # streaming step: 8 slots x 16 frames a feed
SEED = 0
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


def check_fft_invariance(cfg: MimamoConfig, line: str) -> dict:
    """``fft_invariance.check`` on B x T seeded crops at the flagship's
    pyramid and phase (docstring item 2): prints the counts, raises on any
    element that is not bitwise equal."""
    rgb = fft_invariance.crops(B * T, S, "cuda")
    report = fft_invariance.check(rgb, cfg.pyramid, cfg.phase)
    print(json.dumps({"fft_invariance": report, "fft_group": None,
                      "fft_calls_per_forward": 1 + cfg.pyramid.height,
                      "card": line}), flush=True)
    if not report["equal"]:
        raise AssertionError(f"the phase stage depends on the batch: "
                             f"{report}")
    return report


def stem_work(crops: torch.Tensor, out: torch.Tensor) -> tuple:
    """Bytes the stem must move (the crops read once, the pooled map
    written once) and conv1's products: 147 MACs per conv pixel (S x S of
    them) and output channel."""
    n, s = crops.shape[:2]
    return (crops.numel() * 4 + out.numel() * out.element_size(),
            2.0 * n * s * s * 64 * 147)


def stem_record(crops: torch.Tensor, model: Mimamo, name: str,
                plain_batch: int = 10) -> dict:
    """The stem kernel of the model's dtype on ``crops`` [N, S, S, 3]:
    against its plain version at the gate of its dtype (bf16 max-rel <
    BF16_REL_TOL; fp32 max-rel <= STEM_F32_REL_TOL and max |d| <=
    STEM_F32_ATOL), its time, the plain version's and the library call's
    (upscale + cuDNN conv + pool in the same dtype; the fp32 one with TF32
    off), and its bound: bf16 products at the bf16 peak, fp32 ones as
    3xTF32 (three products each) at the TF32 peak."""
    w2, bias = model._backbone_folded().stem
    mean = model.config.backbone.mean_rgb
    f32 = w2.dtype == torch.float32
    got = stem_kernel.stem_fused(crops, w2, bias, mean)
    want = stem_kernel.stem_plain(crops, w2, bias, mean)
    errs = errors(got, want)
    if f32:
        tols = {"tol_max_rel": STEM_F32_REL_TOL, "tol_abs": STEM_F32_ATOL}
        ok = (errs["max_rel_err"] <= STEM_F32_REL_TOL
              and errs["max_abs_err"] <= STEM_F32_ATOL)
    else:
        tols = {"tol_max_rel": BF16_REL_TOL}
        ok = errs["max_rel_err"] < BF16_REL_TOL
    if not ok:
        raise AssertionError(f"{name} at {tuple(crops.shape)}: {errs}, "
                             f"gates {tols}")
    k = w2.float().reshape(7, 7, 3, 64).permute(3, 2, 0, 1).to(
        w2.dtype).contiguous(memory_format=torch.channels_last)
    bias_lib = bias.to(w2.dtype)

    def library():
        x = for_backbone(crops, model.config.backbone).to(w2.dtype)
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k, bias_lib,
                                       stride=2, padding=3)
        return torch.nn.functional.max_pool2d(torch.relu(y), 3, 2, 1)

    nbytes, flops = stem_work(crops, got)
    del got, want
    return record(
        name, "mimamo_tpu_torch/csrc/stem.cu",
        "mimamo_tpu/pallas/stem_kernel.py:153", errs, tols,
        time_ms(lambda: stem_kernel.stem_fused(crops, w2, bias, mean)),
        time_ms(lambda: stem_kernel.stem_plain(crops, w2, bias, mean),
                batch=plain_batch),
        nbytes, 3 * flops if f32 else flops, time_ms(library),
        PEAK_TF32_FLOP_PER_S if f32 else PEAK_BF16_FLOP_PER_S)


def check_stem(crops: torch.Tensor, model: Mimamo) -> dict:
    return stem_record(crops, model, "stem_fused")


def check_layer2(crops: torch.Tensor, model: Mimamo,
                 name: str = "layer2_fused", plain_batch: int = 10) -> dict:
    """layer2 on the layer1 output of ``crops`` (through the model's own
    stem route: the stem kernel, or the resize and conv1 of a backbone
    input other than twice the crop): against its plain version
    (max-rel < BF16_REL_TOL), its time, the plain version's, four cuDNN
    bottlenecks' (the library call) and its bound."""
    folded = model._backbone_folded()
    x = folded._stage(folded.run_stem(crops), 1).permute(
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
        lib.append({conv: (c.weight.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last), c.bias.to(torch.bfloat16),
            c.stride, c.weight.shape[1] // 2) for conv, c in blk.items()})

    def library():
        v = x.permute(0, 3, 1, 2)
        for blk in lib:
            v = bottleneck_epilogue.bottleneck_library(v, blk)
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
    errs = errors(got, want)
    del got, want
    return record(
        name, "mimamo_tpu_torch/csrc/layer2.cu",
        "mimamo_tpu/pallas/layer2_kernel.py:174", errs,
        {"tol_max_rel": BF16_REL_TOL},
        time_ms(lambda: layer2_kernel.layer2_fused(x, blocks)),
        time_ms(lambda: layer2_kernel.layer2_plain(x, blocks),
                batch=plain_batch),
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


# frames of the benchmark's clip call (bf16) and train step (fp32)
EPILOGUE_FRAMES = {"bfloat16": B * T, "float32": 4 * T}


def epilogue_launches(fp32: bool = False) -> int:
    """Epilogue launches of one backbone call: three a bottleneck block run
    as cuDNN convs (layers 1, 3 and 4 in bf16; layers 1-4 in fp32)."""
    return 3 * (16 if fp32 else 12)


def backbone_of(state: dict, dtype: str, device: str,
                stride_in_1x1: bool = True) -> FoldedResNet50:
    """``FoldedResNet50`` of the backbone weights in ``state`` (the keys of
    both stride placements are the same) on ``device``."""
    spec = BackboneSpec(input_size=2 * S, dtype=dtype)
    model = ResNet50(spec, stride_in_1x1=stride_in_1x1)
    model.load_state_dict({k[len("backbone."):]: v for k, v in state.items()
                           if k.startswith("backbone.")})
    return FoldedResNet50(fold_batchnorm(model.to(device)), spec,
                          stride_in_1x1=stride_in_1x1)


def epilogue_launch(y, bias, args) -> dict:
    """One epilogue on the raw conv output ``y`` (``args``: the residual,
    and the projection's bias): the kernel against its plain version and
    against PyTorch's ops on the same output, as ``F.conv2d`` with a bias
    and the block compose them (``torch.equal``; elements whose bits
    differ, :func:`errors`); the bytes it moves, its byte bound, the
    kernel's and PyTorch's times."""
    def library(v):
        v = v.add_(bias.reshape(1, -1, 1, 1))
        if not args:
            return torch.relu(v)
        r = args[0]
        if len(args) > 1:
            r = r.clone().add_(args[1].reshape(1, -1, 1, 1))
        return torch.relu(v + r)

    got = bottleneck_epilogue.epilogue(y.clone(), bias, *args)
    plain = bottleneck_epilogue.epilogue_plain(y, bias, *args)
    lib = library(y.clone())
    ints = torch.int16 if y.dtype == torch.bfloat16 else torch.int32
    nbytes = (y.numel() * (2 + bool(args)) * y.element_size()
              + bias.numel() * bias.element_size() * len(args or (1,)))
    row = {"shape": list(y.shape), "residual": len(args),
           "equal_plain": torch.equal(got, plain),
           "equal_library": torch.equal(got, lib),
           "bits_differ": int((got.view(ints) != lib.view(ints)).sum()),
           "finite": bool(torch.isfinite(got).all()), **errors(got, plain),
           "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
    del got, plain, lib
    row["ms"] = time_ms(lambda: bottleneck_epilogue.epilogue(y, bias, *args))
    row["library_ms"] = time_ms(lambda: library(y))
    return row


def check_epilogue(state: dict, line: str) -> dict:
    """The epilogue kernel at every launch of one backbone call, bf16 at
    B x T frames and fp32 at 4 x T (the benchmark's batches), on the stage
    inputs of seeded crops: each launch against its plain version and
    against PyTorch's ops on the same raw conv output (``torch.equal``
    and elements whose bits differ), each block against
    ``bottleneck_library`` (``torch.equal``); each launch's time, byte
    bound and PyTorch's time, summed per call; the ptxas report. Returns
    the record at layer1's conv3 in bf16 (block 1: y and the block's input
    read, y written), with the plain version's time."""
    rng = np.random.default_rng(SEED + 70)
    report, rec = {"card": line}, None
    log = _build.build().with_suffix(".log").read_text()
    report["ptxas"] = ptxas_report(log, "epilogue_kernel")
    for dtype, frames in EPILOGUE_FRAMES.items():
        folded = backbone_of(state, dtype, "cuda")
        x = folded.run_stem(torch.from_numpy(rng.integers(
            0, 256, (frames, S, S, 3), dtype=np.uint8)).cuda().float())
        rows, blocks_equal = [], True
        for stage in (1, 2, 3, 4):
            if stage not in folded.stages:
                x = folded.run_layer2(x)
                continue
            for b, blk in enumerate(folded.stages[stage]):
                conv = bottleneck_epilogue._conv
                y1 = conv(x, blk["conv1"], bias=False)
                rows.append(epilogue_launch(y1, blk["conv1"][1], ()))
                y2 = conv(bottleneck_epilogue.epilogue(y1, blk["conv1"][1]),
                          blk["conv2"], bias=False)
                rows.append(epilogue_launch(y2, blk["conv2"][1], ()))
                y3 = conv(bottleneck_epilogue.epilogue(y2, blk["conv2"][1]),
                          blk["conv3"], bias=False)
                args = ((conv(x, blk["downsample"], bias=False),
                         blk["downsample"][1]) if "downsample" in blk
                        else (x,))
                rows.append(epilogue_launch(y3, blk["conv3"][1], args))
                if stage == 1 and b == 1 and dtype == "bfloat16":
                    row = rows[-1]
                    rec = record(
                        "bottleneck_epilogue",
                        "mimamo_tpu_torch/csrc/bottleneck_epilogue.cu",
                        "none: PyTorch's bias add, relu and residual add "
                        "after cuDNN (XLA fused them into its convs)",
                        {k: row[k] for k in ("max_rel_err", "max_abs_err")},
                        {"tol_abs": 0.0}, row["ms"],
                        time_ms(lambda: bottleneck_epilogue.epilogue_plain(
                            y3, blk["conv3"][1], x), batch=2),
                        row["bytes"], 0.0, row["library_ms"])
                del y1, y2, y3, args
                out = folded._bottleneck(x, blk)
                want = bottleneck_epilogue.bottleneck_library(x, blk)
                blocks_equal &= torch.equal(out, want)
                x = want
                del out
        report[dtype] = {
            "frames": frames, "launches": len(rows),
            "all_equal_plain": all(r["equal_plain"] for r in rows),
            "all_equal_library": all(r["equal_library"] for r in rows),
            "bits_differ": sum(r["bits_differ"] for r in rows),
            "all_finite": all(r["finite"] for r in rows),
            "blocks_equal_library": bool(blocks_equal),
            "call_ms": sum(r["ms"] for r in rows),
            "call_bound_ms": sum(r["bound_ms"] for r in rows),
            "call_library_ms": sum(r["library_ms"] for r in rows),
            "rows": rows}
        del folded, x
        torch.cuda.empty_cache()
    print(json.dumps({"epilogue": report}), flush=True)
    bad = [d for d in EPILOGUE_FRAMES
           if not (report[d]["all_equal_plain"]
                   and report[d]["all_equal_library"]
                   and report[d]["blocks_equal_library"]
                   and report[d]["all_finite"]
                   and report[d]["launches"]
                   == epilogue_launches(d == "float32"))]
    if bad or rec["max_abs_err"] != 0:
        raise AssertionError(f"epilogue kernel: {bad}, {rec}")
    return rec


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


# stage_breakdown's keys and the program's spans (``tracing``) they read;
# grayscale is the micro span less its FFT bands and phase kernel
STAGE_SPANS = (("h2d_cast", "runner.h2d"), ("grayscale", "micro"),
               ("fft_bands", "micro.bands"),
               ("phase_kernel", "micro.phase_kernel"),
               ("stem_kernel", "backbone.stem"), ("layer1", "backbone.layer1"),
               ("layer2", "backbone.layer2"), ("layer3", "backbone.layer3"),
               ("layer4", "backbone.layer4"), ("pool5", "backbone.pool"),
               ("temporal", "temporal"))


def stage_breakdown(model: Mimamo, clips: np.ndarray,
                    context: torch.Tensor = None) -> dict:
    """Device time (ms) of each stage of one forward over uint8 ``clips``
    [B, T, S, S, 3], read from the program's spans (``tracing``, each
    span's ``device_ms``): ``predict_clips``, or with ``context`` ([B, 1,
    S, S, 3] on the card) a streaming forward (the context frame prepended
    for the micro stream only, the GRUs from zero carries). Keys as in
    ``STAGE_SPANS``; layer2 is ``layer2_kernel`` or ``layer2_cudnn`` by the
    backbone's route."""
    was = tracing.enabled()
    tracing.enable()
    try:
        with torch.no_grad():
            if context is None:
                model.predict_clips(clips)
            else:
                carries = tuple(torch.zeros(
                    (clips.shape[0], model.config.temporal.gru_hidden),
                    device="cuda") for _ in range(2))
                crops = torch.from_numpy(clips).cuda()
                model(torch.cat([context, crops], 1), carries,
                      include_first_pair=True)
    finally:
        tracing.enable(was)
    records = tracing.collect()
    ms = {r.name: r.device_ms for r in records
          if r.request == records[-1].request}
    layer2 = ("layer2_kernel" if model._backbone_folded().layer2 is not None
              else "layer2_cudnn")
    stages = {layer2 if key == "layer2" else key: ms[name]
              for key, name in STAGE_SPANS}
    stages["grayscale"] -= stages["fft_bands"] + stages["phase_kernel"]
    return stages


def clip_step_ms(model: Mimamo, clips: np.ndarray) -> list:
    """Host times (ms) of 5 ``predict_clips`` steps, each ending in a
    synchronize."""
    times = []
    for _ in range(5):
        t = time.perf_counter()
        model.predict_clips(clips)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def median_stages(runs: list) -> dict:
    return {name: statistics.median(r[name] for r in runs)
            for name in runs[0]}


KERNELS = {"phase_diff_resize": phase_kernel.KERNEL,
           "stem_fused": stem_kernel.KERNEL,
           "layer2_fused": layer2_kernel.KERNEL,
           "stem_fused[f32]": stem_kernel.KERNEL_F32,
           "layer1_dots": layer1_dots_kernel.KERNEL,
           "layer2_g4_dots": layer2_dots_kernel.KERNEL,
           "bottleneck_epilogue": bottleneck_epilogue.KERNEL}


def expected_launches(forwards: int = 1, classify: int = 0,
                      fp32: bool = False) -> dict:
    """Launches of ``forwards`` forwards, clip or streaming (the phase
    kernel takes all scales in one launch), and ``classify`` backbone-only
    calls (``classify_frames``: the backbone, no phase). A bf16 backbone
    launches the bf16 stem and layer2 (one launch per bottleneck block);
    an fp32 one the fp32 stem, with layer2 on cuDNN; either the epilogue
    three times a block on cuDNN (:func:`epilogue_launches`)."""
    backbone = forwards + classify
    return {"phase_diff_resize": forwards,
            "stem_fused": 0 if fp32 else backbone,
            "layer2_fused": 0 if fp32 else 4 * backbone,
            "stem_fused[f32]": backbone if fp32 else 0,
            "layer1_dots": 0, "layer2_g4_dots": 0,
            "bottleneck_epilogue": epilogue_launches(fp32) * backbone}


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
    widest crop of one column tile, 128^2, and the narrowest, 8^2); its
    times and the bounds of two designs: 3xTF32 tensor-core products,
    which it uses and which its record's bound follows, and fp32 FMAs."""
    w2, bias = model._backbone_folded().stem
    if w2.dtype != torch.float32:
        raise AssertionError(f"the default config's stem is {w2.dtype}")
    mean = model.config.backbone.mean_rgb
    got = stem_kernel.stem_fused(crops, w2, bias, mean)
    want = stem_kernel.stem_plain(crops, w2, bias, mean)
    errs = {"flagship": errors(got, want)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for n, s in ((API_BATCH, S), (API_CHUNK, S), (API_T, S), (3, 34), (5, S),
                 (2, 2 * stem_kernel.TILE_Q_F32), (2, 8)):
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
    nbytes, flops = stem_work(crops, got)
    del got, want
    print(json.dumps({"stem_f32_bound_ms": {
        "ffma": bound_ms(nbytes, flops, PEAK_FP32_FLOP_PER_S)[0],
        "3xtf32": bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)[0],
        "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}}), flush=True)
    return stem_record(crops, model, "stem_fused[f32]")


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
    times = clip_step_ms(model, clips)
    step = statistics.median(times) / 1e3
    stages = median_stages([stage_breakdown(model, clips) for _ in range(3)])
    rates = {name: flops / (stages["layer2_cudnn" if name == "layer2"
                                   else name] * 1e-3) / 1e12
             for name, flops in conv_flops(B * T).items()}
    # what keeping TF32 off costs: the same step with cuDNN's TF32 on (a
    # yardstick only; the port keeps it off)
    torch.backends.cudnn.allow_tf32 = True
    try:
        model.predict_clips(clips)
        tf32 = clip_step_ms(model, clips)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    small = clips[:1, :8]
    with torch.no_grad():
        card_out = model.predict_clips(small).cpu()
        card_emb = model.embed_frames(torch.from_numpy(small).cuda().float()
                                      ).cpu()
    cpu_out, cpu_emb = small_cpu
    report = {"fp32_frames_per_s": B * T / step, "fp32_step_ms": step * 1e3,
              "fp32_steps_ms": times,
              "fp32_stage_ms": stages,
              "fp32_stage_sum_ms": sum(stages.values()),
              "fp32_conv_tflop_per_s": rates,
              "fp32_step_ms_cudnn_tf32_on": statistics.median(tf32),
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


# -- the serving daemon, the command line and the corpus runner ---------------

SLICE_ATOL = 1e-6        # max |d| of series and stream values (6 decimals)
EVAL_BATCH_ATOL = 1e-4   # CCCs, batch of 8 streams against 1 (streamed gate)
SERVE_FEEDS = 10         # stream_feed_multi requests in each round
SERVE_T = 120            # frames of the served / predicted / corpus video
CORPUS_T = (SERVE_T, 72, 30)          # the corpus: the last is < one clip
SUBPROCESS_TIMEOUT = 120
CLI_FLAGS: list = []     # flags every command line of these phases gets
REPO = os.path.dirname(os.path.abspath(__file__))


def slice_media(tmp: str) -> dict:
    """The corpus of the new phases: videos of CORPUS_T frames at 640 x 360
    (the first is the served and predicted one) in ``<tmp>/videos``, each
    with ``<video>.boxes.npy`` (``video_source``'s boxes moved inside the
    frame) and ``<video>.landmarks.npy`` (its eye points) sidecars; a seeded ``.npy`` of API_T crops; a synthetic Aff-Wild2
    corpus (as the train phase makes it)."""
    import cv2  # noqa: F401 — the phases decode and encode video files
    from mimamo_tpu_torch.io import decode
    vdir = os.path.join(tmp, "videos")
    os.makedirs(vdir)
    videos = []
    for i, t in enumerate(CORPUS_T):
        frames, boxes, eyes = video_source(t, 360, 640, SEED + 20 + i)
        # inside the frame, as a tracker's boxes are: the corpus runner's
        # host crop slices the frame by them
        boxes[:, 2:] = np.minimum(boxes[:, 2:], 360)
        boxes[:, :2] = np.clip(boxes[:, :2], 0, [360, 640] - boxes[:, 2:])
        path = os.path.join(vdir, f"v{i}.mp4")
        decode.write_video(path, frames)
        np.save(path + ".boxes.npy", boxes)
        np.save(path + ".landmarks.npy", eyes)
        videos.append(path)
    crops = os.path.join(tmp, "crops.npy")
    np.save(crops, np.random.default_rng(SEED + 4).integers(
        0, 256, (API_T, S, S, 3), dtype=np.uint8))
    aff = os.path.join(tmp, "aff")
    datasets.make_synthetic_affwild2(aff, n_videos=2, frames=TRAIN_T, size=S,
                                     seed=SEED)
    return {"videos": videos, "dir": vdir, "crops": crops, "aff": aff}


def save_weights(state: dict, cfg: MimamoConfig, path: str) -> str:
    """``state`` as a port checkpoint directory (what ``--ckpt`` reads)."""
    model = Mimamo(cfg)
    model.load_state_dict(state)
    checkpoints.save(path, train.create_train_state(model))
    del model
    return path


class PipeClient:
    """The client end of ``serve.run`` driven on a thread of this process
    over two pipes: sends one request line, reads lines until the one with
    its id, and keeps the order in which responses arrived."""

    def __init__(self, server):
        from mimamo_tpu_torch import serve
        r_in, w_in = os.pipe()
        r_out, w_out = os.pipe()
        self._to_server = os.fdopen(w_in, "w")
        self._from_server = os.fdopen(r_out, "r")
        self._server_in = os.fdopen(r_in, "r")
        self._server_out = os.fdopen(w_out, "w")
        self.thread = threading.Thread(
            target=serve.run, args=(server, self._server_in,
                                    self._server_out), daemon=True)
        self.thread.start()
        self.arrivals, self.stashed, self._n = [], {}, 0

    def send(self, req: dict) -> str:
        self._n += 1
        rid = req.setdefault("id", f"r{self._n}")
        self._to_server.write(json.dumps(req) + "\n")
        self._to_server.flush()
        return rid

    def wait(self, rid: str) -> dict:
        while rid not in self.stashed:
            resp = json.loads(self._from_server.readline())
            self.arrivals.append(resp.get("id"))
            self.stashed[resp.get("id")] = resp
        return self.stashed.pop(rid)

    def request(self, req: dict) -> tuple:
        """(response, seconds from the write to the response's arrival)"""
        t = time.perf_counter()
        resp = self.wait(self.send(req))
        return resp, time.perf_counter() - t

    def close(self) -> None:
        resp = self.wait(self.send({"cmd": "shutdown"}))
        self.thread.join(SUBPROCESS_TIMEOUT)
        for f in (self._to_server, self._from_server, self._server_in,
                  self._server_out):
            f.close()
        if not resp.get("shutdown") or self.thread.is_alive():
            raise AssertionError("the serve loop did not shut down")


def serve_values(resp: dict, names: list) -> np.ndarray:
    if not resp.get("ok"):
        raise AssertionError(f"serve request failed: {resp}")
    return np.stack([np.asarray(resp["values"][n], np.float64)
                     for n in names])


def check_serve(state: dict, cfg: MimamoConfig, ckpt: str, media: dict,
                line: str) -> dict:
    """``serve.run`` in this process over a pipe at the bf16 main path's
    config, capacity 8 x chunk 16, uint8 streams: ping, 8 ``stream_open``,
    SERVE_FEEDS ``stream_feed_multi`` requests of seeded chunks (npy
    paths), against a ``StreamingSession`` on the same model fed the same
    chunks (<= SLICE_ATOL) and with the launches of one request; the same
    again with a ``predict`` of the 120-frame video in flight on the
    worker thread (feeds answered before it, its series against
    ``MimamoAPI.predict`` alone); then ``python -m mimamo_tpu_torch.cli
    serve`` as a subprocess. Returns the launches of one
    ``stream_feed_multi``."""
    from mimamo_tpu_torch import serve
    report = {"card": line}
    names = [f"s{i}" for i in range(CAPACITY)]
    rng = np.random.default_rng(SEED + 30)
    chunks = rng.integers(0, 256, (SERVE_FEEDS, CAPACITY, CHUNK, S, S, 3),
                          dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [[os.path.join(tmp, f"f{i}_{n}.npy") for n in names]
                 for i in range(SERVE_FEEDS)]
        for i in range(SERVE_FEEDS):
            for j in range(CAPACITY):
                np.save(paths[i][j], chunks[i, j])
        server = serve.Server(config=cfg, state_dict=state,
                              capacity=CAPACITY, chunk=CHUNK,
                              stream_dtype=np.uint8, warmup=True,
                              device="cuda")
        # the reference: the same slot history (warm-up, then 8 opens)
        ref = StreamingSession(server.api.model, capacity=CAPACITY,
                               chunk=CHUNK, dtype=np.uint8)
        warm = ref.add_stream()
        ref.feed({warm: np.zeros((CHUNK, S, S, 3), np.uint8)})
        ref.remove_stream(warm)
        client = PipeClient(server)
        ping, _ = client.request({"cmd": "ping"})
        slots = [client.request({"cmd": "stream_open", "stream": n})[0]
                 .get("slot") for n in names]
        if not ping.get("ok") or slots != [ref.add_stream() for _ in names]:
            raise AssertionError(f"serve: ping {ping}, slots {slots}")

        def feed_round(predict_id=None):
            ms, errs, ids, firsts, launches = [], [], [], [], None
            for i in range(SERVE_FEEDS):
                req = {"cmd": "stream_feed_multi",
                       "streams": dict(zip(names, paths[i]))}
                if predict_id is None and i == 2:
                    (resp, sec), launches = counted(
                        lambda: client.request(req))
                else:
                    resp, sec = client.request(req)
                want = ref.feed({s: chunks[i, j]
                                 for j, s in enumerate(slots)})
                ids.append(resp["id"])
                ms.append(sec * 1e3)
                got = serve_values(resp, names)
                firsts.append(got[0])
                errs.append(float(np.abs(got - np.stack(
                    [want[s] for s in slots])).max()))
            return ms, max(errs), ids, firsts, launches

        ms, err, _, firsts, launches = feed_round()
        # a fresh s0 fed chunk 0, as the subprocess below feeds it
        first_s0 = firsts[0]
        video = media["videos"][0]
        pid = client.send({"cmd": "predict", "video": video,
                           "series": True, "id": "P"})
        ms_p, err_p, feed_ids, _, _ = feed_round(pid)
        predicted = client.wait(pid)
        order = client.arrivals
        before = [i for i in feed_ids if order.index(i) < order.index(pid)]
        for n in names:
            client.request({"cmd": "stream_close", "stream": n})
        client.close()
        alone = server.api.predict(video)
        series = np.asarray(predicted.get("series", []), np.float64)
        report.update({
            "serve_feed_ms": {"median": statistics.median(ms),
                              "max": max(ms), "all": ms},
            "serve_feed_ms_predict_in_flight": {
                "median": statistics.median(ms_p), "max": max(ms_p),
                "all": ms_p},
            "serve_values_vs_session_max_abs": err,
            "serve_values_in_flight_vs_session_max_abs": err_p,
            "feeds_answered_before_predict": len(before),
            "predict_vs_alone_max_abs": (
                float(np.abs(series - alone).max())
                if series.shape == alone.shape else None),
            "launches_per_feed_multi": launches,
            "frames_per_feed": CAPACITY * CHUNK})
        del server, ref
        torch.cuda.empty_cache()

        # the daemon as a user starts it
        reqs = [{"cmd": "ping", "id": "p"},
                {"cmd": "stream_open", "stream": "s0", "id": "o"},
                {"cmd": "stream_feed_multi", "id": "f",
                 "streams": {"s0": paths[0][0]}},
                {"cmd": "stream_close", "stream": "s0", "id": "c"},
                {"cmd": "shutdown", "id": "x"}]
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mimamo_tpu_torch.cli", "serve", "--ckpt",
             ckpt, "--dtype", "bfloat16", "--uint8-streams", "--capacity",
             str(CAPACITY), "--chunk", str(CHUNK), *CLI_FLAGS],
            input="".join(json.dumps(r) + "\n" for r in reqs),
            capture_output=True, text=True, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO),
            timeout=SUBPROCESS_TIMEOUT)
        wall = time.perf_counter() - t
        lines = [json.loads(x) for x in proc.stdout.splitlines() if x]
        by_id = {x.get("id"): x for x in lines[1:]}
        sub_ok = (proc.returncode == 0 and lines and lines[0].get("ready")
                  and all(by_id.get(k, {}).get("ok") for k in "pofcx"))
        sub_err = (float(np.abs(serve_values(by_id["f"], ["s0"])[0]
                                - first_s0).max()) if sub_ok else None)
        report["cli_serve_subprocess"] = {
            "rc": proc.returncode, "wall_s": wall, "answered": sorted(by_id),
            "values_vs_in_process_max_abs": sub_err,
            "feed": by_id.get("f") if not sub_ok else "ok",
            "stderr_tail": proc.stderr[-300:] if not sub_ok else ""}
    print(json.dumps(report), flush=True)
    if not (err <= SLICE_ATOL and err_p <= SLICE_ATOL
            and len(before) >= 1 and series.shape == (SERVE_T, 2)
            and report["predict_vs_alone_max_abs"] <= SLICE_ATOL
            and sub_ok and sub_err <= SLICE_ATOL):
        raise AssertionError(f"serve phase: {report}")
    return launches


def run_cli(argv: list) -> list:
    """``cli.main(argv + CLI_FLAGS)`` in this process: its JSON lines."""
    import contextlib
    import io
    from mimamo_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + CLI_FLAGS)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    return [json.loads(x) for x in buf.getvalue().splitlines() if x]


@contextlib.contextmanager
def deterministic_algorithms():
    """Inside, cuDNN and PyTorch take their deterministic algorithms (an
    operation without one warns). With the defaults, two runs of the same
    ``cli train`` in one process differ by up to ~1e-6 in a parameter
    (``mimamo_tpu_torch/bench/train_repeat.py``: Adam's first step turns
    the rounding noise of a tiny gradient into a step of up to lr); with
    them, by nothing."""
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def read_csv(path: str) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def check_cli(state: dict, cfg: MimamoConfig, ckpt: str, media: dict,
              line: str) -> dict:
    """``cli.main`` at the default config (fp32): ``predict --video
    --boxes --out`` and ``predict --crops`` against ``MimamoAPI``,
    ``extract`` against ``VideoProcessor`` and ``FeatureExtractor``,
    ``eval --batch-streams 8`` against ``--batch-streams 1``, ``train``
    for one epoch and its checkpoint restored by ``MimamoAPI``, ``train
    --tensorboard`` (:func:`cli_tensorboard`) and ``train --debug-nans``
    (:func:`cli_debug_nans`). Returns
    the launches of one ``cli predict`` of the 120-frame video (one
    forward)."""
    report = {"card": line}
    video, crops = media["videos"][0], media["crops"]
    boxes = video + ".boxes.npy"
    a = api.MimamoAPI(config=cfg, state_dict=state, device="cuda")
    want = a.predict(video, boxes_path=boxes)           # and the warm-up
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "p.csv")
        t = time.perf_counter()
        rows, launches = counted(
            lambda: run_cli(["predict", "--video", video, "--boxes", boxes,
                             "--out", out, "--ckpt", ckpt]),
            expected_launches(1, fp32=True))
        report["cli_predict_wall_ms"] = (time.perf_counter() - t) * 1e3
        got = read_csv(out)
        row = rows[0]
        report["cli_predict"] = {
            "row": row, "csv_rows": len(got),
            "csv_vs_api_max_abs": float(np.abs(got[:, 1:] - want).max()),
            "means_abs": float(max(
                abs(row["valence_mean"] - want[:, 0].mean()),
                abs(row["arousal_mean"] - want[:, 1].mean())))}
        starts = window_starts(API_T, cfg.clip.clip_len, cfg.clip.stride)
        want_c = a.predict_crops(crops)
        out_c = os.path.join(tmp, "c.csv")
        _, report["launches_cli_predict_crops"] = counted(
            lambda: run_cli(["predict", "--crops", crops, "--out", out_c,
                             "--ckpt", ckpt]),
            expected_launches(-(-len(starts) // 8), fp32=True))
        got_c = read_csv(out_c)
        report["cli_predict_crops_vs_api_max_abs"] = float(
            np.abs(got_c[:, 1:] - want_c).max())

        (ex,) = run_cli(["extract", "--video", video, "--boxes", boxes,
                         "--out-dir", os.path.join(tmp, "ex"), "--ckpt",
                         ckpt])
        vp = api.VideoProcessor(save_size=S, device="cuda").process(
            video, os.path.join(tmp, "vp"), boxes_path=boxes)
        feats = np.load(ex["features"])
        fx = api.FeatureExtractor(config=cfg, state_dict=state,
                                  device="cuda")
        report["cli_extract"] = {
            "crops_max_lsb": int(np.abs(np.load(ex["crops"]).astype(int)
                                        - np.load(vp)).max()),
            "features_vs_extractor_max_rel": max_rel(
                feats, np.load(fx.extract(ex["crops"], os.path.join(
                    tmp, "fx.feat.npy")))),
            "features_shape": list(feats.shape)}
        del fx

        evals = {}
        for bs in (8, 1):
            t = time.perf_counter()
            (evals[bs],) = run_cli(["eval", "--dataset", "affwild2",
                                    "--root", media["aff"], "--ckpt", ckpt,
                                    "--batch-streams", str(bs)])
            evals[bs]["wall_ms"] = (time.perf_counter() - t) * 1e3
        report["cli_eval"] = evals
        report["cli_eval_batch8_vs_1_max_abs"] = max(
            abs(evals[8][k] - evals[1][k])
            for k in ("valence_ccc", "arousal_ccc", "mean_ccc"))

        trained = os.path.join(tmp, "trained")
        t = time.perf_counter()
        with deterministic_algorithms():     # cli_debug_nans compares
            train_rows = run_cli(["train", "--dataset", "affwild2",
                                  "--root", media["aff"], "--ckpt", trained,
                                  "--epochs", "1"])
        report["cli_train_wall_ms"] = (time.perf_counter() - t) * 1e3
        report["cli_train_rows"] = train_rows
        restored = api.MimamoAPI(config=cfg, checkpoint_dir=trained,
                                 device="cuda").model.state_dict()
        saved = checkpoints.load(trained)["model"]
        report["cli_train_restore_max_abs"] = max(
            float((restored[k].cpu().float() - v.float()).abs().max())
            for k, v in saved.items())
        steps = train_rows[0]["steps"] if train_rows else 0
        report["cli_train_ckpt_step"] = checkpoints.latest_step(trained)
        report["cli_train_tensorboard"] = cli_tensorboard(media, tmp)
        report["cli_train_debug_nans"] = cli_debug_nans(state, cfg, media,
                                                        saved, tmp)
    report["launches_cli_predict"] = launches
    print(json.dumps(report), flush=True)
    pr, ex = report["cli_predict"], report["cli_extract"]
    if not (pr["row"]["frames"] == SERVE_T and pr["csv_rows"] == SERVE_T
            and pr["csv_vs_api_max_abs"] <= SLICE_ATOL
            and pr["means_abs"] <= SLICE_ATOL
            and report["cli_predict_crops_vs_api_max_abs"] <= SLICE_ATOL
            and ex["crops_max_lsb"] <= 1
            and ex["features_vs_extractor_max_rel"] <= SAME_SHAPE_REL_TOL
            and ex["features_shape"] == [SERVE_T, 2048]
            and report["cli_eval_batch8_vs_1_max_abs"] < EVAL_BATCH_ATOL
            and len(train_rows) == 1 and steps > 0
            and np.isfinite(train_rows[0]["loss"])
            and report["cli_train_ckpt_step"] == steps
            and report["cli_train_restore_max_abs"] == 0.0
            and report["cli_train_tensorboard"]["ok"]
            and report["cli_train_debug_nans"]["ok"]):
        raise AssertionError(f"cli phase: {report}")
    return launches


def cli_tensorboard(media: dict, tmp: str) -> dict:
    """``cli train --tensorboard`` for one epoch: the event file read back
    (``summary.read_events``) holds the file version and, at step = epoch,
    each numeric key of the printed row but ``epoch``, equal to it as a
    float32."""
    tb = os.path.join(tmp, "tb")
    rows = run_cli(["train", "--dataset", "affwild2", "--root",
                    media["aff"], "--epochs", "1", "--tensorboard", tb])
    (path,) = glob.glob(os.path.join(tb, "events.out.tfevents.*"))
    events = summary.read_events(path)
    got = [(e["step"], k, v) for e in events[1:]
           for k, v in e.get("values", {}).items()]
    want = [(r["epoch"], k, float(np.float32(v))) for r in rows
            for k, v in r.items()
            if isinstance(v, (int, float)) and k != "epoch"]
    return {"events": len(events), "scalars": len(got),
            "ok": (events[0].get("file_version") == "brain.Event:2"
                   and len(rows) == 1 and got == want)}


def cli_debug_nans(state: dict, cfg: MimamoConfig, media: dict,
                   plain_ckpt: dict, tmp: str) -> dict:
    """``cli train --debug-nans`` for one epoch against the plain run
    (rows and checkpoint within 1e-6: two fp32 runs on the card, both on
    deterministic algorithms); the
    frozen train step (4 x 48) with the NaN checks beside the plain one
    (host clock, median of 3 in turns); a NaN planted in the temporal
    head's weight raises ``FloatingPointError`` in the checked step."""
    ckpt = os.path.join(tmp, "debug_nans")
    with deterministic_algorithms():
        rows = run_cli(["train", "--dataset", "affwild2", "--root",
                        media["aff"], "--epochs", "1", "--ckpt", ckpt,
                        "--debug-nans"])
    report = {"rows": rows, "ckpt_vs_plain_max_abs": state_diff(
        checkpoints.load(ckpt)["model"], plain_ckpt)}
    batch = next(datasets.AffWild2Dataset(media["aff"], clip=cfg.clip)
                 .batches(cfg.train.batch_size))
    model, st, plain = _train_model(state)
    checked = train.make_train_step(model, debug_nans=True)
    plain(st, batch)                                        # warm-ups
    checked(st, batch)
    times = {"plain": [], "debug_nans": []}
    for _ in range(3):
        for name, step in (("plain", plain), ("debug_nans", checked)):
            times[name] += step_ms(step, st, batch, 1)
    report["step_ms"] = {k: statistics.median(v) for k, v in times.items()}
    with torch.no_grad():
        model.temporal.head.weight[0, 0] = float("nan")
    try:
        checked(st, batch)
        report["nan_raised"] = None
    except FloatingPointError as e:
        report["nan_raised"] = str(e)
    report["ok"] = (len(rows) == 1 and rows[0]["steps"] > 0
                    and report["ckpt_vs_plain_max_abs"] <= SLICE_ATOL
                    and "temporal.head" in (report["nan_raised"] or ""))
    return report


def check_corpus(ckpt: str, media: dict, line: str) -> None:
    """``cli predict-corpus`` at the default config over the 3 videos:
    the Python loader (box crops on the host), the native loader where the
    library builds (``io.native_loader`` compiles it at first use; the
    report carries the outcome and, where it fails, why), each run's
    summary naming its loader, frames/s of each, a resumed run, and
    ``--align``
    with the landmark sidecars against ``cli predict --align`` of each
    video."""
    from mimamo_tpu_torch.io import native_loader
    t = time.perf_counter()
    report = {"card": line, "native_available": native_loader.available(),
              "native_build_error": native_loader.build_error(),
              "native_library": str(getattr(native_loader._NATIVE.lib,
                                            "_name", None)),
              "native_first_use_s": time.perf_counter() - t}
    glob_ = os.path.join(media["dir"], "*.mp4")
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        runs = [("python", ["--no-native"])]
        if native_loader.available():
            runs.append(("native", []))
        for loader, flags in runs:
            out = os.path.join(tmp, loader)
            (stats,) = run_cli(["predict-corpus", "--videos", glob_,
                                "--out-dir", out, "--ckpt", ckpt, *flags])
            (again,) = run_cli(["predict-corpus", "--videos", glob_,
                                "--out-dir", out, "--ckpt", ckpt, *flags])
            with open(os.path.join(out, "manifest.jsonl")) as f:
                manifest = {os.path.basename(r["video"]): r
                            for r in map(json.loads, f)}
            csvs = [read_csv(os.path.join(out, f"v{i}.csv"))
                    for i in range(len(CORPUS_T))]
            report[f"corpus_{loader}"] = {
                "stats": stats, "resumed": again,
                "frames_per_s": stats["fps"],
                "manifest": {k: [r["status"], r.get("frames")]
                             for k, r in manifest.items()}}
            ok = ok and (
                stats["loader"] == loader
                and stats["videos"] == len(CORPUS_T) and stats["failed"] == 0
                and stats["frames"] == sum(CORPUS_T)
                and again["resumed_skipped"] == len(CORPUS_T)
                and again["videos"] == 0
                and all(manifest[f"v{i}.mp4"]["status"] == "ok"
                        and manifest[f"v{i}.mp4"]["frames"] == t
                        for i, t in enumerate(CORPUS_T))
                and all(c.shape == (t, 3) and np.isfinite(c).all()
                        for c, t in zip(csvs, CORPUS_T)))
        out = os.path.join(tmp, "aligned")
        (stats,) = run_cli(["predict-corpus", "--videos", glob_,
                            "--out-dir", out, "--ckpt", ckpt, "--align",
                            "--no-native"])
        errs = []
        for i, video in enumerate(media["videos"]):
            ref = os.path.join(tmp, f"ref{i}.csv")
            run_cli(["predict", "--video", video, "--align", "--out", ref,
                     "--ckpt", ckpt])
            errs.append(float(np.abs(read_csv(os.path.join(
                out, f"v{i}.csv")) - read_csv(ref)).max()))
        report["corpus_aligned"] = {"stats": stats,
                                    "vs_cli_predict_align_max_abs": errs}
    print(json.dumps(report), flush=True)
    if not (ok and stats["videos"] == len(CORPUS_T)
            and max(errs) <= SLICE_ATOL):
        raise AssertionError(f"corpus phase: {report}")


# -- the probes ----------------------------------------------------------------

PROBE_ITERS = 1          # timed batches of 10 calls in each probe's run
PROBE_CHECK_FRAMES = 4   # the layer2 probe's check, batched at 4 a step


def bf16_biases(blocks) -> list:
    """``blocks`` with bf16 biases, for the library yardstick: the dot
    sequence as bf16 ``torch.matmul`` calls (cuBLAS) and bf16 elementwise
    ops, never called by the port."""
    return [dataclasses.replace(blk, **{
        k: getattr(blk, k).to(torch.bfloat16) for k in ("b1", "b2", "b3", "bd")
        if getattr(blk, k) is not None}) for blk in blocks]


DOTS_CHECK_FRAMES = (1, 3, 5)  # and B x T: odd and ragged persistent grids


def check_dots(name, kernel, plain, inputs, blocks) -> dict:
    """``kernel`` against ``plain`` on the card at the probe's 384 frames
    and at N = 1, 3 and 5 (a grid of fewer CTAs than SMs at 1 and 3; at 5
    frames layer1's 145 tiles outnumber the card's SMs, so a persistent CTA
    takes a second tile and the last wave is ragged):
    max-rel < BF16_REL_TOL, finite everywhere. Returns :func:`errors` at
    384 frames."""
    errs = {}
    for n in DOTS_CHECK_FRAMES + (B * T,):
        x = inputs(n)
        got, want = kernel(x, blocks), plain(x, blocks)
        torch.cuda.synchronize()
        errs[n] = errors(got, want)
        finite = bool(torch.isfinite(got.float()).all())
        if not (errs[n]["max_rel_err"] < BF16_REL_TOL and finite):
            raise AssertionError(f"{name} at N = {n}: {errs[n]}, finite "
                                 f"{finite} (gate {BF16_REL_TOL})")
    print(json.dumps({f"{name}_err": errs}), flush=True)
    return errs[B * T]


def check_probes(line: str):
    """The two probes through their entry points (``main``) at 384 frames,
    with the launch counts set to 0 just before and read just after; then
    the dots kernels against their plain versions (384, 1 and 3 frames),
    their records, and the library layer1 stage against the dots kernel.
    Returns (records, launches of the probes' runs)."""
    calls = 2 + PROBE_ITERS * 10      # time_ms: 2 warm-ups + iters x 10
    variants = 3                      # checked: unrolled, g4, batched at 4
    expected = dict(expected_launches(0),
                    layer1_dots=3 * (1 + calls),
                    layer2_fused=4 * (variants + calls),
                    layer2_g4_dots=4 * (1 + calls))
    frames = str(B * T)
    argv1 = ["--batch-frames", frames, "--iters", str(PROBE_ITERS),
             "--no-gemm"]
    argv2 = ["--batch", frames, "--iters", str(PROBE_ITERS), "--dots-only",
             "--frames", str(PROBE_CHECK_FRAMES)]
    _, launches = counted(lambda: (layer1_probe.main(argv1),
                                   layer2_probe.main(argv2)), expected)

    l1_blocks = layer1_dots_kernel.pack_layer1_dots(
        layer1_probe.dots_weights(), "cuda")
    l2_blocks = layer2_probe.prepare(layer2_probe.probe_weights(SEED)[1],
                                     "cuda").dots
    l1_in = lambda n: layer1_probe.inputs(n, SEED, "cuda")
    l2_in = lambda n: layer2_probe.inputs(n, SEED, "cuda").reshape(
        n, 28, 2, 28, 2 * C_IN)
    # one call of each: one launch per bottleneck block
    _, per_call = counted(
        lambda: (layer1_dots_kernel.layer1_dots(l1_in(1), l1_blocks),
                 layer2_dots_kernel.layer2_dots(l2_in(1), l2_blocks)),
        dict(expected_launches(0), layer1_dots=3, layer2_g4_dots=4))
    ptxas = ptxas_report(_build.build().with_suffix(".log").read_text())
    for name, mod in (("layer1_dots", layer1_dots_kernel),
                      ("layer2_g4_dots", layer2_dots_kernel)):
        regs = [r for r in ptxas if f"ILi{mod.GRID_W}ELi{mod.WIDTH}E" in r[0]]
        print(json.dumps({f"{name}_build": {
            "registers_spill_stores_loads_serialized": [r[1:] for r in regs],
            # no cluster dimension: every CTA is a cluster of its own
            "cluster_size": 1,
            "ctas": {n: dots_block.launch_plan(mod.PLAN, n)
                     for n in DOTS_CHECK_FRAMES + (B * T,)},
            "card": line}}), flush=True)
    recs = []
    for name, mod, kernel, plain, inputs, blocks, cin, source, replaces in (
            ("layer1_dots", layer1_dots_kernel, layer1_dots_kernel.layer1_dots,
             layer1_dots_kernel.layer1_dots_plain, l1_in, l1_blocks,
             layer1_dots_kernel.C_IN, "mimamo_tpu_torch/csrc/layer1_dots.cu",
             "bench/layer1_probe.py:107"),
            ("layer2_g4_dots", layer2_dots_kernel,
             layer2_dots_kernel.layer2_dots,
             layer2_dots_kernel.layer2_dots_plain, l2_in, l2_blocks,
             2 * C_IN, "mimamo_tpu_torch/csrc/layer2_dots.cu",
             "bench/layer2_probe.py:337")):
        errs = check_dots(name, kernel, plain, inputs, blocks)
        x = inputs(B * T)
        out = kernel(x, blocks)
        lib = bf16_biases(blocks)
        weights = sum(t.numel() * t.element_size() for blk in blocks
                      for t in vars(blk).values() if t is not None)
        # the bound counts the work the output needs: the live grid
        # columns, once per distinct value (dots_block.needed_work)
        flops, rows = mod.needed_work()
        executed = mod.dot_flops_per_frame() * B * T
        rec = record(
            name, source, replaces, errs, {"tol_max_rel": BF16_REL_TOL},
            time_ms(lambda: kernel(x, blocks)),
            time_ms(lambda: plain(x, blocks), batch=2),
            int(rows.sum()) * cin * 2 * B * T + out.numel() * 2 + weights,
            flops * B * T,
            time_ms(lambda: plain(x, lib, torch.bfloat16)))
        rec.update(launches=launches[name], launches_per_call=per_call[name],
                   needed_gflop=flops * B * T / 1e9,
                   executed_gflop=executed / 1e9,
                   executed_bound_ms=executed / PEAK_BF16_FLOP_PER_S * 1e3,
                   hbm_floor_ms=mod.hbm_floor_bytes() * B * T
                   / PEAK_BYTES_PER_S * 1e3)
        print(json.dumps({f"{name}_work": {
            k: rec[k] for k in ("needed_gflop", "executed_gflop", "bound_ms",
                                "executed_bound_ms", "hbm_floor_ms", "ms")}}),
              flush=True)
        recs.append(rec)

    x = l1_in(B * T)
    stage = layer1_probe.stage_blocks(2, "cuda")
    cudnn = time_ms(lambda: layer1_probe.library_layer1(x, stage))
    print(json.dumps({"cudnn_layer1_ms": cudnn,
                      "layer1_dots_ms": recs[0]["ms"],
                      "cudnn_layer1_over_layer1_dots": cudnn / recs[0]["ms"],
                      "frames": B * T, "card": line}), flush=True)
    return recs, launches


CROPS = (128, 160, 200, 224)   # crop sizes of the crops phase
# the stem kernels at crops whose column tiles are uneven (202: 51 + 50
# pooled columns in both forms) or three (264 in fp32)
TILE_CROPS = (202, 264)
CROP_CLIP_T = 8                # frames of the card-vs-CPU clip at each crop


def crop_config(s: int, dtype: str = "float32") -> MimamoConfig:
    """The default config at crop ``s``: pyramid input s x s, backbone
    input 2s (the exact upscale the port runs), clips of s."""
    return MimamoConfig(pyramid=PyramidSpec(input_size=(s, s)),
                        backbone=BackboneSpec(input_size=2 * s, dtype=dtype),
                        clip=ClipSpec(crop_size=s))


def dphi_flips(card_bands: list, cpu_bands: list) -> dict:
    """The card's pyramid bands (cuFFT) against the CPU's (its own FFT):
    their max-rel difference, the largest difference of a phase difference
    between the two, and the source pixels where the two lie on the two
    sides of the +-pi wrap (|d| > pi: a band difference moves an angle
    near +-pi across it, a 2 pi jump)."""
    out = {"flips": 0, "bands_max_rel": 0.0, "dphi_max_abs_unflipped": 0.0}
    for g, c in zip(card_bands, cpu_bands):
        g = g.cpu()
        out["bands_max_rel"] = max(out["bands_max_rel"], max_rel(
            torch.view_as_real(g), torch.view_as_real(c)))
        d = (torch.angle(g[:, 1:] * g[:, :-1].conj())
             - torch.angle(c[:, 1:] * c[:, :-1].conj())).abs()
        out["flips"] += int((d > np.pi).sum())
        out["dphi_max_abs_unflipped"] = max(out["dphi_max_abs_unflipped"],
                                            float(d[d <= np.pi].max()))
    return out


def check_crops(state: dict, line: str) -> tuple:
    """Crops the JAX package runs past the kernels' old caps (CROPS): at
    each, ``predict_clips`` of one clip x 8 frames in fp32 on the card
    against the CPU (the ``fp32`` phase's gates; the CPU forward takes the
    card's pyramid bands, and its own bands' forward must agree too unless
    a phase difference flips over the +-pi wrap between the two FFTs, see
    :func:`dphi_flips`) with its launches, and in
    bf16 (finite, with its launches: stem 1, layer2 4); the phase kernel on
    that clip's bands; the bf16 and fp32 stem kernels and layer2 against
    their plain versions at B x T frames of the crop, with their times and
    bounds (records named ``<kernel>@<crop>``, launches from that crop's
    forward); the stem kernels at TILE_CROPS. Every layer2 width here
    (32, 40, 50, 56) ends in a partial 30-column tile. Returns (records,
    report)."""
    rng = np.random.default_rng(SEED + 30)
    recs, report = [], {"card": line}
    for s in CROPS:
        clip = rng.integers(0, 256, (1, CROP_CLIP_T, s, s, 3), dtype=np.uint8)
        row = report[s] = {}
        cfg = crop_config(s)
        k, p = cfg.pyramid.orientations, cfg.phase.phase_size
        cpu = Mimamo(cfg, device="cpu")
        cpu.load_state_dict(state)
        gray = to_grayscale(torch.from_numpy(clip).cuda().float())
        card_bands = phase_bands(gray, cfg)
        with torch.no_grad():
            cpu_out = cpu.predict_clips(clip)
            cpu_emb = cpu.embed_frames(torch.from_numpy(clip).float())
            stacks = torch.empty((1, CROP_CLIP_T - 1, cfg.num_phase, p, p))
            phase_kernel.phase_diff_resize_scales(
                [b.cpu() for b in card_bands], stacks,
                [i * k for i in range(len(card_bands))], False)
            cpu_out_card_bands, _ = cpu.temporal(stacks, cpu_emb)
            row["card_vs_cpu_fft"] = dphi_flips(
                card_bands, phase_bands(gray.cpu(), cfg))
        del cpu
        models = {}
        for dtype, fp32 in (("float32", True), ("bfloat16", False)):
            model = models[dtype] = Mimamo(crop_config(s, dtype))
            model.load_state_dict(state)
            with torch.no_grad():
                model.predict_clips(clip)                    # warm-up
                out, row[f"launches_{dtype}"] = counted(
                    lambda: model.predict_clips(clip),
                    expected_launches(fp32=fp32))
                emb = model.embed_frames(torch.from_numpy(clip).cuda().float())
            if tuple(out.shape) != (1, CROP_CLIP_T, 2) or \
                    not torch.isfinite(out).all():
                raise AssertionError(f"{dtype} predict_clips at crop {s} "
                                     f"gave {tuple(out.shape)}")
            if fp32:
                row["fp32_card_vs_cpu_emb_max_rel"] = max_rel(emb.cpu(),
                                                              cpu_emb)
                row["fp32_card_vs_cpu_out_max_rel"] = max_rel(
                    out.cpu(), cpu_out_card_bands)
                row["fp32_card_vs_cpu_own_fft_out_max_rel"] = max_rel(
                    out.cpu(), cpu_out)
            else:
                row["bf16_card_vs_cpu_out_max_rel"] = max_rel(out.cpu(),
                                                              cpu_out)
        if not (row["fp32_card_vs_cpu_emb_max_rel"] <= FP32_EMB_REL_TOL
                and row["fp32_card_vs_cpu_out_max_rel"] <= FP32_OUT_REL_TOL
                and (row["card_vs_cpu_fft"]["flips"] or row[
                    "fp32_card_vs_cpu_own_fft_out_max_rel"]
                    <= FP32_OUT_REL_TOL)):
            raise AssertionError(f"crop {s}: fp32 card and CPU disagree: "
                                 f"{row}")
        row["phase_err"] = phase_errs(card_bands, cfg, f"crop {s}")[False]
        crops = torch.from_numpy(rng.integers(
            0, 256, (B * T, s, s, 3), dtype=np.uint8)).cuda().float()
        with torch.no_grad():
            for kernel, dtype, check in (
                    ("stem_fused", "bfloat16", stem_record),
                    ("stem_fused[f32]", "float32", stem_record),
                    ("layer2_fused", "bfloat16", check_layer2)):
                rec = check(crops, models[dtype], f"{kernel}@{s}",
                            plain_batch=2)
                rec["crop"] = s
                rec["launches"] = row[f"launches_{dtype}"][kernel]
                recs.append(rec)
        del crops, models
        torch.cuda.empty_cache()
        print(json.dumps({"crop": s, **row}), flush=True)
    tiles = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    for dtype in ("bfloat16", "float32"):
        model = Mimamo(crop_config(S, dtype))
        model.load_state_dict(state)
        w2, bias = model._backbone_folded().stem
        mean = model.config.backbone.mean_rgb
        for s in TILE_CROPS:
            c = torch.rand((3, s, s, 3), device="cuda", generator=gen) * 255
            tiles[f"{dtype}_s{s}"] = {
                "tiles": len(stem_kernel.tile_plan(s, w2.dtype)),
                **errors(stem_kernel.stem_fused(c, w2, bias, mean),
                         stem_kernel.stem_plain(c, w2, bias, mean))}
        del model
    report["stem_tile_crops"] = tiles
    print(json.dumps({"stem_tile_crops": tiles}), flush=True)
    if not all(e["max_rel_err"] < BF16_REL_TOL if k.startswith("bf")
               else (e["max_rel_err"] <= STEM_F32_REL_TOL
                     and e["max_abs_err"] <= STEM_F32_ATOL)
               for k, e in tiles.items()):
        raise AssertionError(f"stem kernels at uneven tiles: {tiles}")
    return recs, report


# -- the model variants -----------------------------------------------------

# name -> (TemporalSpec overrides, BackboneSpec overrides) of the default
# config: the paper's stream ablations, stacked GRUs, snippet pooling, the
# appearance stride and a backbone input of the crop's own size
VARIANTS = {"micro": ({"streams": "micro"}, {}),
            "macro": ({"streams": "macro"}, {}),
            "gru_layers2": ({"gru_layers": 2}, {}),
            "snippet4": ({"snippet_len": 4}, {}),
            "stride2": ({}, {"appearance_stride": 2}),
            "backbone112": ({}, {"input_size": S})}
VARIANT_CLIP_T = 8          # frames of the card-vs-CPU clip
# streamed chunks against the whole clip, fp32 on the card (max-rel)
VARIANT_STREAM_REL_TOL = 1e-5


def variant_config(name: str, dtype: str) -> MimamoConfig:
    temporal, backbone = VARIANTS[name]
    return MimamoConfig(backbone=BackboneSpec(dtype=dtype, **backbone),
                        temporal=TemporalSpec(**temporal))


def variant_launches(cfg: MimamoConfig) -> dict:
    """Launches of one forward of ``cfg``: the phase kernel where the micro
    stream runs; where the macro stream runs, the stem kernel of the dtype
    when the backbone input is twice the crop, layer2's 4 in bf16 and the
    epilogues of one backbone call."""
    spec, bb = cfg.temporal, cfg.backbone
    fp32 = bb.dtype == "float32"
    stem = spec.use_macro and bb.input_size == 2 * S
    return {"phase_diff_resize": int(spec.use_micro),
            "stem_fused": int(stem and not fp32),
            "layer2_fused": 4 * int(spec.use_macro and not fp32),
            "stem_fused[f32]": int(stem and fp32),
            "layer1_dots": 0, "layer2_g4_dots": 0,
            "bottleneck_epilogue": epilogue_launches(fp32)
            * int(spec.use_macro)}


class FramesSeen:
    """Inside the block, counts the frames that reach the stem and layer2
    kernel wrappers (the backbone calls them through their modules)."""

    def __enter__(self):
        self.frames = {"stem": 0, "layer2": 0}
        self._real = (stem_kernel.stem_fused, layer2_kernel.layer2_fused)

        def stem(crops, *args):
            self.frames["stem"] += crops.shape[0]
            return self._real[0](crops, *args)

        def layer2(x, blocks):
            self.frames["layer2"] += x.shape[0]
            return self._real[1](x, blocks)

        stem_kernel.stem_fused, layer2_kernel.layer2_fused = stem, layer2
        return self

    def __exit__(self, *exc):
        stem_kernel.stem_fused, layer2_kernel.layer2_fused = self._real


# a phase-stack value that moved by more than this between two runs of the
# phase stage on the same frames took a source pixel's phase difference
# across the +-pi wrap: none may between two runs on the card (the stage
# gives a frame the same bits whatever its batch: check_fft_invariance);
# between the card and the CPU, whose FFTs differ, some do
PHASE_JUMP = 0.1


def phase_jumps(a: torch.Tensor, b: torch.Tensor) -> int:
    return int(((a.float().cpu() - b.float().cpu()).abs() > PHASE_JUMP).sum())


def chunk_inputs(model: Mimamo, clips: np.ndarray, start: int,
                 context: bool = True) -> torch.Tensor:
    """The frames a session feeds for the chunk at ``start`` (with its
    context frame: the frame before, or its own first frame for a fresh
    slot), as float32 on the model's device."""
    x = torch.from_numpy(clips[:, start:start + CHUNK])
    if context:
        ctx = clips[:, max(start - 1, 0):max(start, 1)]
        x = torch.cat([torch.from_numpy(ctx), x], dim=1)
    return x.to(model.device).float()


def variant_stream(model: Mimamo, state: dict, clips: np.ndarray) -> dict:
    """The fp32 variant streamed on the card (a session of 8 slots fed
    chunks of 16) against its ``predict_clips``.

    A chunk's phase stage runs on another batch than the whole clip's and
    must give the same stacks: no value may jump (``phase_jumps``) between
    two runs on the card. Gated:
      * stride 1 (stacked GRUs): the temporal model over the whole clip's
        own phase stacks and embeddings, chunk by chunk with its carries,
        against one pass (VARIANT_STREAM_REL_TOL); the session against
        ``predict_clips`` (the same bound, no jump);
      * stride k > 1, where each chunk anchors on its own grid after its
        context frame (as in the JAX package): every chunk's embeddings on
        the card against the CPU (the ``fp32`` phase's embedding gate);
        ``predict_stream``'s first chunk (clip mode) against
        ``predict_clips`` before its first anchor clamp (no jump, the same
        bound); the session's first two chunks of one slot against a CPU
        session at the output gate, except where the CPU's FFT put a phase
        difference on the other side of the +-pi wrap (reported). Raises
        past a gate."""
    whole = model.predict_clips(clips).cpu().numpy()
    _sess, streamed = fill_session(model, clips)
    x = torch.from_numpy(clips).cuda().float()
    stacks = model._micro_motion(to_grayscale(x))
    k = model.config.backbone.appearance_stride
    out = {}
    if k == 1:
        emb = model.embed_frames(x)
        full, _ = model.temporal(stacks, emb)
        parts, carries = [], None
        for start in range(0, T, CHUNK):
            pairs = stacks[:, max(start - 1, 0):start + CHUNK - 1]
            o, carries = model.temporal(pairs, emb[:, start:start + CHUNK],
                                        carries, num_frames=CHUNK)
            parts.append(o)
        jumps = 0
        for start in range(0, T, CHUNK):
            chunk = model._micro_motion(to_grayscale(
                chunk_inputs(model, clips, start)))
            if start == 0:
                chunk = chunk[:, 1:]       # pair 0 is the frame with itself
            jumps += phase_jumps(
                chunk, stacks[:, max(start - 1, 0):start + CHUNK - 1])
        out.update({
            "temporal_chunked_vs_whole_max_rel": max_rel(
                torch.cat(parts, dim=1), full),
            "session_vs_clips_max_rel": max_rel(streamed, whole),
            "session_phase_jumps": jumps})
        ok = (out["temporal_chunked_vs_whole_max_rel"]
              <= VARIANT_STREAM_REL_TOL and jumps == 0
              and out["session_vs_clips_max_rel"] <= VARIANT_STREAM_REL_TOL)
    else:
        f_star = k * (-(-CHUNK // k) - 1) + 1
        first, _ = model.predict_stream(clips[:, :CHUNK])
        first_jumps = phase_jumps(model._micro_motion(to_grayscale(
            x[:, :CHUNK])), stacks[:, :CHUNK - 1])
        cpu = Mimamo(model.config, device="cpu")
        cpu.load_state_dict(state)
        emb_rel = 0.0
        for start in range(0, T, CHUNK):
            frames = chunk_inputs(model, clips, start)
            emb_rel = max(emb_rel, max_rel(
                model.embed_frames(frames)[:, 1:].cpu(),
                cpu.embed_frames(frames.cpu())[:, 1:]))
        sess = StreamingSession(cpu, capacity=1, chunk=CHUNK, dtype=np.uint8)
        slot = sess.add_stream()
        cpu_stream = np.concatenate([
            sess.feed({slot: clips[0, start:start + CHUNK]})[slot]
            for start in (0, CHUNK)])
        session_jumps = sum(phase_jumps(
            model._micro_motion(to_grayscale(chunk_inputs(model, clips,
                                                          start)[:1])),
            cpu._micro_motion(to_grayscale(chunk_inputs(cpu, clips,
                                                        start)[:1])))
            for start in (0, CHUNK))
        del sess, cpu
        out.update({
            "chunk_emb_card_vs_cpu_max_rel": emb_rel,
            "first_chunk_vs_clips_before_clamp_max_rel": max_rel(
                first[:, :f_star].cpu(), whole[:, :f_star]),
            "first_clamp_frame": f_star, "first_chunk_phase_jumps":
            first_jumps,
            "session_card_vs_cpu_max_rel": max_rel(streamed[0, :2 * CHUNK],
                                                   cpu_stream),
            "session_card_vs_cpu_phase_jumps": session_jumps,
            "seam_drift_max_abs": float(np.abs(streamed - whole).max()),
            "clips_max_abs": float(np.abs(whole).max())})
        ok = (emb_rel <= FP32_EMB_REL_TOL and first_jumps == 0
              and out["first_chunk_vs_clips_before_clamp_max_rel"]
              <= VARIANT_STREAM_REL_TOL
              and (session_jumps or out["session_card_vs_cpu_max_rel"]
                   <= FP32_OUT_REL_TOL))
    if not ok:
        raise AssertionError(f"variant streaming at stride {k}: {out}")
    return out


def check_variants(line: str) -> tuple:
    """Each of VARIANTS through ``predict_clips`` at the flagship step
    (B x T of 112^2 crops) in bf16 and fp32, random weights of the variant
    from SEED: finite values of the right shape, the launches of one
    forward (:func:`variant_launches`), the frames reaching the stem and
    layer2 wrappers (B x ceil(T / k) at stride k, none without the macro
    stream), the step time and the backbone's device time; the fp32 card
    against the CPU on one clip x 8 frames (the ``fp32`` phase's gates);
    the fp32 streaming path at ``gru_layers2`` and ``stride2``
    (:func:`variant_stream`); layer2 against its plain version on the
    14 x 14 grid of ``backbone112`` (record ``layer2_fused@backbone112``).
    Returns (records, report)."""
    rng = np.random.default_rng(SEED + 40)
    clips = rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
    small = clips[:1, :VARIANT_CLIP_T]
    recs, report = [], {"card": line}
    for name in VARIANTS:
        row = report[name] = {}
        cfg32 = variant_config(name, "float32")
        spec, k = cfg32.temporal, cfg32.backbone.appearance_stride
        state = weights.init_variables(cfg32, SEED)
        cpu = Mimamo(cfg32, device="cpu")
        cpu.load_state_dict(state)
        with torch.no_grad():
            cpu_out = cpu.predict_clips(small)
            cpu_emb = (cpu.embed_frames(torch.from_numpy(small).float())
                       if spec.use_macro else None)
        del cpu
        frames = B * -(-T // k) if spec.use_macro else 0
        for dtype in ("bfloat16", "float32"):
            cfg = variant_config(name, dtype)
            model = Mimamo(cfg)
            model.load_state_dict(state)
            with torch.no_grad():
                model.predict_clips(clips)                   # warm-up
                torch.cuda.synchronize()
                with FramesSeen() as seen:
                    out, launches = counted(lambda: model.predict_clips(clips),
                                            variant_launches(cfg))
                want_frames = {
                    "stem": frames if cfg.backbone.input_size == 2 * S else 0,
                    "layer2": frames if dtype == "bfloat16" else 0}
                if (tuple(out.shape) != (B, T, 2)
                        or not torch.isfinite(out).all()
                        or seen.frames != want_frames):
                    raise AssertionError(
                        f"variant {name} {dtype}: {tuple(out.shape)}, "
                        f"frames {seen.frames} != {want_frames}")
                times = clip_step_ms(model, clips)
                x = torch.from_numpy(clips).cuda().float()
                row[dtype] = {
                    "step_ms": statistics.median(times), "steps_ms": times,
                    "frames_per_s": B * T / statistics.median(times) * 1e3,
                    "launches": launches, "kernel_frames": seen.frames,
                    "backbone_ms": (time_ms(lambda: model.embed_frames(x),
                                            iters=3, batch=2)
                                    if spec.use_macro else 0.0)}
                if dtype == "float32":
                    row["fp32_card_vs_cpu_out_max_rel"] = max_rel(
                        model.predict_clips(small).cpu(), cpu_out)
                    if spec.use_macro:
                        row["fp32_card_vs_cpu_emb_max_rel"] = max_rel(
                            model.embed_frames(torch.from_numpy(
                                small).cuda().float()).cpu(), cpu_emb)
                    if name in ("gru_layers2", "stride2"):
                        row["stream"] = variant_stream(model, state, clips)
                if name == "backbone112" and dtype == "bfloat16":
                    rec = check_layer2(x.reshape(B * T, S, S, 3), model,
                                       "layer2_fused@backbone112",
                                       plain_batch=2)
                    rec["backbone_size"] = S
                    rec["launches"] = launches["layer2_fused"]
                    recs.append(rec)
                del x
            del model
            torch.cuda.empty_cache()
        print(json.dumps({"variant": name, **row, "card": line}),
              flush=True)
        if not (row["fp32_card_vs_cpu_out_max_rel"] <= FP32_OUT_REL_TOL
                and row.get("fp32_card_vs_cpu_emb_max_rel", 0.0)
                <= FP32_EMB_REL_TOL):
            raise AssertionError(f"variant {name}: fp32 card and CPU "
                                 f"disagree: {row}")
    return recs, report


def _dag_sources(cfg: MimamoConfig) -> tuple:
    """Seeded reference-shaped sources: a ResNet-50 ``state_dict`` under
    the FER+ MatConvNet ``dag`` names (1x1-conv classifier, BN counters)
    and a two-stream one in the canonical schema, as numpy; conv and
    linear weights at 1 / sqrt(fan_in), BN near identity."""
    from mimamo_tpu_torch.backbone import ResNet50, ferplus_dag_rename
    from mimamo_tpu_torch.temporal import TwoStreamRNN
    rng = np.random.default_rng(SEED + 40)

    def values(module):
        with torch.device("meta"):
            shapes = {k: tuple(v.shape)
                      for k, v in module().state_dict().items()}
        out = {}
        for k, shape in shapes.items():
            if k.endswith("num_batches_tracked"):
                out[k] = np.zeros((), np.int64)
            elif k.endswith("running_var"):
                out[k] = (0.5 + rng.random(shape)).astype(np.float32)
            elif len(shape) == 1:
                scale = k[:-len("weight")] + "running_var" in shapes
                out[k] = (float(scale) + 0.1 * rng.standard_normal(
                    shape)).astype(np.float32)
            else:
                out[k] = (rng.standard_normal(shape) / np.sqrt(
                    np.prod(shape[1:]))).astype(np.float32)
        return out

    inv = {v: k for k, v in ferplus_dag_rename().items()}
    dag = {}
    for k, v in values(lambda: ResNet50(cfg.backbone)).items():
        if k.endswith("num_batches_tracked"):
            mod = inv[k.replace("num_batches_tracked", "running_mean")]
            dag[mod.replace("running_mean", "num_batches_tracked")] = v
        else:
            dag[inv[k]] = v.reshape(v.shape + (1, 1)) if k == "fc.weight" \
                else v
    temporal = values(lambda: TwoStreamRNN(
        cfg.temporal, cfg.num_phase, cfg.phase.phase_size,
        cfg.backbone.feature_dim))
    return dag, temporal


def check_convert(line: str) -> dict:
    """``cli convert --verify`` on the card of a seeded ``dag``-named
    backbone ``.pth`` (with MatConvNet meta) and a two-stream ``.pth`` at
    the default config, then ``cli predict --crops --ckpt`` of 16 frames
    (clips of 8 at stride 4: one forward) on the card against ``--cpu``
    and the checkpoint's embeddings card against CPU, at the ``fp32``
    phase's gates. Returns the report with the launches of the card's
    ``cli predict``."""
    import contextlib
    import io
    from mimamo_tpu_torch import cli
    cfg = MimamoConfig()
    dag, temporal = _dag_sources(cfg)
    report = {"card": line}
    with tempfile.TemporaryDirectory() as tmp:
        bb, tp = os.path.join(tmp, "bb.pth"), os.path.join(tmp, "ts.pth")
        torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                                   for k, v in dag.items()},
                    "meta": {"mean": list(cfg.backbone.mean_rgb),
                             "std": [1.0, 1.0, 1.0],
                             "imageSize": [224, 224, 3],
                             "imageOrder": "rgb"}}, bb)
        torch.save({k: torch.from_numpy(np.array(v))
                    for k, v in temporal.items()}, tp)
        ckpt = os.path.join(tmp, "ckpt")
        out, err = io.StringIO(), io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["convert", "--backbone-pth", bb, "--temporal-pth",
                           tp, "--out", ckpt, "--verify"] + CLI_FLAGS)
        report["convert_wall_ms"] = (time.perf_counter() - t) * 1e3
        if rc != 0:
            raise AssertionError(f"cli convert returned {rc}")
        report["convert"] = json.loads(out.getvalue().splitlines()[-1])
        report["verify"] = json.loads(next(
            x for x in err.getvalue().splitlines()
            if x.startswith('{"verify"')))["verify"]
        if sorted(report["verify"]) != ["backbone_embeddings",
                                        "backbone_logits",
                                        "temporal_outputs"]:
            raise AssertionError(f"convert --verify: {report['verify']}")
        crops = os.path.join(tmp, "crops.npy")
        np.save(crops, np.random.default_rng(SEED + 41).integers(
            0, 256, (16, S, S, 3), dtype=np.uint8))
        argv = ["predict", "--crops", crops, "--ckpt", ckpt, "--clip-len",
                "8", "--stride", "4"]
        card_csv, cpu_csv = (os.path.join(tmp, f"{d}.csv")
                             for d in ("card", "cpu"))
        _, report["launches_cli_predict"] = counted(
            lambda: run_cli(argv + ["--out", card_csv]),
            expected_launches(1, fp32=True))
        run_cli(argv + ["--out", cpu_csv, "--cpu"])
        report["predict_card_vs_cpu_max_rel"] = max_rel(
            read_csv(card_csv)[:, 1:], read_csv(cpu_csv)[:, 1:])
        state = checkpoints.load(ckpt)["model"]
        clip = torch.from_numpy(np.load(crops)[None]).float()
        embs = []
        for device in ("cuda", "cpu"):
            model = Mimamo(cfg, device=device)
            model.load_state_dict(state)
            with torch.no_grad():
                embs.append(model.embed_frames(clip.to(device)).cpu())
            del model
        report["emb_card_vs_cpu_max_rel"] = max_rel(*embs)
    report["tol"] = [FP32_EMB_REL_TOL, FP32_OUT_REL_TOL]
    print(json.dumps({"convert_phase": report}), flush=True)
    if not (report["emb_card_vs_cpu_max_rel"] <= FP32_EMB_REL_TOL
            and report["predict_card_vs_cpu_max_rel"] <= FP32_OUT_REL_TOL):
        raise AssertionError("convert: the converted checkpoint's card and "
                             "CPU forwards disagree beyond tolerance")
    return report


# -- data parallelism ---------------------------------------------------------

# A world of one against the plain path (the same computation: every
# collective reduces to the local path), and eval on 2 ranks against one
# process (each video alone in its stream on both sides; moment sums
# against the host CCC).
PARALLEL_ATOL = 1e-6
PARALLEL_LOSS_ATOL = 1e-5    # the 2-rank dry run's step against a world of 1
PARALLEL_B = 7               # predict_batch's clips (padded to the world)
PARALLEL_TIMEOUT = 300       # the phase's rank processes, seconds
# cli train on 2 ranks against one process stepping the union of their
# slices, 2 steps at lr 1e-6: Adam's first update moves an element whose
# gradient is rounding noise by lr either way, with a sign that the
# summation order decides, and at the default lr (1e-4) that moved the
# second step's metrics by 6e-4 on the card. The ranks' phase stacks equal
# the one process's (the phase stage does not depend on the batch), so the
# moments agree to rounding (cosine 1 - 4e-8 on an H100). The gates are
# set between that noise and the faults they are for. Rows
# (rounded to 4 decimals); Adam's first moments as one vector: cosine and
# norm ratio (a gradient not divided by the world doubles the norm; local
# BatchNorm statistics turn its direction); the temporal BN running stats
# (local statistics move them by ~1e-2); every parameter within 2 lr a
# step.
PARALLEL_LR = 1e-6
PARALLEL_ROW_ATOL = 1e-4
PARALLEL_MOMENT_COS = 0.999
PARALLEL_MOMENT_NORM_TOL = 0.01
PARALLEL_BN_ATOL = 1e-4


def manifest_rows(root: str, pattern: str) -> list:
    """(video name, status, frames) of every row of the manifests that
    ``pattern`` matches under ``root``, sorted."""
    rows = []
    for path in glob.glob(os.path.join(root, pattern)):
        with open(path) as f:
            rows += [(os.path.basename(r["video"]), r["status"],
                      r.get("frames")) for r in map(json.loads, f)]
    return sorted(rows)


def csv_diff(a: str, b: str) -> float:
    """max |a - b| of two series CSVs (inf when one is missing)."""
    if not (os.path.exists(a) and os.path.exists(b)):
        return float("inf")
    return float(np.abs(read_csv(a) - read_csv(b)).max())


def wall_ms(fn, n: int) -> list:
    """Host times (ms) of ``n`` calls, each ending in a synchronize."""
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def train_union(root: str, world: int) -> tuple:
    """What ``cli train --epochs 1 --lr PARALLEL_LR`` at the default config
    does on ``world`` ranks, in one process on the card: each step over the
    concatenation of the ranks' batches (``fit``'s draws, rank by rank).
    Returns (the epoch's mean metrics, the model's state_dict, the
    optimizer's state_dict, :func:`rank_stacks` of the first step)."""
    cfg = dataclasses.replace(MimamoConfig(), train=TrainSpec(
        epochs=1, learning_rate=PARALLEL_LR))
    spec = cfg.train
    ds = datasets.AffWild2Dataset(root, clip=cfg.clip)
    local = spec.batch_size // world
    steps = (len(ds) // world) // local
    draws = [ds.batches(local, shuffle=True, seed=spec.seed,
                        drop_remainder=True, process_id=r,
                        process_count=world) for r in range(world)]
    model = Mimamo(cfg)
    model.load_state_dict(weights.init_variables(cfg, spec.seed))
    st = train.create_train_state(model, total_steps=steps)
    step = train.make_train_step(model)
    agg, stacks = {}, None
    for _ in range(steps):
        parts = [next(d) for d in draws]
        if stacks is None:
            stacks = rank_stacks(model, [p["clips"] for p in parts])
        _, metrics = step(st, {k: np.concatenate([p[k] for p in parts])
                               for k in parts[0]})
        for k, v in metrics.items():
            agg[k] = agg.get(k, 0.0) + float(v) / steps
    agg["steps"] = steps
    return agg, model.state_dict(), st.optimizer.state_dict(), stacks


def rank_stacks(model: Mimamo, clips: list) -> dict:
    """Each rank's phase stacks (its own ``clips``, as its train step makes
    them) against one process's over the concatenation: unequal elements
    and whether all are bitwise equal."""
    def stacks(x):
        return model._micro_motion(to_grayscale(
            torch.from_numpy(np.ascontiguousarray(x)).cuda().float()))

    with torch.no_grad():
        whole = stacks(np.concatenate(clips))
        unequal, first = 0, 0
        for x in clips:
            got = stacks(x)
            unequal += fft_invariance.unequal(got,
                                              whole[first:first + len(x)])
            first += len(x)
    return {"equal": unequal == 0, "unequal": unequal}


def check_train_ranks(ckpt: str, results: list, union: tuple) -> dict:
    """``cli train`` on 2 ranks (``results``, checkpoint and log under
    ``ckpt``) against :func:`train_union`."""
    want, want_model, want_opt, stacks = union
    rows = [res.lines[-1] if res.rc == 0 and res.lines else None
            for res in results]
    report = {"rows": rows, "one_process": want,
              "phase_stacks_ranks_vs_one": stacks}
    if None in rows or not os.path.isdir(ckpt):
        return report
    saved = checkpoints.load(ckpt)
    with open(ckpt + ".metrics.jsonl") as f:
        log = [json.loads(x) for x in f]
    moments = saved["optimizer"]["state"]
    report.update({
        "rows_equal": all({k: v for k, v in r.items() if k != "sec"}
                          == {k: v for k, v in rows[0].items() if k != "sec"}
                          for r in rows),
        "log_rows": len(log),
        "steps": [rows[0]["steps"], want["steps"], saved["step"]],
        "row_max_abs": max(abs(rows[0][k] - want[k])
                           for k in ("loss", "ccc_v", "ccc_a")),
        "adam_m_cos_norm_ratio": dryrun.grad_agreement(
            {i: moments[i]["exp_avg"].cpu() for i in want_opt["state"]},
            {i: m["exp_avg"].cpu() for i, m in want_opt["state"].items()}),
        "bn_stats_max_abs": state_diff(saved["model"], want_model, [
            k for k in want_model if "running" in k]),
        "params_max_abs": state_diff(saved["model"], want_model, [
            k for k in want_model if "running" not in k
            and "num_batches" not in k])})
    return report


def train_ranks_ok(r: dict) -> bool:
    lr = PARALLEL_LR
    return ("rows_equal" in r and r["rows_equal"] and r["log_rows"] == 1
            and len(set(r["steps"])) == 1 and r["steps"][0] >= 2
            and r["row_max_abs"] <= PARALLEL_ROW_ATOL
            and r["adam_m_cos_norm_ratio"][0] >= PARALLEL_MOMENT_COS
            and abs(r["adam_m_cos_norm_ratio"][1] - 1)
            <= PARALLEL_MOMENT_NORM_TOL
            and r["bn_stats_max_abs"] <= PARALLEL_BN_ATOL
            and r["params_max_abs"] <= 2 * lr * r["steps"][0] + 1e-6)


def check_parallel(state: dict, line: str) -> dict:
    """Data parallelism (docstring item 16). Returns rank 0's row of the
    2-rank dry run, whose ``launches_train`` and ``launches_predict_batch``
    are that rank's launches in one train step and one ``predict_batch``
    per dtype."""
    report = {"card": line}
    rng = np.random.default_rng(SEED + 50)
    with tempfile.TemporaryDirectory() as tmp:
        media = slice_media(tmp)
        root = media["aff"]
        rows, saved = {}, {}
        # port 0: a world of one needs no peer to find its store; the same
        # computation, so both on deterministic algorithms
        with deterministic_algorithms():
            for name, flags in (("plain", []), ("world1", [
                    "--data-parallel", "--coordinator", "127.0.0.1:0",
                    "--num-processes", "1", "--process-id", "0"])):
                ckpt = os.path.join(tmp, name)
                rows[name] = run_cli(["train", "--dataset", "affwild2",
                                      "--root", root, "--epochs", "1",
                                      "--ckpt", ckpt] + flags)
                saved[name] = checkpoints.load(ckpt)["model"]
        report["cli_train_rows"] = rows
        report["cli_train_world1_vs_plain"] = {
            "rows_max_abs": max(
                abs(a[k] - b[k]) for a, b in zip(rows["plain"],
                                                 rows["world1"])
                for k in a if k != "sec" and isinstance(a[k], float)),
            "steps_equal": [r["steps"] for r in rows["plain"]]
            == [r["steps"] for r in rows["world1"]],
            "ckpt_max_abs": state_diff(saved["world1"], saved["plain"])}

        # the cost of forming the group: a world of one over NCCL (every
        # collective takes the local path), the plain path beside it
        group = parallel.initialize_distributed("127.0.0.1:0", 1, 0)
        with group:
            probe = torch.ones(3, device=group.device)
            torch.distributed.all_reduce(probe)
            report["world1"] = {"backend": group.backend,
                                "device": str(group.device),
                                "all_reduce_ok": bool((probe == 1).all())}
            batch = next(datasets.AffWild2Dataset(
                root, clip=MimamoConfig().clip).batches(
                    MimamoConfig().train.batch_size))
            _, st_p, step_p = _train_model(state)
            model_g, st_g, _ = _train_model(state)
            step_g = train.make_train_step(model_g, group)
            step_p(st_p, batch)                              # warm-up
            step_g(st_g, batch)
            times = {"plain": [], "world1": []}
            for name in ("plain", "world1", "world1", "plain"):
                step, st = ((step_p, st_p) if name == "plain"
                            else (step_g, st_g))
                times[name] += step_ms(step, st, batch, 3)
            report["train_step_ms"] = {k: statistics.median(v)
                                       for k, v in times.items()}
            del model_g, st_g, st_p
            clips = rng.integers(0, 256, (PARALLEL_B, T, S, S, 3),
                                 dtype=np.uint8)
            report["predict_batch"] = {}
            for dtype in ("bfloat16", "float32"):
                model = Mimamo(MimamoConfig(backbone=BackboneSpec(
                    dtype=dtype)))
                model.load_state_dict(state)
                want = model.predict_clips(clips)
                got = model.predict_batch(clips, group)
                times = {"plain": [], "world1": []}
                for name in ("plain", "world1", "world1", "plain"):
                    fn = ((lambda: model.predict_clips(clips))
                          if name == "plain"
                          else (lambda: model.predict_batch(clips, group)))
                    times[name] += wall_ms(fn, 3)
                report["predict_batch"][dtype] = {
                    "shape": list(got.shape),
                    "vs_predict_clips_max_abs": (got - want).abs().max()
                    .item(),
                    "ms": {k: statistics.median(v) for k, v in
                           times.items()}}
                del model
        torch.cuda.empty_cache()

        # two ranks sharing the card (gloo), all started at once: the dry
        # run, cli train, cli eval and cli predict-corpus (each clip alone
        # in its batch, as in one process); one process of each command
        # beside them
        train_ckpt = os.path.join(tmp, "two_train")
        eval_argv = ["eval", "--dataset", "affwild2", "--root", root,
                     "--ckpt", os.path.join(tmp, "plain"),
                     "--batch-streams", "1"]
        corpus_argv = ["predict-corpus", "--videos",
                       os.path.join(media["dir"], "*.mp4"), "--ckpt",
                       os.path.join(tmp, "plain"), "--no-native", "--batch",
                       "1", "--out-dir"]
        # eight rank processes and this one share the host's cores: one
        # thread each
        kw = {"timeout": PARALLEL_TIMEOUT,
              "env": dict(os.environ, OMP_NUM_THREADS="1")}
        t = time.perf_counter()
        launched = {
            "dryrun": dryrun.start(2, **kw),
            "train": dryrun.cli_ranks(
                ["train", "--dataset", "affwild2", "--root", root,
                 "--epochs", "1", "--lr", str(PARALLEL_LR), "--ckpt",
                 train_ckpt] + CLI_FLAGS, 2, **kw),
            "eval": dryrun.cli_ranks(eval_argv + CLI_FLAGS, 2, **kw),
            "corpus": dryrun.cli_ranks(
                corpus_argv + [os.path.join(tmp, "two")] + CLI_FLAGS, 2,
                **kw)}
        try:
            (one,) = run_cli(eval_argv)
            (corpus_one,) = run_cli(corpus_argv + [os.path.join(tmp, "one")])
            union = train_union(root, 2)
        finally:
            results = {k: ranks.wait() for k, ranks in launched.items()}
        report["world2_s"] = time.perf_counter() - t
        report["train_two_ranks"] = check_train_ranks(
            train_ckpt, results["train"], union)
        corpus = results["corpus"]
        report["corpus_two_ranks"] = {
            "summaries": [res.lines[-1] if res.lines else None
                          for res in corpus],
            "manifest": manifest_rows(tmp, "two/manifest.p*.jsonl"),
            "one_process": corpus_one,
            "one_process_manifest": manifest_rows(tmp, "one/manifest.jsonl"),
            "csv_vs_one_max_abs": max(csv_diff(
                os.path.join(tmp, "two", f"v{i}.csv"),
                os.path.join(tmp, "one", f"v{i}.csv"))
                for i in range(len(CORPUS_T)))}
    dry_rows = dryrun.rows(results["dryrun"])
    report["dryrun"] = dry_rows
    report["eval_one_process"] = one
    report["eval_two_ranks"] = [res.lines[-1] if res.lines else None
                                for res in results["eval"]]
    report["eval_two_ranks_vs_one_max_abs"] = max(
        (abs(r[k] - one[k]) if r else float("inf"))
        for r in report["eval_two_ranks"]
        for k in ("valence_ccc", "arousal_ccc", "mean_ccc"))
    print(json.dumps({"parallel_phase": report}), flush=True)
    tr = report["train_two_ranks"]
    print(json.dumps({
        "parallel_phase_stacks_ranks_vs_one": tr[
            "phase_stacks_ranks_vs_one"],
        "parallel_adam_m_cos_norm_ratio": tr.get("adam_m_cos_norm_ratio"),
        "card": line}), flush=True)
    w1 = report["cli_train_world1_vs_plain"]
    co = report["corpus_two_ranks"]
    sub = lambda d: {k: d[k] for k in dryrun.KERNELS}  # noqa: E731
    ok = (report["world1"]["backend"] == "nccl"
          and report["world1"]["all_reduce_ok"]
          and w1["rows_max_abs"] <= PARALLEL_ATOL and w1["steps_equal"]
          and w1["ckpt_max_abs"] <= PARALLEL_ATOL
          and all(r["shape"] == [PARALLEL_B, T, 2]
                  and r["vs_predict_clips_max_abs"] <= PARALLEL_ATOL
                  for r in report["predict_batch"].values())
          and None not in dry_rows and len(dry_rows) == 2
          and all(r["ok"] and r["backend"] == "gloo"
                  and max(r[f"{s}_loss_world1_abs"] for s in dryrun.STEPS)
                  <= PARALLEL_LOSS_ATOL
                  and r["launches_train"] == sub(expected_launches(
                      fp32=True))
                  and r["launches_predict_batch"]["float32"]
                  == sub(expected_launches(fp32=True))
                  and r["launches_predict_batch"]["bfloat16"]
                  == sub(expected_launches())
                  for r in dry_rows)
          and dryrun.same_params(dry_rows)
          and train_ranks_ok(report["train_two_ranks"])
          and all(res.rc == 0 for res in results["eval"])
          and all(r is not None and r["n_frames"] == one["n_frames"]
                  for r in report["eval_two_ranks"])
          and report["eval_two_ranks_vs_one_max_abs"] <= PARALLEL_ATOL
          and all(res.rc == 0 for res in corpus)
          and [r and r["videos"] for r in co["summaries"]] == [2, 1]
          and co["manifest"] == co["one_process_manifest"]
          and len(co["manifest"]) == len(CORPUS_T)
          and co["one_process"]["videos"] == len(CORPUS_T)
          and co["csv_vs_one_max_abs"] <= SLICE_ATOL)
    if not ok:
        for tag, ranks in results.items():
            for r, res in enumerate(ranks):
                print(f"{tag}{r} (exit {res.rc}) stderr: {res.err}",
                      file=sys.stderr)
        raise AssertionError(f"parallel phase: {report}")
    return dry_rows[0]


# -- the JAX package's last modules: the torchvision stride placement, bf16
# fine-tuning, the pyramid's build / reconstruct, the examples ---------------

A16B_CLIP_T = 8              # frames of the stride variant's card-vs-CPU clip
A16B_EXAMPLES_TIMEOUT = 300  # seconds, each example's process
# The bf16 fine-tune step against the fp32 step on the same batch and
# weights (PERF.md §6). The gradient's direction moves far with bf16's
# rounding (seen on an H100: backbone cosine 0.076, temporal 0.94), while
# an fp32 step on clips moved by 1e-3 keeps it (0.998): the fp32 step on
# clips moved by FINETUNE_PERTURB, the size of bf16's rounding of the
# backbone input (its spacing at 128..255 is 1), is reported beside it.
# What is held: the loss, the norms of the backbone's and the temporal
# gradients, and the temporal gradient's direction.
FINETUNE_PERTURB = 0.5
FINETUNE_BF16_LOSS_ATOL = 1e-2
FINETUNE_BF16_COS = 0.8
FINETUNE_BF16_NORM_TOL = 5e-2
PYRAMID_REC_TOL = 1e-3       # reconstruction rel-err (tests/test_pyramid.py)
PYRAMID_CARD_CPU_TOL = 1e-5  # bands, high, low: max |d| / max |CPU|


def stride_backbone(state: dict, dtype: str, device: str):
    """``FoldedResNet50(stride_in_1x1=False)`` of the backbone weights in
    ``state`` on ``device``."""
    return backbone_of(state, dtype, device, stride_in_1x1=False)


def a16b_stride(state: dict, line: str) -> tuple:
    """The torchvision placement in bf16 at B x T frames: the launches of
    one backbone call (stem 1, layer2 3: block 0 runs as cuDNN convs), the
    layer2 tail against ``layer2_plain`` (record ``layer2_tail``: 3 blocks'
    work, 3 cuDNN bottlenecks as the library call), the backbone's time
    beside the default placement's; in fp32 the card against the CPU on one
    clip x A16B_CLIP_T frames (the ``fp32`` phase's gates). Returns
    (record, report, launches)."""
    rng = np.random.default_rng(SEED + 60)
    crops = torch.from_numpy(rng.integers(0, 256, (B * T, S, S, 3),
                                          dtype=np.uint8)).cuda().float()
    report = {"card": line}
    folded = stride_backbone(state, "bfloat16", "cuda")
    cfg = MimamoConfig()
    default = Mimamo(dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype="bfloat16")))
    default.load_state_dict(state)
    with torch.no_grad():
        folded(crops)                                        # warm-up
        torch.cuda.synchronize()
        (emb, _), launches = counted(lambda: folded(crops), dict(
            expected_launches(0), stem_fused=1, layer2_fused=3,
            bottleneck_epilogue=epilogue_launches() + 3))
        report["finite"] = bool(torch.isfinite(emb).all())
        report["backbone_ms"] = time_ms(lambda: folded(crops), iters=3,
                                        batch=2)
        ref = default._backbone_folded()
        report["default_placement_backbone_ms"] = time_ms(
            lambda: ref(crops), iters=3, batch=2)
        del default, ref
        x = folded._stage(folded._stage(folded.run_stem(crops), 1), 2)
        x = x.permute(0, 2, 3, 1).contiguous()          # block 0's output
        tail = folded.layer2
        got = layer2_kernel.layer2_fused(x, tail)
        want = layer2_kernel.layer2_plain(x, tail)
        errs = errors(got, want)
        lib = [{conv: (c.weight.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last), c.bias.to(torch.bfloat16),
            c.stride, c.weight.shape[1] // 2) for conv, c in blk.items()}
            for blk in tail]

        def library():
            v = x.permute(0, 3, 1, 2)
            for blk in lib:
                v = bottleneck_epilogue.bottleneck_library(v, blk)
            return v

        pixels = got.shape[0] * got.shape[1] * got.shape[2]
        flops = sum(2.0 * pixels * c.weight.numel()
                    for blk in tail for c in blk.values())
        nbytes = x.numel() * 2 + got.numel() * 2 + sum(
            c.weight.numel() * 2 + c.bias.numel() * 4
            for blk in tail for c in blk.values())
        del got, want
        rec = record("layer2_tail", "mimamo_tpu_torch/csrc/layer2.cu",
                     "mimamo_tpu/pallas/layer2_kernel.py:174", errs,
                     {"tol_max_rel": BF16_REL_TOL},
                     time_ms(lambda: layer2_kernel.layer2_fused(x, tail)),
                     time_ms(lambda: layer2_kernel.layer2_plain(x, tail),
                             batch=2),
                     nbytes, flops, time_ms(library))
        rec["launches"] = launches["layer2_fused"]
        rec["blocks"] = len(tail)
        del x, folded
        torch.cuda.empty_cache()
        small = crops[:A16B_CLIP_T]
        card32 = stride_backbone(state, "float32", "cuda")
        (card_emb, card_logits), report["launches_fp32"] = counted(
            lambda: card32(small), dict(
                expected_launches(0), **{"stem_fused[f32]": 1},
                bottleneck_epilogue=epilogue_launches(fp32=True)))
        cpu_emb, cpu_logits = stride_backbone(state, "float32", "cpu")(
            small.cpu())
        report["fp32_card_vs_cpu_emb_max_rel"] = max_rel(card_emb.cpu(),
                                                         cpu_emb)
        report["fp32_card_vs_cpu_logits_max_rel"] = max_rel(
            card_logits.cpu(), cpu_logits)
        del card32
    report["launches"] = launches
    if not (report["finite"] and errs["max_rel_err"] < BF16_REL_TOL
            and report["fp32_card_vs_cpu_emb_max_rel"] <= FP32_EMB_REL_TOL
            and report["fp32_card_vs_cpu_logits_max_rel"]
            <= FP32_OUT_REL_TOL):
        raise AssertionError(f"a16b stride variant: {report}, {errs}")
    return rec, report, launches


GRAD_GROUPS = ("stem", "layer1", "layer2", "layer3", "layer4", "temporal")


def grad_groups(model: Mimamo) -> dict:
    """The gradient of one step as one fp32 vector per part of the model:
    the backbone's stem (conv1, bn1), its four stages, the temporal model
    (the backbone's fc is left out: the logits feed no loss)."""
    parts = {g: [] for g in GRAD_GROUPS}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        top, rest = name.split(".", 1)
        group = ("temporal" if top == "temporal"
                 else rest.split(".", 1)[0] if rest.startswith("layer")
                 else "stem")
        parts[group].append(p.grad.detach().float().flatten())
    return {g: torch.cat(v) for g, v in parts.items()}


def grad_agreement(a: dict, b: dict) -> dict:
    """Cosine and norm ratio of ``a`` against ``b`` (:func:`grad_groups`)
    per part, and of the backbone's parts as one vector."""
    def cmp(x, y):
        x, y = x.double(), y.double()
        return {"cos": float(x @ y / (x.norm() * y.norm())),
                "norm_ratio": float(x.norm() / y.norm())}
    out = {g: cmp(a[g], b[g]) for g in GRAD_GROUPS}
    bb = [g for g in GRAD_GROUPS if g != "temporal"]
    out["backbone"] = cmp(torch.cat([a[g] for g in bb]),
                          torch.cat([b[g] for g in bb]))
    return out


def a16b_finetune(line: str) -> tuple:
    """bf16 fine-tuning at the default geometry (4 x 48 frames of 112^2
    crops, backbone input 224, remat): one step against the fp32 step from
    the same weights on the same batch (loss; the gradient's cosine and
    norm per part, beside those of an fp32 step on clips moved by
    FINETUNE_PERTURB, the measure of how far the gradient's direction is
    set by its input at all), 2 steps move the weights and BN stats,
    ``predict_clips`` of the refolded weights with its launches, the step
    times and peak memory of both dtypes. Returns (report, the launches of
    that ``predict_clips``)."""
    report = {"card": line}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "aff")
        datasets.make_synthetic_affwild2(root, n_videos=2, frames=TRAIN_T,
                                         size=S, seed=SEED)
        cfg = MimamoConfig()
        batch = next(datasets.AffWild2Dataset(root, clip=cfg.clip).batches(
            cfg.train.batch_size))
    moved = dict(batch, clips=batch["clips"].astype(np.float32)
                 + FINETUNE_PERTURB * np.random.default_rng(SEED + 62)
                 .uniform(-1, 1, batch["clips"].shape).astype(np.float32))
    init = weights.init_variables(cfg, SEED)
    runs = {}
    for name, dtype, data in (("float32", "float32", batch),
                              ("float32_moved", "float32", moved),
                              ("bfloat16", "bfloat16", batch)):
        torch.cuda.empty_cache()
        c = dataclasses.replace(
            cfg, backbone=dataclasses.replace(cfg.backbone, dtype=dtype),
            train=TrainSpec(freeze_backbone=False, remat_backbone=True))
        model = Mimamo(c)
        model.load_state_dict(init)
        st, step = train.create_train_state(model), train.make_train_step(
            model)
        bb0 = {k: v.clone() for k, v in model.backbone.state_dict().items()}
        torch.cuda.reset_peak_memory_stats()
        _, m = step(st, data)
        run = {"loss": float(m["loss"]), "grads": grad_groups(model),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        runs[name] = run
        if name == "float32_moved":
            del model, st, step
            continue
        run["losses"] = [run["loss"], float(step(st, batch)[1]["loss"])]
        bb1 = model.backbone.state_dict()
        run["weights_moved"] = state_diff(bb1, bb0, [
            k for k in bb0 if "running" not in k and "num_b" not in k])
        run["bn_stats_moved"] = state_diff(bb1, bb0, [k for k in bb0
                                                      if "running" in k])
        if dtype == "bfloat16":
            run["grad_dtypes"] = sorted({str(p.grad.dtype) for p in
                                         model.parameters()
                                         if p.grad is not None})
            out, launches = counted(lambda: model.predict_clips(
                batch["clips"]))
            run["predict_finite"] = bool(torch.isfinite(out).all())
        run["step_ms"] = step_ms(step, st, batch, 3)
        run["step_ms_median"] = statistics.median(run["step_ms"])
        del model, st, step
    ref = runs["float32"]
    for name in ("bfloat16", "float32_moved"):
        report[f"{name}_vs_float32_step"] = {
            "loss_abs": abs(runs[name]["loss"] - ref["loss"]),
            "grads": grad_agreement(runs[name]["grads"], ref["grads"])}
    for name, run in runs.items():
        del run["grads"]
        report[name] = run
    report["launches_predict"] = launches
    cmp_, bf = report["bfloat16_vs_float32_step"], runs["bfloat16"]
    if not (cmp_["loss_abs"] <= FINETUNE_BF16_LOSS_ATOL
            and cmp_["grads"]["temporal"]["cos"] >= FINETUNE_BF16_COS
            and all(abs(cmp_["grads"][part]["norm_ratio"] - 1)
                    <= FINETUNE_BF16_NORM_TOL
                    for part in ("backbone", "temporal"))
            and all(np.isfinite(bf["losses"])) and bf["weights_moved"] > 0
            and bf["bn_stats_moved"] > 0 and bf["predict_finite"]
            and bf["grad_dtypes"] == ["torch.float32"]):
        raise AssertionError(f"a16b bf16 fine-tune: {report}")
    return report, launches


def a16b_pyramid(line: str) -> dict:
    """``pyramid.build`` -> ``reconstruct`` on B x T frames of 112^2 on the
    card (rel-err < PYRAMID_REC_TOL), and the pyramid on the card against
    the CPU's (max |d| / max |CPU| <= PYRAMID_CARD_CPU_TOL per part)."""
    spec = MimamoConfig().pyramid
    frames = torch.from_numpy(np.random.default_rng(SEED + 61).uniform(
        0, 255, (B * T, S, S)).astype(np.float32))
    card_frames = frames.cuda()
    pyr = pyramid.build(card_frames, spec)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pyr = pyramid.build(card_frames, spec)
    rec = pyramid.reconstruct(pyr, spec)
    torch.cuda.synchronize()
    report = {"card": line,
              "build_reconstruct_ms": (time.perf_counter() - t) * 1e3,
              "reconstruct_rel_err": max_rel(rec, card_frames)}
    cpu = pyramid.build(frames, spec)
    report["card_vs_cpu_max_rel"] = {
        "high": max_rel(pyr["high"].cpu(), cpu["high"]),
        "low": max_rel(pyr["low"].cpu(), cpu["low"]),
        **{f"band{s}": max_rel(torch.view_as_real(b.cpu()),
                               torch.view_as_real(c))
           for s, (b, c) in enumerate(zip(pyr["bands"], cpu["bands"]))}}
    if not (report["reconstruct_rel_err"] < PYRAMID_REC_TOL
            and max(report["card_vs_cpu_max_rel"].values())
            <= PYRAMID_CARD_CPU_TOL):
        raise AssertionError(f"a16b pyramid: {report}")
    return report


def a16b_examples(tmp: str) -> dict:
    """Both examples as processes on the card, started together: exit 0
    and the files they write."""
    want = {"demo": ["demo.boxes.npy", "demo.feat.npy", "demo.mp4",
                     "demo.npy", "predictions.csv"],
            "serve_client": ["preds.csv", "sample.mp4"]}
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = {}
    for name in want:
        out = os.path.join(tmp, name)
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", f"mimamo_tpu_torch.examples.{name}",
             "--out-dir", out], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    report = {}
    t = time.perf_counter()
    for name, (out, proc) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=A16B_EXAMPLES_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        files = sorted(os.listdir(out)) if os.path.isdir(out) else []
        report[name] = {"rc": proc.returncode, "files": files,
                        "last_line": stdout.strip().splitlines()[-1:],
                        "ok": proc.returncode == 0 and files == want[name]}
        if not report[name]["ok"]:
            report[name]["stderr"] = stderr[-2000:]
    report["wall_s"] = time.perf_counter() - t
    return report


def check_a16b(state: dict, line: str) -> tuple:
    """The JAX package's last modules (docstring item 17). Returns (the
    ``layer2_tail`` record, the launches of the stride variant's backbone
    call, those of ``predict_clips`` after a bf16 fine-tune)."""
    rec, stride, stride_launches = a16b_stride(state, line)
    print(json.dumps({"a16b_stride_variant": stride}), flush=True)
    torch.cuda.empty_cache()
    finetune, ft_launches = a16b_finetune(line)
    print(json.dumps({"a16b_finetune_bf16": finetune}), flush=True)
    torch.cuda.empty_cache()
    pyr = a16b_pyramid(line)
    print(json.dumps({"a16b_pyramid": pyr}), flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ex = a16b_examples(tmp)
    print(json.dumps({"a16b_examples": ex}), flush=True)
    if not all(ex[name]["ok"] for name in ("demo", "serve_client")):
        raise AssertionError(f"a16b examples: {ex}")
    return rec, stride_launches, ft_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
        check_fft_invariance(cfg, line)
        recs = [check_phase(to_grayscale(crops), cfg),
                check_stem(crops.reshape(B * T, S, S, 3), model),
                check_layer2(crops.reshape(B * T, S, S, 3), model),
                check_epilogue(state, line)]
    del crops
    torch.cuda.empty_cache()

    # -- the main path -----------------------------------------------------
    model.predict_clips(clips)                           # warm-up
    torch.cuda.synchronize()
    out, launches = counted(lambda: model.predict_clips(clips))
    if tuple(out.shape) != (B, T, 2) or not torch.isfinite(out).all():
        raise AssertionError(f"predict_clips gave {tuple(out.shape)}, "
                             f"finite={bool(torch.isfinite(out).all())}")
    step_times = clip_step_ms(model, clips)
    step = statistics.median(step_times) / 1e3
    print(json.dumps({"predict_clips_frames_per_s": B * T / step,
                      "step_ms": step * 1e3, "steps_ms": step_times,
                      "card": line}), flush=True)
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

    # -- the serving daemon, the command line and the corpus runner ----------
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        media = slice_media(tmp)
        ckpt = save_weights(state, cfg, os.path.join(tmp, "ckpt"))
        serve_launches = check_serve(state, cfg, ckpt, media, line)
        cli_launches = check_cli(state, MimamoConfig(), ckpt, media, line)
        check_corpus(ckpt, media, line)
    print(json.dumps({"serve_cli_corpus_s": time.perf_counter() - t}),
          flush=True)
    torch.cuda.empty_cache()

    # -- the probes -------------------------------------------------------------
    with torch.no_grad():
        probe_recs, probe_launches = check_probes(line)
    for rec in recs:
        rec["launches_probes"] = probe_launches[rec["name"]]
    recs += probe_recs
    for rec in recs:
        rec["launches_serve_feed"] = serve_launches[rec["name"]]
        rec["launches_cli_predict"] = cli_launches[rec["name"]]

    # -- every crop size, and the reference's weights ---------------------------
    t = time.perf_counter()
    crop_recs, _ = check_crops(state, line)
    print(json.dumps({"crops_s": time.perf_counter() - t}), flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    convert = check_convert(line)
    print(json.dumps({"convert_s": time.perf_counter() - t}), flush=True)
    for rec in recs:
        rec["launches_convert_cli_predict"] = convert[
            "launches_cli_predict"][rec["name"]]

    # -- the model variants -------------------------------------------------------
    t = time.perf_counter()
    variant_recs, variants = check_variants(line)
    print(json.dumps({"variants_s": time.perf_counter() - t}), flush=True)
    for rec in recs:
        for name in VARIANTS:
            rec[f"launches_variant_{name}"] = {
                dtype: variants[name][dtype]["launches"][rec["name"]]
                for dtype in ("bfloat16", "float32")}

    # -- data parallelism -------------------------------------------------
    t = time.perf_counter()
    rank0 = check_parallel(state, line)
    print(json.dumps({"parallel_s": time.perf_counter() - t}), flush=True)
    for rec in recs:           # rank 0 of 2; the dots kernels are not there
        rec["launches_parallel_train"] = rank0["launches_train"].get(
            rec["name"], 0)
        rec["launches_parallel_predict_batch"] = {
            dtype: rank0["launches_predict_batch"][dtype].get(rec["name"], 0)
            for dtype in ("bfloat16", "float32")}

    # -- the JAX package's last modules ---------------------------------------
    t = time.perf_counter()
    tail_rec, stride_launches, ft_launches = check_a16b(state, line)
    print(json.dumps({"a16b_s": time.perf_counter() - t}), flush=True)
    for rec in recs:
        rec["launches_stride_variant"] = stride_launches[rec["name"]]
        rec["launches_finetune_bf16_predict"] = ft_launches[rec["name"]]
    recs += crop_recs + variant_recs + [tail_rec]
    print(json.dumps({"smoke_s": time.perf_counter() - t_start}), flush=True)

    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
