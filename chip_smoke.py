"""Smoke run of the PyTorch/CUDA port (mimamo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``mimamo_tpu_torch/csrc`` (into the
gitignored ``mimamo_tpu_torch/_build/``), then:

  1. prints the card's name and power limit (nvidia-smi);
  2. holds each kernel against its plain PyTorch version on the card at
     small ragged shapes and at the flagship shapes (B=8 clips x T=48
     frames of 112^2 crops, bf16 backbone), and times the kernel, the plain version and, where PyTorch
     computes the same function, the library call (a yardstick only; the
     port never calls it);
  3. drives ``Mimamo.predict_clips`` at the flagship shape with random
     weights from a seed, checks shape and finiteness, and checks that
     every kernel was launched on that run (phase 3, stem 1, layer2 13 per
     forward);
  4. runs the same weights on one clip x 8 frames on the CPU, in fp32,
     and compares the card's embeddings and outputs with it;
  5. prints ``{"kernels": [...]}`` and, last, the device line.

Any failure exits non-zero. Needs one CUDA card; imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from mimamo_tpu_torch import phase, pyramid, weights
from mimamo_tpu_torch.config import BackboneSpec, MimamoConfig
from mimamo_tpu_torch.kernels import (_build, layer2_kernel, phase_kernel,
                                      stem_kernel)
from mimamo_tpu_torch.preprocess import for_backbone, to_grayscale
from mimamo_tpu_torch.runner import Mimamo

B, T, S = 8, 48, 112          # flagship step: 384 frames of 112^2 crops
SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet), at a 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PHASE_TOL = 1e-4              # max |kernel - plain|, radians
BF16_REL_TOL = 2e-2           # max |kernel - plain| / max |plain|
# Card (bf16) vs CPU (fp32) on one 8-frame clip: bf16 rounding of the
# ResNet activations moves the embeddings by under 1% and the outputs by
# several % of their (small, random-weight) range on the CPU alone.
EMB_REL_TOL = 2e-2
OUT_REL_TOL = 1.5e-1


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Median over ``iters`` runs of ``fn`` on the current stream, timed
    with CUDA events after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-12)
            ).item()


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def record(name, source, replaces, err, tol, ms, plain_ms, nbytes, flops,
           library_ms):
    bound, bound_by = bound_ms(nbytes, flops)
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": None, "max_abs_err": err,
           "tol": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": bound_by, "library_ms": library_ms}
    print(json.dumps(dict(rec, kernel_ms=ms)), flush=True)
    return rec


def check_phase(frames: torch.Tensor, cfg: MimamoConfig) -> dict:
    spec, p = cfg.pyramid, cfg.phase.phase_size
    k = spec.orientations
    masks = pyramid.band_masks(spec, frames.device)
    bands = list(pyramid.bands(frames, spec, masks))
    out = torch.empty((B, T - 1, spec.height * k, p, p),
                      device=frames.device)

    def kernel(weighting=False):
        for s, band in enumerate(bands):
            phase_kernel.phase_diff_resize(band, out, s * k, weighting)
        return out

    def plain(weighting=False):
        return torch.cat([phase.phase_diff_resize(band, p, weighting)
                          for band in bands], dim=2)

    errs = {}
    for weighting in (False, True):
        got = kernel(weighting).clone()
        want = plain(weighting)
        torch.cuda.synchronize()
        errs[weighting] = (got - want).abs().max().item()
        if not errs[weighting] <= PHASE_TOL:
            raise AssertionError(f"phase kernel (weighting={weighting}) "
                                 f"max |err| {errs[weighting]} > {PHASE_TOL}")
    print(json.dumps({"phase_weighted_max_abs_err": errs[True]}))
    nbytes = sum(b.numel() * 8 for b in bands) + out.numel() * 4
    return record(
        "phase_diff_resize", "mimamo_tpu_torch/csrc/phase_diff_resize.cu",
        "mimamo_tpu/pallas/phase_kernel.py:112", errs[False], PHASE_TOL,
        time_ms(kernel), time_ms(plain), nbytes, 0.0, None)


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
        "mimamo_tpu/pallas/stem_kernel.py:153",
        (got.float() - want.float()).abs().max().item(), BF16_REL_TOL,
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
    flops = sum(2.0 * pixels * c.weight.numel()
                for blk in blocks for c in blk.values())
    nbytes = x.numel() * 2 + got.numel() * 2 + sum(
        c.weight.numel() * 2 + c.bias.numel() * 4
        for blk in blocks for c in blk.values())
    return record(
        "layer2_fused", "mimamo_tpu_torch/csrc/layer2.cu",
        "mimamo_tpu/pallas/layer2_kernel.py:174",
        (got.float() - want.float()).abs().max().item(), BF16_REL_TOL,
        time_ms(lambda: layer2_kernel.layer2_fused(x, blocks)),
        time_ms(lambda: layer2_kernel.layer2_plain(x, blocks)),
        nbytes, flops, time_ms(library))


def check_small_shapes(model: Mimamo) -> None:
    """The kernels at shapes other than the flagship's, against their plain
    versions: a partial channel slice of the phase output, a crop size with
    an odd number of pooled rows, and a layer2 input whose pixel count is
    not a multiple of the conv kernel's 128-row tile."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    band = torch.randn((3, 6, 2, 32, 32), dtype=torch.complex64,
                       device="cuda", generator=gen)
    for weighting in (False, True):
        out = torch.zeros((3, 5, 4, 48, 48), device="cuda")
        phase_kernel.phase_diff_resize(band, out, 1, weighting)
        want = phase.phase_diff_resize(band, 48, weighting)
        errs[f"phase_w{int(weighting)}"] = (
            out[:, :, 1:3] - want).abs().max().item()
        if not (errs[f"phase_w{int(weighting)}"] <= PHASE_TOL
                and not out[:, :, 0].any() and not out[:, :, 3].any()):
            raise AssertionError(f"phase kernel at a small shape: {errs}")
    w2, bias = model._backbone_folded().stem
    crops = torch.rand((3, 34, 34, 3), device="cuda", generator=gen) * 255
    mean = model.config.backbone.mean_rgb
    errs["stem_s34"] = max_rel(stem_kernel.stem_fused(crops, w2, bias, mean),
                               stem_kernel.stem_plain(crops, w2, bias, mean))
    x = torch.randn((2, 16, 12, 256), device="cuda", generator=gen).to(
        torch.bfloat16)
    blocks = model._backbone_folded().layer2
    errs["layer2_16x12"] = max_rel(layer2_kernel.layer2_fused(x, blocks),
                                   layer2_kernel.layer2_plain(x, blocks))
    print(json.dumps({"small_shapes_err": errs}), flush=True)
    if not (errs["stem_s34"] < BF16_REL_TOL
            and errs["layer2_16x12"] < BF16_REL_TOL):
        raise AssertionError(f"kernels at small shapes: {errs}")


def stage_breakdown(model: Mimamo, clips: np.ndarray) -> dict:
    """Device time (ms) of each stage of one flagship forward: the calls
    ``Mimamo.forward`` makes, with CUDA events recorded between stages."""
    cfg, folded = model.config, model._backbone_folded()
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    with torch.no_grad():
        mark("start")
        crops = torch.from_numpy(clips).cuda().float()
        mark("h2d_cast")
        gray = to_grayscale(crops)
        mark("grayscale")
        k, p = cfg.pyramid.orientations, cfg.phase.phase_size
        bands = list(pyramid.bands(
            gray, cfg.pyramid, pyramid.band_masks(cfg.pyramid, gray.device)))
        mark("fft_bands")
        stacks = torch.empty((B, T - 1, cfg.num_phase, p, p),
                             device=gray.device)
        for s, band in enumerate(bands):
            phase_kernel.phase_diff_resize(band, stacks, s * k, False)
        mark("phase_kernel")
        stem = stem_kernel.stem_fused(crops.reshape(B * T, S, S, 3),
                                      *folded.stem, cfg.backbone.mean_rgb)
        mark("stem_kernel")
        x = folded._stage(stem.permute(0, 3, 1, 2), 1)
        mark("layer1")
        x = layer2_kernel.layer2_fused(x.permute(0, 2, 3, 1).contiguous(),
                                       folded.layer2)
        mark("layer2_kernel")
        x = folded._stage(x.permute(0, 3, 1, 2), 3)
        mark("layer3")
        x = folded._stage(x, 4)
        mark("layer4")
        emb = x.to(torch.float32).mean(dim=(2, 3)).to(x.dtype).float()
        mark("pool5")
        model.temporal(stacks, emb.reshape(B, T, -1))
        mark("temporal")
    torch.cuda.synchronize()
    return {name: prev.elapsed_time(event)
            for (_, prev), (name, event) in zip(marks, marks[1:])}


KERNELS = {"phase_diff_resize": phase_kernel.KERNEL,
           "stem_fused": stem_kernel.KERNEL,
           "layer2_fused": layer2_kernel.KERNEL}
EXPECTED_LAUNCHES = {"phase_diff_resize": 3, "stem_fused": 1,
                     "layer2_fused": 13}


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
        recs = [check_phase(to_grayscale(crops), cfg),
                check_stem(crops.reshape(B * T, S, S, 3), model),
                check_layer2(crops.reshape(B * T, S, S, 3), model)]
    del crops
    torch.cuda.empty_cache()

    # -- the main path -----------------------------------------------------
    model.predict_clips(clips)                           # warm-up
    torch.cuda.synchronize()
    for kern in KERNELS.values():
        kern.launches = 0
    out = model.predict_clips(clips)
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    if tuple(out.shape) != (B, T, 2) or not torch.isfinite(out).all():
        raise AssertionError(f"predict_clips gave {tuple(out.shape)}, "
                             f"finite={bool(torch.isfinite(out).all())}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"kernel launches on the main path {launches}"
                             f" != {EXPECTED_LAUNCHES}")
    for rec in recs:
        rec["launches"] = launches[rec["name"]]
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
    runs = [stage_breakdown(model, clips) for _ in range(5)]
    stages = {name: statistics.median(r[name] for r in runs)
              for name in runs[0]}
    print(json.dumps({"stage_ms": stages,
                      "stage_sum_ms": sum(stages.values()),
                      "card": line}), flush=True)

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
    emb_rel, out_rel = max_rel(card_emb, cpu_emb), max_rel(card_out, cpu_out)
    print(json.dumps({"card_vs_cpu_emb_max_rel": emb_rel,
                      "card_vs_cpu_out_max_rel": out_rel,
                      "tol": [EMB_REL_TOL, OUT_REL_TOL]}), flush=True)
    if not (emb_rel < EMB_REL_TOL and out_rel < OUT_REL_TOL):
        raise AssertionError("card and CPU disagree beyond tolerance")

    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
