"""Command-line interface of the PyTorch/CUDA port.

Counterpart of ``mimamo_tpu/cli.py``, with its subcommands, flags and
output lines::

    python -m mimamo_tpu_torch.cli predict --video clip.mp4 --out preds.csv
    python -m mimamo_tpu_torch.cli extract --video clip.mp4 --out-dir work/
    python -m mimamo_tpu_torch.cli train --dataset affwild2 --root data/ \\
        --ckpt ckpts/
    python -m mimamo_tpu_torch.cli eval --dataset affwild2 --root data/ \\
        --ckpt ckpts/
    python -m mimamo_tpu_torch.cli predict-corpus --videos 'corpus/*.mp4' \\
        --out-dir out/
    python -m mimamo_tpu_torch.cli serve --uint8-streams
    python -m mimamo_tpu_torch.cli convert \\
        --backbone-pth resnet50_ferplus_dag.pth --temporal-pth model.pth \\
        --out ckpts/ --verify

Every subcommand runs on the card, or on the CPU with ``--cpu``; without a
card and without ``--cpu`` it raises. ``--ckpt`` names a port checkpoint
directory (``checkpoints.save``, as ``train`` and ``convert`` write it),
not an orbax one: convert the reference's ``.pth`` files with ``convert``,
JAX weights with ``weights.from_jax_variables``.

Every subcommand that builds a model takes the JAX CLI's model variants:
``--streams micro|macro`` (the paper's stream ablations), ``--gru-layers``,
``--snippet-len``, ``--appearance-stride`` and a ``--backbone-size`` other
than twice ``--crop-size`` (the resize route of the stem).

What the JAX CLI has and this one does not:

  * flags that chose a TPU lowering (``--fft-mode``, ``--stem-mode``,
    ``--use-pallas``): not registered, the port has one lowering each
    (cuFFT, the stem kernel, the kernels always on);
  * multi-process and data-parallel flags (``--data-parallel``,
    ``--coordinator``, ``--num-processes``, ``--process-id``; A12), and
    ``train --tensorboard`` / ``--debug-nans``: not registered yet;
  * the ``bench`` subcommand: registered, it exits naming ROADMAP.md A15.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
from typing import Optional

import numpy as np

from .config import (BackboneSpec, ClipSpec, MimamoConfig, PhaseSpec,
                     PyramidSpec, TemporalSpec, TrainSpec)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--clip-len", type=int, default=48)
    p.add_argument("--stride", type=int, default=24)
    p.add_argument("--crop-size", type=int, default=112)
    p.add_argument("--backbone-size", type=int, default=224,
                   help="backbone input; twice --crop-size runs the stem "
                        "kernel, any other size a bilinear resize and a "
                        "plain conv1")
    p.add_argument("--pyramid-height", type=int, default=3)
    p.add_argument("--orientations", type=int, default=4)
    p.add_argument("--phase-size", type=int, default=48)
    p.add_argument("--snippet-len", type=int, default=1,
                   help="frames mean-pooled into one GRU step (the clip "
                        "length must be a multiple)")
    p.add_argument("--gru-layers", type=int, default=1,
                   help="stacked GRU layers per stream")
    p.add_argument("--streams", default="both",
                   choices=["both", "micro", "macro"],
                   help="stream ablation: both, or micro-only / macro-only")
    p.add_argument("--appearance-stride", type=int, default=1,
                   help="run the ResNet every k-th frame and interpolate "
                        "the embeddings between (a serving profile, not "
                        "reference parity)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")


def _config(args) -> MimamoConfig:
    s = args.crop_size
    return MimamoConfig(
        pyramid=PyramidSpec(height=args.pyramid_height,
                            orientations=args.orientations,
                            input_size=(s, s)),
        phase=PhaseSpec(phase_size=args.phase_size),
        backbone=BackboneSpec(input_size=args.backbone_size,
                              dtype=args.dtype,
                              appearance_stride=args.appearance_stride),
        temporal=TemporalSpec(snippet_len=args.snippet_len,
                              gru_layers=args.gru_layers,
                              streams=args.streams),
        clip=ClipSpec(clip_len=args.clip_len, stride=args.stride,
                      crop_size=s))


def _device(args):
    """The card, or the CPU with ``--cpu``; raises without a card."""
    from .runner import resolve_device
    return resolve_device("cpu" if args.cpu else None)


def _model(config: MimamoConfig, ckpt: Optional[str], device):
    """A model with a checkpoint's weights, or random ones from seed 0."""
    from . import checkpoints, weights
    from .runner import Mimamo
    model = Mimamo(config, device=device)
    model.load_state_dict(checkpoints.load(ckpt)["model"] if ckpt
                          else weights.init_variables(config, 0))
    return model


def cmd_predict(args) -> int:
    # argument coherence before any model is built
    if bool(args.video) == bool(args.crops):
        raise SystemExit("exactly one of --video / --crops is required")
    if args.crops and (args.align or args.boxes or args.landmarks):
        raise SystemExit("--crops takes precomputed ALIGNED crops — "
                         "--align/--boxes/--landmarks do not apply")
    config = _config(args)
    device = _device(args)
    from .api import MimamoAPI
    from .backbone import FERPLUS_CLASSES
    api = MimamoAPI(config=config, checkpoint_dir=args.ckpt, device=device)
    threshold = (None if args.streaming_threshold < 0
                 else args.streaming_threshold)
    if args.crops:
        out = api.predict_crops(args.crops, out_csv=args.out,
                                max_frames=args.max_frames,
                                smooth=args.smooth,
                                emotions=args.emotions,
                                streaming_threshold=threshold)
    else:
        out = api.predict(args.video, out_csv=args.out,
                          boxes_path=args.boxes,
                          max_frames=args.max_frames, align=args.align,
                          landmarks_path=args.landmarks,
                          smooth=args.smooth, emotions=args.emotions,
                          streaming_threshold=threshold)
    series, probs = out if args.emotions else (out, None)
    row = {"frames": len(series),
           "valence_mean": float(series[:, 0].mean()),
           "arousal_mean": float(series[:, 1].mean()),
           "out": args.out}
    if probs is not None:
        row["top_emotion"] = FERPLUS_CLASSES[
            int(np.argmax(probs.mean(axis=0)))]
    print(json.dumps(row))
    return 0


def cmd_extract(args) -> int:
    from . import checkpoints
    from .api import FeatureExtractor, VideoProcessor
    config = checkpoints.apply_backbone_meta(_config(args), args.ckpt)
    device = _device(args)
    vp = VideoProcessor(save_size=args.crop_size, device=device)
    crops = vp.process(args.video, args.out_dir, boxes_path=args.boxes,
                       max_frames=args.max_frames, align=args.align,
                       landmarks_path=args.landmarks)
    state = checkpoints.load(args.ckpt)["model"] if args.ckpt else None
    feats = FeatureExtractor(config=config, state_dict=state,
                             device=device).extract(crops)
    print(json.dumps({"crops": crops, "features": feats,
                      "weights": "checkpoint" if args.ckpt else
                      "RANDOM-INIT (pass --ckpt for real features)"}))
    return 0


def _dataset(args, config):
    from .data import datasets
    if args.dataset == "omg":
        if not args.manifest:
            raise SystemExit("--manifest is required for --dataset omg")
        return datasets.OMGEmotionDataset(args.root, args.manifest,
                                          config.clip)
    return datasets.AffWild2Dataset(args.root, clip=config.clip)


def cmd_train(args) -> int:
    import copy
    import dataclasses
    from . import checkpoints, train

    loss_axis = args.loss_axis or (
        "batch" if args.dataset == "omg" else "time")
    # --mse-weight alone implies the composite loss; an explicit
    # --loss ccc+mse without a weight is caught by TrainSpec
    loss = ("ccc+mse" if args.mse_weight > 0 and args.loss == "ccc"
            else args.loss)
    try:
        train_spec = TrainSpec(
            learning_rate=args.lr, batch_size=args.batch,
            epochs=args.epochs, seed=args.seed,
            loss=loss, mse_weight=args.mse_weight,
            weight_decay=args.weight_decay,
            loss_axis=loss_axis,
            lr_schedule=args.lr_schedule,
            warmup_steps=args.warmup_steps,
            augment=args.augment,
            brightness_jitter=args.brightness_jitter,
            freeze_backbone=not args.finetune_backbone)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.eval_every < 1:
        raise SystemExit(f"--eval-every must be >= 1, got "
                         f"{args.eval_every}")
    config = checkpoints.apply_backbone_meta(
        dataclasses.replace(_config(args), train=train_spec), args.ckpt)
    device = _device(args)
    if config.backbone.appearance_stride > 1:
        print("note: --appearance-stride applies only where the frozen "
              "backbone runs online; fine-tuning runs the real per-"
              "frame backbone, and training from cached .feat.npy "
              "applies no ADDITIONAL stride — but cached features "
              "inherit whatever stride their extraction config used, "
              "so they are not automatically stride-free",
              file=sys.stderr)
    ds = _dataset(args, config)
    if len(ds) == 0:
        raise SystemExit("dataset produced 0 clips (too short sequences?)")
    if len(ds) // config.train.batch_size == 0:
        raise SystemExit(
            f"dataset has {len(ds)} clips — fewer than one batch of "
            f"{config.train.batch_size}; shrink --batch or add data")
    eval_ds = None
    if args.eval_root:
        eval_args = copy.copy(args)
        eval_args.root = args.eval_root
        eval_args.manifest = args.eval_manifest or args.manifest
        eval_ds = _dataset(eval_args, config)
    train.fit(config, ds, ckpt=args.ckpt, resume=args.resume,
              eval_dataset=eval_ds, epochs=args.epochs,
              eval_every=args.eval_every, log=args.log, device=device,
              on_epoch=lambda row: print(json.dumps(row), flush=True))
    return 0


def cmd_eval(args) -> int:
    from . import checkpoints
    from .data import eval as eval_mod
    config = checkpoints.apply_backbone_meta(_config(args), args.ckpt)
    model = _model(config, args.ckpt, _device(args))
    ds = _dataset(args, config)
    fn = (eval_mod.evaluate_omg if args.dataset == "omg"
          else eval_mod.evaluate_affwild2)
    print(json.dumps(fn(model, ds, chunk=config.clip.clip_len,
                        batch_streams=args.batch_streams)))
    return 0


def cmd_predict_corpus(args) -> int:
    from . import checkpoints
    from .corpus import CorpusRunner
    config = checkpoints.apply_backbone_meta(_config(args), args.ckpt)
    model = _model(config, args.ckpt, _device(args))
    paths = sorted(glob.glob(args.videos))
    if not paths:
        raise SystemExit(f"no videos match {args.videos!r}")
    runner = CorpusRunner(model, args.out_dir, batch_clips=args.batch,
                          loader_threads=args.threads,
                          use_native=not args.no_native,
                          smooth=args.smooth, align=args.align)
    print(json.dumps(runner.run(paths)))
    return 0


def cmd_serve(args) -> int:
    """Long-running JSON-lines serving daemon (see ``serve.py``)."""
    from . import serve
    config = _config(args)
    server = serve.Server(
        config=config, checkpoint_dir=args.ckpt,
        capacity=args.capacity, chunk=args.chunk,
        stream_dtype=np.uint8 if args.uint8_streams else np.float32,
        warmup=not args.no_warmup, allowed_root=args.allowed_root,
        device=_device(args))
    print(json.dumps({"ready": True, "capacity": args.capacity,
                      "chunk": args.chunk}), flush=True)
    serve.run(server)
    return 0


def _json_map(path: Optional[str]) -> Optional[dict]:
    if not path:
        return None
    with open(path) as f:
        m = json.load(f)
    if not isinstance(m, dict) or not all(isinstance(v, str)
                                          for v in m.values()):
        raise SystemExit(f"{path}: expected a flat {{source: canonical}} "
                         f"JSON object")
    return m


def _backbone_meta(config: MimamoConfig, meta: Optional[dict], report: dict
                   ) -> MimamoConfig:
    """``config`` with a ``.pth``'s preprocessing meta (``mean``,
    ``channel_order``) folded in, recorded in ``report``; warns on a std
    other than 1 and notes an imageSize other than the backbone's."""
    import dataclasses
    if not meta:
        return config
    bspec = config.backbone
    if "mean" in meta:
        bspec = dataclasses.replace(bspec, mean_rgb=tuple(meta["mean"]))
    if "channel_order" in meta:
        bspec = dataclasses.replace(bspec,
                                    channel_order=meta["channel_order"])
    report["backbone_meta"] = {"mean_rgb": list(bspec.mean_rgb),
                               "channel_order": bspec.channel_order}
    if meta.get("std") and any(abs(s - 1.0) > 1e-6 for s in meta["std"]):
        print(f"WARNING: checkpoint meta['std'] = {meta['std']} != 1 — "
              f"this importer assumes mean-subtraction-only preprocessing; "
              f"verify the source model", file=sys.stderr)
    if meta.get("image_size") and meta["image_size"] != bspec.input_size:
        print(f"note: checkpoint meta imageSize {meta['image_size']} != "
              f"--backbone-size {bspec.input_size}; the ResNet is fully "
              f"convolutional so weights load either way, but reference "
              f"parity uses the meta size", file=sys.stderr)
    return dataclasses.replace(config, backbone=bspec)


def _verify(args, config: MimamoConfig, state: dict, backbone_sd,
            device) -> dict:
    """Forward the SOURCE tensors through ``torch_ref`` on the CPU and the
    converted weights on ``device`` on the same inputs; raises SystemExit
    when an output differs by more than ``--verify-tol`` of its scale.
    Returns the report: ``max_abs_diff``, ``scale``, ``rel`` per output."""
    import dataclasses
    import torch
    from . import checkpoints, torch_ref
    from .backbone import ResNet50, resolve_torch_names
    from .temporal import TwoStreamRNN
    rng = np.random.default_rng(0)
    tol, report = args.verify_tol, {}

    def check(name, got, want):
        scale = float(np.abs(want).max()) + 1e-12
        diff = float(np.abs(got.detach().cpu().numpy() - want).max())
        report[name] = {"max_abs_diff": diff, "scale": round(scale, 6),
                        "rel": diff / scale}
        if not diff <= tol * scale:
            raise SystemExit(
                f"convert --verify FAILED on {name}: max |delta| {diff:.3e} "
                f"vs output scale {scale:.3e} (> {tol:.1e} relative). The "
                f"converted model does NOT match the source .pth forward; "
                f"no checkpoint was written.")

    def part(prefix):
        return {k[len(prefix):]: v for k, v in state.items()
                if k.startswith(prefix)}

    with torch.no_grad():
        if args.backbone_pth:
            tv_sd, _ = resolve_torch_names(backbone_sd,
                                           _json_map(args.backbone_rename))
            s = config.backbone.input_size
            imgs = rng.uniform(-120.0, 120.0, (2, s, s, 3)).astype(
                np.float32)
            emb_t, log_t = torch_ref.backbone_forward(tv_sd, imgs)
            # the unfolded forward, in fp32 whatever the compute dtype
            net = ResNet50(dataclasses.replace(config.backbone,
                                               dtype="float32"))
            net.load_state_dict(part("backbone."))
            net.to(device).eval()
            emb, logits = net(torch.from_numpy(imgs).to(device))
            check("backbone_embeddings", emb, emb_t)
            check("backbone_logits", logits, log_t)
        if args.temporal_pth:
            spec, b = config.temporal, 2
            t = 4 * spec.snippet_len
            p = config.phase.phase_size
            ph = ft = None
            if spec.use_micro:
                ph = rng.standard_normal(
                    (b, t - 1, config.num_phase, p, p)).astype(np.float32)
            if spec.use_macro:
                ft = rng.standard_normal(
                    (b, t, config.backbone.feature_dim)).astype(np.float32)
            want = torch_ref.temporal_forward(checkpoints.apply_prefix_map(
                checkpoints.load_pth(args.temporal_pth),
                _json_map(args.temporal_prefix_map)), spec, ph, ft,
                num_frames=t)
            net = TwoStreamRNN(spec, config.num_phase, p,
                               config.backbone.feature_dim)
            net.load_state_dict(part("temporal."))
            net.to(device).eval()
            got, _ = net(*(None if x is None else torch.from_numpy(x).to(
                device) for x in (ph, ft)), num_frames=t)
            check("temporal_outputs", got, want)
    return report


def cmd_convert(args) -> int:
    """The reference's ``.pth`` checkpoints -> one port checkpoint dir that
    every ``--ckpt`` consumer accepts (plus ``backbone_meta.json`` when the
    backbone ``.pth`` carries a mean or a channel order). Strict by
    default: a tensor that maps nowhere is an error, not a silent random
    init. ``--verify`` holds the converted weights against the source's
    own forward and writes nothing when they disagree."""
    from . import backbone, checkpoints, train, weights
    from .runner import Mimamo
    if not (args.backbone_pth or args.temporal_pth):
        raise SystemExit("convert needs --backbone-pth and/or "
                         "--temporal-pth")
    config = _config(args)
    device = _device(args)
    strict = not args.no_strict
    report: dict = {}
    meta = backbone_sd = None
    if args.backbone_pth:
        # one deserialization for the tensors and the meta (a FER+ .pth is
        # ~100 MB); the meta goes into the config before the model is built
        backbone_sd, meta = checkpoints.load_pth_all(args.backbone_pth)
        config = _backbone_meta(config, meta, report)
    state = weights.init_variables(config, 0)
    if args.backbone_pth:
        sd, how = backbone.resolve_torch_names(
            backbone_sd, _json_map(args.backbone_rename))
        if how == "dag":
            report["backbone_dag_rename"] = "auto"
            print("detected resnet50_ferplus_dag naming; applied the "
                  "built-in rename map", file=sys.stderr)
        loaded = backbone.load_torch_state_dict(sd, strict=strict)
        state.update({f"backbone.{k}": v for k, v in loaded.items()})
        report["backbone_tensors"] = sum(
            not k.endswith("num_batches_tracked") for k in loaded)
    if args.temporal_pth:
        overlay = checkpoints.load_temporal_state_dict(
            checkpoints.load_pth(args.temporal_pth),
            prefix_map=_json_map(args.temporal_prefix_map),
            spec=config.temporal, phase_size=config.phase.phase_size,
            strict=strict)
        base = {k[len("temporal."):]: v for k, v in state.items()
                if k.startswith("temporal.")}
        try:
            merged, dropped = checkpoints.merge_temporal(base, overlay,
                                                         strict)
        except ValueError as e:
            raise SystemExit(str(e))
        state.update({f"temporal.{k}": v for k, v in merged.items()})
        report["temporal_tensors"] = len(overlay) - dropped
        if dropped:
            report["temporal_dropped_for_config"] = dropped
    # built before --verify: a model keeps TF32 off on the card, so the
    # check's convs run in IEEE fp32 as the model's do
    model = Mimamo(config, device=device)
    model.load_state_dict(state)
    if args.verify:
        report["verify"] = _verify(args, config, state, backbone_sd, device)
        print(json.dumps({"verify": report["verify"]}), file=sys.stderr)
    out = checkpoints.save(args.out, train.create_train_state(model), step=0)
    if meta and ("mean" in meta or "channel_order" in meta):
        checkpoints.save_backbone_meta(args.out, config.backbone.mean_rgb,
                                       config.backbone.channel_order)
    print(json.dumps({**report, "out": out}))
    return 0


def cmd_bench(args) -> int:
    print("bench: the port's benchmark harness is not ported yet "
          "(ROADMAP.md A15)", file=sys.stderr)
    raise SystemExit(2)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="mimamo_tpu_torch",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("predict", help="video -> per-frame (v, a) CSV")
    p.add_argument("--video", default=None)
    p.add_argument("--crops", default=None,
                   help="predict from PRECOMPUTED aligned crops "
                        "instead of a video: a packed [T, S, S, 3] "
                        ".npy (extract's output) or a per-frame image "
                        "dir (OpenFace cropped_aligned style)")
    p.add_argument("--out", default=None, help="output CSV path")
    p.add_argument("--boxes", default=None, help="precomputed boxes .npy")
    p.add_argument("--ckpt", default=None, help="port checkpoint dir")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--align", action="store_true",
                   help="similarity-align crops from landmarks "
                        "(OpenFace-style) instead of box crops; uses "
                        "<video>.landmarks.npy or <video>.openface.csv "
                        "when present, else the built-in Haar eye "
                        "tracker")
    p.add_argument("--landmarks", default=None,
                   help="precomputed landmarks: .npy ([T, 2, 2] eye "
                        "points or [T, 68, 2] dense, (y, x) source "
                        "pixels) or a raw OpenFace FeatureExtraction "
                        ".csv; implies --align")
    p.add_argument("--smooth", type=int, default=1,
                   help="odd moving-average window over the output "
                        "series (1 = off)")
    p.add_argument("--emotions", action="store_true",
                   help="also emit per-frame FER+ emotion "
                        "probabilities (8 classes)")
    p.add_argument("--streaming-threshold", type=int, default=4096,
                   help="frames past which the video switches to GRU "
                        "carry streaming (see api.MimamoAPI.predict); "
                        "-1 = never stream")
    _add_common(p)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("extract",
                       help="video -> aligned crops + 2048-d features")
    p.add_argument("--video", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--boxes", default=None)
    p.add_argument("--align", action="store_true",
                   help="write similarity-aligned crops (OpenFace role)")
    p.add_argument("--landmarks", default=None,
                   help="precomputed landmark .npy ([T, 2, 2] eyes or "
                        "[T, 68, 2] dense) or OpenFace .csv; "
                        "implies --align")
    p.add_argument("--ckpt", default=None,
                   help="port checkpoint for backbone weights (without "
                        "it, features come from random init)")
    p.add_argument("--max-frames", type=int, default=None)
    _add_common(p)
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("train", help="train on OMG / Aff-Wild2 layout")
    p.add_argument("--dataset", choices=["omg", "affwild2"], required=True)
    p.add_argument("--root", required=True)
    p.add_argument("--manifest", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--log", default=None, help="metrics JSONL path")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine"],
                   help="cosine = linear warmup + cosine decay over the "
                        "whole run")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--loss", choices=["ccc", "ccc+mse"], default="ccc",
                   help="training loss: 1-CCC, optionally + an MSE "
                        "term weighted by --mse-weight")
    p.add_argument("--mse-weight", type=float, default=0.0,
                   help="MSE term weight; > 0 implies --loss ccc+mse")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="decoupled AdamW weight decay (0 = plain Adam)")
    p.add_argument("--augment", action="store_true",
                   help="per-clip random horizontal flip (online "
                        "appearance stream only)")
    p.add_argument("--brightness-jitter", type=float, default=0.0,
                   help="per-clip brightness scale jitter j: [1-j, 1+j]")
    p.add_argument("--finetune-backbone", action="store_true",
                   help="unfreeze the ResNet (train-mode BN, "
                        "rematerialized backward); default keeps it "
                        "frozen like the reference")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-root", default=None,
                   help="validation dataset root (enables best-val ckpt)")
    p.add_argument("--eval-manifest", default=None)
    p.add_argument("--eval-every", type=int, default=1,
                   help="epochs between validations")
    p.add_argument("--loss-axis", choices=["time", "batch"], default=None,
                   help="CCC axis (default: batch for omg, time for "
                        "affwild2)")
    _add_common(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="CCC eval per dataset protocol")
    p.add_argument("--dataset", choices=["omg", "affwild2"], required=True)
    p.add_argument("--root", required=True)
    p.add_argument("--manifest", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--batch-streams", type=int, default=8,
                   help="sequences advanced together per forward "
                        "(batch-of-streams eval)")
    _add_common(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser(
        "predict-corpus",
        help="checkpointed batched inference over a video corpus")
    p.add_argument("--videos", required=True,
                   help="glob of video files, e.g. 'corpus/*.mp4'")
    p.add_argument("--out-dir", required=True,
                   help="CSV + resume-manifest directory")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--batch", type=int, default=8, help="clips per step")
    p.add_argument("--threads", type=int, default=4,
                   help="native loader threads")
    p.add_argument("--no-native", action="store_true",
                   help="force the pure-Python loader")
    p.add_argument("--smooth", type=int, default=1,
                   help="odd moving-average window over each output "
                        "series (1 = off)")
    p.add_argument("--align", action="store_true",
                   help="similarity-align crops, framed as predict "
                        "--align frames them. Landmark sidecars "
                        "(<video>.landmarks.npy / .openface.csv) route "
                        "through the Python loader; without sidecars the "
                        "C++ loader aligns from its own eye tracker")
    _add_common(p)
    p.set_defaults(fn=cmd_predict_corpus)

    p = sub.add_parser(
        "serve", help="JSON-lines serving daemon over stdin/stdout")
    p.add_argument("--ckpt", default=None, help="port checkpoint dir")
    p.add_argument("--capacity", type=int, default=8,
                   help="concurrent stream slots")
    p.add_argument("--chunk", type=int, default=16,
                   help="frames per stream_feed chunk")
    p.add_argument("--uint8-streams", action="store_true",
                   help="ship stream chunks as uint8 (4x less transfer)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the warm-up feed at startup (it builds the "
                        "kernels and folds the backbone)")
    p.add_argument("--allowed-root", default=None,
                   help="restrict every request path (video/crops/"
                        "boxes/landmarks/out_csv) to resolve under "
                        "this directory — REQUIRED if the protocol is "
                        "exposed to untrusted clients")
    _add_common(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "convert",
        help="reference .pth checkpoint(s) -> port checkpoint dir")
    p.add_argument("--backbone-pth", default=None,
                   help="ResNet-50 FER+ state_dict (.pth)")
    p.add_argument("--backbone-rename", default=None,
                   help="JSON {source: canonical-torchvision} name map "
                        "for non-torchvision backbone schemas")
    p.add_argument("--temporal-pth", default=None,
                   help="two-stream (micro CNN + GRUs + heads) .pth")
    p.add_argument("--temporal-prefix-map", default=None,
                   help="JSON {source-prefix: canonical-prefix} map")
    p.add_argument("--out", required=True, help="port checkpoint dir")
    p.add_argument("--no-strict", action="store_true",
                   help="skip unmapped tensors instead of erroring")
    p.add_argument("--verify", action="store_true",
                   help="forward the SOURCE .pth on the CPU (torch_ref) "
                        "and the converted model on the device on a fixed "
                        "input; print max |delta| per output and fail "
                        "(before writing anything) if they disagree")
    p.add_argument("--verify-tol", type=float, default=1e-3,
                   help="relative tolerance for --verify (max |delta| "
                        "over output scale)")
    _add_common(p)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("bench", help="benchmark harness: not ported yet "
                                     "(ROADMAP.md A15)")
    _add_common(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
