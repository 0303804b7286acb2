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

Every subcommand runs on the card, or on the CPU with ``--cpu``; without a
card and without ``--cpu`` it raises. ``--ckpt`` names a port checkpoint
directory (``checkpoints.save``, as ``train`` writes it), not an orbax
one: convert JAX weights with ``weights.from_jax_variables``.

What the JAX CLI has and this one does not:

  * model variants (``--streams``, ``--snippet-len``, ``--gru-layers``,
    ``--appearance-stride``, a ``--backbone-size`` other than twice
    ``--crop-size``): registered with the JAX defaults; another value
    exits naming ROADMAP.md A16;
  * flags that chose a TPU lowering (``--fft-mode``, ``--stem-mode``,
    ``--use-pallas``): not registered, the port has one lowering each
    (cuFFT, the stem kernel, the kernels always on);
  * multi-process and data-parallel flags (``--data-parallel``,
    ``--coordinator``, ``--num-processes``, ``--process-id``; A12), and
    ``train --tensorboard`` / ``--debug-nans``: not registered yet;
  * the ``convert`` and ``bench`` subcommands: not ported yet.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
from typing import Optional

import numpy as np

from .config import (BackboneSpec, ClipSpec, MimamoConfig, PhaseSpec,
                     PyramidSpec, TrainSpec)

# model-variant flags: the port runs only the JAX defaults (ROADMAP.md A16)
_VARIANT_DEFAULTS = {"streams": "both", "snippet_len": 1, "gru_layers": 1,
                     "appearance_stride": 1}


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--clip-len", type=int, default=48)
    p.add_argument("--stride", type=int, default=24)
    p.add_argument("--crop-size", type=int, default=112)
    p.add_argument("--backbone-size", type=int, default=224,
                   help="backbone input; the port runs it at twice "
                        "--crop-size only")
    p.add_argument("--pyramid-height", type=int, default=3)
    p.add_argument("--orientations", type=int, default=4)
    p.add_argument("--phase-size", type=int, default=48)
    p.add_argument("--snippet-len", type=int, default=1,
                   help="frames per snippet (only 1 is ported)")
    p.add_argument("--gru-layers", type=int, default=1,
                   help="stacked GRU layers per stream (only 1 is ported)")
    p.add_argument("--streams", default="both",
                   choices=["both", "micro", "macro"],
                   help="stream ablation (only 'both' is ported)")
    p.add_argument("--appearance-stride", type=int, default=1,
                   help="run the ResNet every k-th frame (only 1 is "
                        "ported)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")


def _config(args) -> MimamoConfig:
    for name, default in _VARIANT_DEFAULTS.items():
        if getattr(args, name) != default:
            raise SystemExit(
                f"--{name.replace('_', '-')} {getattr(args, name)}: model "
                f"variants are not ported yet (ROADMAP.md A16); the port "
                f"runs {default!r}")
    s = args.crop_size
    if args.backbone_size != 2 * s:
        raise SystemExit(
            f"--backbone-size {args.backbone_size}: the port runs the "
            f"backbone at twice --crop-size ({2 * s}) only; other inputs "
            f"are not ported yet (ROADMAP.md A16)")
    return MimamoConfig(
        pyramid=PyramidSpec(height=args.pyramid_height,
                            orientations=args.orientations,
                            input_size=(s, s)),
        phase=PhaseSpec(phase_size=args.phase_size),
        backbone=BackboneSpec(input_size=args.backbone_size,
                              dtype=args.dtype),
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

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
