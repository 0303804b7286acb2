"""End-to-end demo: synthesize a video, run the two-step pipeline and the
fused predict on it.

Counterpart of ``examples/demo.py``, with the same stages and the same
small default geometry. No sample video ships with the repository, so the
demo writes one (a moving face-like blob), then runs every user-facing
stage: crops (``VideoProcessor``), cached features (``FeatureExtractor``)
and the per-frame (valence, arousal) series (``MimamoAPI.predict`` with
alignment). The weights are random (no accuracy is computable here; use
``cli eval`` on a labeled dataset for CCC)::

    python -m mimamo_tpu_torch.examples.demo [--cpu] [--out-dir DIR]

It runs on the card, or on the CPU with ``--cpu``.
"""

import argparse
import json
import os
import tempfile

import numpy as np


def synthesize_video(path: str, frames: int = 96, size: int = 160) -> None:
    """A seeded face-like blob with a moving mouth, as an mp4."""
    from mimamo_tpu_torch.io import decode
    rng = np.random.default_rng(0)
    vid = np.zeros((frames, size, size, 3), np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for t in range(frames):
        cy = size / 2 + 10 * np.sin(t / 9.0)
        cx = size / 2 + 12 * np.cos(t / 13.0)
        blob = np.exp(-(((yy - cy) / 26.0) ** 2 + ((xx - cx) / 20.0) ** 2))
        mouth = np.exp(-(((yy - cy - 12) / 3.0) ** 2 +
                         ((xx - cx) / (6 + 3 * np.sin(t / 5.0))) ** 2))
        frame = (blob[..., None] * [210, 170, 150]
                 + mouth[..., None] * [-60, -60, -60]
                 + rng.uniform(0, 25, (size, size, 3)))
        vid[t] = np.clip(frame, 0, 255).astype(np.uint8)
    decode.write_video(path, vid)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "mimamo_demo"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--full-size", action="store_true",
                    help="use the flagship 112/224 geometry")
    args = ap.parse_args(argv)

    from mimamo_tpu_torch.api import (FeatureExtractor, MimamoAPI,
                                      VideoProcessor)
    from mimamo_tpu_torch.config import (BackboneSpec, ClipSpec,
                                         MimamoConfig, PhaseSpec,
                                         PyramidSpec, TemporalSpec)
    device = "cpu" if args.cpu else None

    os.makedirs(args.out_dir, exist_ok=True)
    video = os.path.join(args.out_dir, "demo.mp4")
    synthesize_video(video)
    print(f"[1/4] synthesized {video}")

    if args.full_size:
        config = MimamoConfig()
    else:
        config = MimamoConfig(
            pyramid=PyramidSpec(height=2, orientations=4,
                                input_size=(64, 64)),
            phase=PhaseSpec(phase_size=32),
            backbone=BackboneSpec(input_size=64),
            temporal=TemporalSpec(micro_cnn_features=(16, 32),
                                  micro_embed_dim=64, macro_embed_dim=64,
                                  gru_hidden=64, fusion_hidden=64),
            clip=ClipSpec(clip_len=24, stride=12, crop_size=64))

    # the reference's two steps: crops, then cached features
    vp = VideoProcessor(save_size=config.clip.crop_size, config=config,
                        device=device)
    crops = vp.process(video, args.out_dir)
    feats = FeatureExtractor(config=config, device=device).extract(crops)
    print(f"[2/4] crops -> {crops}")
    print(f"[3/4] features -> {feats} "
          f"{np.load(feats).shape} (random-init weights: demo only)")

    # the fused end-to-end predict
    api = MimamoAPI(config=config, device=device)
    out_csv = os.path.join(args.out_dir, "predictions.csv")
    series = api.predict(video, out_csv=out_csv, align=True)
    print(f"[4/4] per-frame (valence, arousal) -> {out_csv}")
    print(json.dumps({
        "frames": len(series),
        "valence": [round(float(v), 3) for v in series[:6, 0]],
        "arousal": [round(float(a), 3) for a in series[:6, 1]],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
