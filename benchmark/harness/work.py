"""The chip's published peaks and the work a stage needs, from shapes.

Bytes count each input byte read once and each output byte written once;
operations count 2 a multiply-add. The work is what the stage needs,
whatever the program runs to compute it. Copied from the port's own
measurement code (``mimamo_tpu_torch/bench/_timing.py`` for the peaks,
``chip_smoke.py``'s ``bound_ms``, ``stem_work``, ``phase_work`` and
``conv_flops``), so that the yardstick stays as it is when the program
changes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

# Published H100 SXM peaks (NVIDIA data sheet, dense), at a 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_FP32_FLOP_PER_S = 67e12

STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))


def bound_s(nbytes: float, flops: float, peak_flop_per_s: float) -> float:
    """The least time (s) the chip could take: the larger of the bytes over
    its memory rate and the operations over the peak rate of their type."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flop_per_s)


def conv_flops(frames: int, size: int = 224) -> Dict[str, float]:
    """Operations of ResNet-50's layers 1-4 over ``frames`` frames of
    ``size``^2 (the stride in the first 1x1 conv of a stage's block 0)."""
    out, inplanes, side = {}, 64, size // 4
    for i, (blocks, width) in enumerate(STAGES):
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


def stem_work(frames: int, crop: int, out_bytes: int) -> Tuple[float, float]:
    """The stem (2x upscale, conv1 7x7/2, relu, 3x3/2 max pool) on
    ``frames`` fp32 crops of ``crop``^2: the crops read once and the pooled
    [crop/2]^2 x 64 map written once (``out_bytes`` an element); conv1's
    147 multiply-adds per output pixel (crop^2 of them) and channel."""
    return (frames * crop * crop * 3 * 4.0
            + frames * (crop // 2) ** 2 * 64 * out_bytes,
            2.0 * frames * crop * crop * 64 * 147)


def layer2_work(frames: int, size: int = 224) -> Tuple[float, float]:
    """ResNet-50's layer2 in bf16 on ``frames`` frames: its [size/4]^2 x
    256 input read once, its [size/8]^2 x 512 output written once and its
    weights read once; the operations of its convs."""
    s4, s8 = size // 4, size // 8
    weights = (256 * 128 + 9 * 128 * 128 + 128 * 512 + 256 * 512
               + 3 * (512 * 128 + 9 * 128 * 128 + 128 * 512))
    return (2.0 * (frames * (s4 * s4 * 256 + s8 * s8 * 512) + weights),
            conv_flops(frames, size)["layer2"])


def phase_work(clips: int, frames: int, cfg: dict) -> Tuple[float, float]:
    """The phase stage (phase difference of consecutive frames and the
    bilinear resize) over ``clips`` x ``frames`` frames: every complex64
    band value read once and every fp32 output written once; per source
    pixel of a pair 6 operations for the complex product and 24 for the
    angle, per output pixel 9 for the 2 x 2 taps."""
    pyr = cfg["pyramid"]
    h, w = pyr["input_size"]
    k, p = pyr["orientations"], cfg["phase"]["phase_size"]
    values = sum(clips * frames * k * (h >> s) * (w >> s)
                 for s in range(pyr["height"]))
    pairs = values // frames * (frames - 1)
    outputs = clips * (frames - 1) * pyr["height"] * k * p * p
    return 8.0 * values + 4.0 * outputs, 30.0 * pairs + 9.0 * outputs


def _fft_flops(h: int, w: int) -> float:
    """A complex h x w FFT: 5 n log2 n."""
    n = h * w
    return 5.0 * n * math.log2(n)


def micro_flops(cfg: dict, clips: int, frames: int) -> float:
    """The micro stream's phase stacks for ``clips`` x ``frames`` frames:
    luma, the forward FFT of every frame, the band masks and inverse FFTs,
    and the phase stage."""
    pyr = cfg["pyramid"]
    h, w = pyr["input_size"]
    k = pyr["orientations"]
    n = clips * frames
    flops = n * (5.0 * h * w + _fft_flops(h, w))
    for s in range(pyr["height"]):
        hs, ws = h >> s, w >> s
        flops += n * k * (6.0 * hs * ws + _fft_flops(hs, ws))
    return flops + phase_work(clips, frames, cfg)[1]


def micro_cnn_flops(cfg: dict, pairs: int) -> float:
    """The micro CNN and its fc on ``pairs`` phase stacks."""
    pyr, t = cfg["pyramid"], cfg["temporal"]
    flops = 0.0
    c, side = pyr["height"] * pyr["orientations"], cfg["phase"]["phase_size"]
    for feats in t["micro_cnn_features"]:
        flops += pairs * 2.0 * side * side * c * feats * 9
        c, side = feats, side // 2
    flops += pairs * 2.0 * c * side * side * t["micro_embed_dim"]
    return flops


def backbone_flops(cfg: dict, frames: int) -> float:
    """The stem, layers 1-4 and the FER+ head over ``frames`` frames."""
    b = cfg["backbone"]
    crop = cfg["pyramid"]["input_size"][0]
    return (stem_work(frames, crop, 2)[1]
            + sum(conv_flops(frames, b["input_size"]).values())
            + 2.0 * frames * b["feature_dim"] * b["num_classes"])


def temporal_flops(cfg: dict, clips: int, frames: int) -> float:
    """The temporal model over ``clips`` x ``frames`` frames in clip mode:
    the micro CNN on every pair, the macro projection, both GRUs (one step
    a frame), fusion and head."""
    t, b = cfg["temporal"], cfg["backbone"]
    h = t["gru_hidden"]
    per_frame = (2.0 * b["feature_dim"] * t["macro_embed_dim"]
                 + 2.0 * 3 * h * (t["micro_embed_dim"] + h)
                 + 2.0 * 3 * h * (t["macro_embed_dim"] + h)
                 + 2.0 * 2 * h * t["fusion_hidden"]
                 + 2.0 * t["fusion_hidden"] * t["num_outputs"])
    return (micro_cnn_flops(cfg, clips * (frames - 1))
            + clips * frames * per_frame)


def model_flops(cfg: dict, clips: int, frames: int) -> float:
    """A forward's operations in clip mode: the phase stacks, the backbone
    and the temporal model on every frame."""
    return (micro_flops(cfg, clips, frames)
            + backbone_flops(cfg, clips * frames)
            + temporal_flops(cfg, clips, frames))
