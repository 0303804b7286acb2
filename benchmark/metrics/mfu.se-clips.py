"""The whole clip step's share (%) of the chip's bf16 peak in an SE-ResNet
configuration: ``work.model_flops`` (the micro stream, ResNet-50's stem,
layers 1-4 and head, the temporal model) plus the gates' operations, from
the configuration's shapes, over the window.

A gate over conv3's output of C channels and H x W pixels, r the
configuration's ``backbone.se_reduction``: the squeeze's H W C adds, the
excitation's two fcs (2 C C / r multiply-adds, 2 operations each) and the
scale's H W C products. The residual add and relu are ResNet-50's and not
counted again."""

from benchmark.harness import readers, work


def gate_flops(cfg: dict, frames: int) -> float:
    """The gates' operations over ``frames`` frames (the stride in the
    first 1x1 conv of a stage's block 0, so a stage's blocks share one
    grid)."""
    r = cfg["backbone"]["se_reduction"]
    side = cfg["backbone"]["input_size"] // 4
    flops = 0.0
    for i, (blocks, width) in enumerate(work.STAGES):
        side = side if i == 0 else side // 2
        c = 4 * width
        flops += blocks * (2.0 * side * side * c + 4.0 * c * (c // r))
    return flops * frames


def read(run):
    p = run.mix
    frames = p["clips"] * p["frames"]
    flops = run.counts["calls"] * (
        work.model_flops(run.config, p["clips"], p["frames"])
        + gate_flops(run.config, frames))
    return readers.peak_pct(run, flops, work.PEAK_BF16_FLOP_PER_S)
