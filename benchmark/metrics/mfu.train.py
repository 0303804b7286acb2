"""The whole train step's share (%) of the chip's fp32 peak (TF32 is off):
the forward operations of the micro stream's phase stacks and of the
frozen backbone, plus three times the temporal model's (forward and
backward), from the configuration's shapes, over the window."""

from benchmark.harness import readers, work


def read(run):
    p, cfg = run.mix, run.config
    b, t = p["clips"], p["frames"]
    step = (work.micro_flops(cfg, b, t) + work.backbone_flops(cfg, b * t)
            + 3 * work.temporal_flops(cfg, b, t))
    return readers.peak_pct(run, run.counts["steps"] * step,
                            work.PEAK_FP32_FLOP_PER_S)
