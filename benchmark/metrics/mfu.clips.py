"""The whole clip step's share (%) of the chip's bf16 peak: the
operations that the frames done need (the micro stream's luma, FFTs,
band masks and phase stage; the stem, layers 1-4 and head of the
backbone; the micro CNN, projection, GRUs and heads), from the
configuration's shapes, over the window."""

from benchmark.harness import readers, work


def read(run):
    p = run.mix
    flops = run.counts["calls"] * work.model_flops(run.config, p["clips"],
                                                   p["frames"])
    return readers.peak_pct(run, flops, work.PEAK_BF16_FLOP_PER_S)
