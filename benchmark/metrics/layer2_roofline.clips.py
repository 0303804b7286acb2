"""The layer2 kernel's share (%) of its roofline in the clip step:
ResNet-50's layer2 on every frame of a forward, one launch a bottleneck
block, four a forward (``csrc/layer2.cu``, ``block_kernel``), at the bf16
peak."""

from benchmark.harness import readers, work

PATTERN = r"\bblock_kernel\b"
LAUNCHES_PER_CALL = 4


def read(run):
    p = run.mix
    frames = p["clips"] * p["frames"]
    bound = work.bound_s(*work.layer2_work(
        frames, run.config["backbone"]["input_size"]),
        work.PEAK_BF16_FLOP_PER_S)
    return readers.roofline_pct(run, PATTERN, bound, LAUNCHES_PER_CALL)
