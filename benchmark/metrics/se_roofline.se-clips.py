"""The SE gate's squeeze and scale kernels' share (%) of their byte
roofline in the clip step (``csrc/bottleneck_epilogue.cu``,
``se_squeeze_kernel`` and ``se_scale_kernel``: one launch each a
bottleneck, 16 bottlenecks a forward).

The bound counts the bytes the gate's stage needs over all 16 blocks:
conv3's raw output read once, the residual (or the projection's raw
output) read once and the output written once, in bf16; 3 x 11.0 MB a
frame at a 224 backbone input, 12.7 GB a call of 8 x 48 frames. A design
that reads conv3's output twice (the squeeze, then the scale) tops out
near 75%. The excitation's small GEMMs between them are PyTorch's and
not counted."""

from benchmark.harness import readers, work

PATTERN = r"\bse_(squeeze|scale)_kernel\b"
LAUNCHES_PER_CALL = 2 * sum(blocks for blocks, _ in work.STAGES)
BYTES = 2                      # bf16


def conv3_elements(size: int) -> int:
    """Elements of the 16 conv3 outputs of one frame at a ``size``^2
    input (56^2 x 256 in layer1 down to 7^2 x 2048 in layer4)."""
    side, total = size // 4, 0
    for i, (blocks, width) in enumerate(work.STAGES):
        side = side if i == 0 else side // 2
        total += blocks * side * side * 4 * width
    return total


def read(run):
    p = run.mix
    frames = p["clips"] * p["frames"]
    nbytes = 3.0 * BYTES * frames * conv3_elements(
        run.config["backbone"]["input_size"])
    return readers.roofline_pct(run, PATTERN, work.bound_s(nbytes, 0.0, 1.0),
                                LAUNCHES_PER_CALL)
