"""The fp32 stem kernel's share (%) of its roofline in the train step:
the frozen backbone's stem on every frame of a step, one launch
(``csrc/stem.cu``, ``stem_kernel_f32``, 3xTF32), three TF32 products for
each fp32 one at the TF32 peak."""

from benchmark.harness import readers, work

PATTERN = r"\bstem_kernel_f32\b"
LAUNCHES_PER_CALL = 1


def read(run):
    p = run.mix
    frames = p["clips"] * p["frames"]
    nbytes, flops = work.stem_work(frames, run.config["clip"]["crop_size"], 4)
    bound = work.bound_s(nbytes, 3 * flops, work.PEAK_TF32_FLOP_PER_S)
    return readers.roofline_pct(run, PATTERN, bound, LAUNCHES_PER_CALL)
