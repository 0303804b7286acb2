"""The phase kernel's share (%) of its roofline in the clip step: the
phase difference and bilinear resize of every scale of a forward, one
launch (``csrc/phase_diff_resize.cu``)."""

from benchmark.harness import readers, work

PATTERN = r"\bphase_diff_resize_kernel\b"
LAUNCHES_PER_CALL = 1


def read(run):
    p = run.mix
    bound = work.bound_s(*work.phase_work(p["clips"], p["frames"],
                                          run.config),
                         work.PEAK_FP32_FLOP_PER_S)
    return readers.roofline_pct(run, PATTERN, bound, LAUNCHES_PER_CALL)
