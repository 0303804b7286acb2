"""The bf16 stem kernel's share (%) of its roofline in the clip step: the
2x upscale, conv1, relu and max pool of every frame of a forward, one
launch (``csrc/stem.cu``, ``stem_kernel``), its products at the bf16
peak."""

from benchmark.harness import readers, work

PATTERN = r"\bstem_kernel\b"
LAUNCHES_PER_CALL = 1


def read(run):
    p = run.mix
    frames = p["clips"] * p["frames"]
    crop = run.config["clip"]["crop_size"]
    bound = work.bound_s(*work.stem_work(frames, crop, 2),
                         work.PEAK_BF16_FLOP_PER_S)
    return readers.roofline_pct(run, PATTERN, bound, LAUNCHES_PER_CALL)
