"""Time the phase kernel of a checkout on the card.

    python3 mimamo_tpu_torch/bench_phase.py [ROOT] [--sweep]

ROOT is the root of the checkout whose ``mimamo_tpu_torch`` is timed (this
one when left out), so two revisions of the kernel can be timed in one run
on one card, in turns. The kernel is driven as that revision's forward
drives it (all scales through ``phase_diff_resize_scales`` where the
revision has it, else one ``phase_diff_resize`` per scale), on the bands of
seeded frames at the clip step (8 x 48 frames) and the streaming step
(8 x 17), without and with amplitude weighting, and held against the plain
version. A time is the median of 9 event-timed batches of 20 back-to-back
forwards after 5 warm-ups. Prints the card's name and power limit, then one
JSON line per shape. Needs one CUDA card.

``--sweep`` repeats that over a grid of the wrapper's two tuning constants
(``STRIP_BYTES``: the bytes of a frame a strip holds; ``TARGET_BLOCKS``: the
grid size the frames are cut into runs for), one JSON line per shape and
setting, for a revision whose wrapper has them.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys


SWEEP_STRIP_BYTES = (4096, 8192, 12288, 16384)
SWEEP_TARGET_BLOCKS = (528, 2112, 8448, 33792)


def time_ms(torch, fn) -> float:
    """Median over 9 event-timed batches of 20 back-to-back runs of ``fn``."""
    times = []
    for _ in range(9):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 20)
    return statistics.median(times)


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--sweep"]
    sweep = len(args) < len(sys.argv) - 1
    sys.path.insert(0, args[0] if args else ".")
    import torch
    from mimamo_tpu_torch import phase, pyramid
    from mimamo_tpu_torch.config import MimamoConfig
    from mimamo_tpu_torch.kernels import phase_kernel

    if not torch.cuda.is_available():
        print("bench_phase: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cfg = MimamoConfig()
    k, p = cfg.pyramid.orientations, cfg.phase.phase_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    one_launch = hasattr(phase_kernel, "phase_diff_resize_scales")
    settings = [(None, None)] if not sweep else [
        (sb, tb) for sb in SWEEP_STRIP_BYTES for tb in SWEEP_TARGET_BLOCKS]
    for b, t in ((8, 48), (8, 17)):
        frames = torch.rand((b, t, 112, 112), device="cuda",
                            generator=gen) * 255
        bands = list(pyramid.bands(
            frames, cfg.pyramid, pyramid.band_masks(cfg.pyramid,
                                                    frames.device)))
        out = torch.empty((b, t - 1, len(bands) * k, p, p), device="cuda")
        channels = [s * k for s in range(len(bands))]

        def forward(weighting):
            if one_launch:
                phase_kernel.phase_diff_resize_scales(bands, out, channels,
                                                      weighting)
            else:
                for band, channel in zip(bands, channels):
                    phase_kernel.phase_diff_resize(band, out, channel,
                                                   weighting)

        for strip_bytes, target_blocks in settings:
            rec = {"B": b, "T": t,
                   "launches": 1 if one_launch else len(bands)}
            if sweep:
                phase_kernel.STRIP_BYTES = strip_bytes
                phase_kernel.TARGET_BLOCKS = target_blocks
                phase_kernel._launch_plan.cache_clear()
                rec.update(strip_bytes=strip_bytes,
                           target_blocks=target_blocks)
            for weighting in (False, True):
                for _ in range(5):
                    forward(weighting)
                want = torch.cat([phase.phase_diff_resize(x, p, weighting)
                                  for x in bands], dim=2)
                rec[f"max_abs_err_w{int(weighting)}"] = (
                    out - want).abs().max().item()
                rec[f"ms_w{int(weighting)}"] = time_ms(
                    torch, lambda: forward(weighting))
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
