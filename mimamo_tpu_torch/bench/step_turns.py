"""Time the clip step, a stream feed and their stages of two checkouts on
one card, in turns.

    python3 mimamo_tpu_torch/bench/step_turns.py ROOT_A ROOT_B

Runs A, B, B, A, each turn in a process of its own that imports the
``mimamo_tpu_torch`` and the ``chip_smoke.py`` of its root (so each side
builds and runs its own kernels) and measures, at the flagship bf16
config with seeded weights and uint8 clips: the clip step (8 x 48,
``predict_clips`` to the result on the host, median of 10 after 3
warm-ups), its stages (``chip_smoke.stage_breakdown``, median of 5), a
``StreamingSession`` feed (8 slots x 16 frames to the result's
``.cpu()``, median of 20 after 2 warm-ups) and its stages. Prints the
card's name and power limit, one JSON line per turn and last a summary:
each side's medians over its two turns and B / A. Needs one CUDA card.

Run it as a file, not with ``-m``: a turn must import its own root's
package, not this one's.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

TURN_TIMEOUT_S = 900
STEP_RUNS, FEED_RUNS, STAGE_RUNS = 10, 20, 5


def measure(root: str) -> dict:
    """One turn, in this process, with ``root``'s code."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from mimamo_tpu_torch import weights
    from mimamo_tpu_torch.config import BackboneSpec, MimamoConfig
    from mimamo_tpu_torch.runner import Mimamo

    if not torch.cuda.is_available():
        raise RuntimeError("step_turns: no CUDA device")
    b, t, s, chunk = cs.B, cs.T, cs.S, cs.CHUNK
    cfg = MimamoConfig(backbone=BackboneSpec(dtype="bfloat16"))
    model = Mimamo(cfg)
    model.load_state_dict(weights.init_variables(cfg, cs.SEED))
    clips = np.random.default_rng(cs.SEED).integers(
        0, 256, (b, t, s, s, 3), dtype=np.uint8)
    with torch.no_grad():
        for _ in range(3):
            model.predict_clips(clips)
        torch.cuda.synchronize()
        steps = []
        while len(steps) < STEP_RUNS:
            steps += cs.clip_step_ms(model, clips)
        stages = cs.median_stages([cs.stage_breakdown(model, clips)
                                   for _ in range(STAGE_RUNS)])
        sess, _ = cs.fill_session(model, clips)
        feeds = [{slot: clips[slot, i:i + chunk] for slot in range(b)}
                 for i in range(0, t, chunk)]
        for i in range(2):
            sess.feed(feeds[i])
        feed_ms = []
        for i in range(FEED_RUNS):
            t0 = time.perf_counter()
            sess.feed(feeds[i % len(feeds)])
            feed_ms.append((time.perf_counter() - t0) * 1e3)
        context = torch.from_numpy(clips[:, :1]).cuda()
        feed_stages = cs.median_stages([
            cs.stage_breakdown(model, clips[:, :chunk], context)
            for _ in range(STAGE_RUNS)])
    return {"root": root, "step_ms": statistics.median(steps),
            "steps_ms": steps, "stage_ms": stages,
            "feed_ms": statistics.median(feed_ms), "feeds_ms": feed_ms,
            "feed_stage_ms": feed_stages}


def turn(root: str) -> dict:
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--measure", root],
        cwd=root, capture_output=True, text=True, timeout=TURN_TIMEOUT_S)
    if out.returncode:
        raise RuntimeError(f"turn on {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def summary(rows: list, roots: list) -> dict:
    keys = {"step_ms": lambda r: r["step_ms"],
            "feed_ms": lambda r: r["feed_ms"]}
    for stage in ("grayscale", "fft_bands"):
        keys[f"step_{stage}_ms"] = lambda r, k=stage: r["stage_ms"][k]
        keys[f"feed_{stage}_ms"] = lambda r, k=stage: r["feed_stage_ms"][k]
    side = {root: {k: statistics.median(f(r) for r in rows
                                        if r["root"] == root)
                   for k, f in keys.items()} for root in roots}
    a, b = (side[root] for root in roots)
    return {"sides": side, "b_over_a": {k: b[k] / a[k] for k in keys}}


def main(argv: list) -> int:
    if argv[:1] == ["--measure"]:
        print(json.dumps(measure(os.path.abspath(argv[1]))), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in argv]
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(line, flush=True)
    rows = []
    for root in (roots[0], roots[1], roots[1], roots[0]):
        rows.append(turn(root))
        print(json.dumps({**rows[-1], "card": line}), flush=True)
    print(json.dumps({"step_turns": summary(rows, roots), "card": line}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
