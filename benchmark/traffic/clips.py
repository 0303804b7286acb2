"""Offline clips: ``Mimamo.predict_clips`` in a closed loop.

A pool of ``pool`` distinct batches of ``clips`` x ``frames`` uint8
aligned face crops is made from the seed and kept on the host; the
window calls ``predict_clips`` on them in turn, back to back, and copies
each call's [clips, frames, 2] outputs to the host, as an offline corpus
job does. ``frames_per_s`` is every output frame over the whole window.

Correct: every call's outputs against the reference's for its batch
(``out_err``, ``harness/serving.py``).
"""

from __future__ import annotations

import time

import torch

from ..harness import data, program, serving


def setup(run) -> None:
    p, cfg = run.mix, run.config
    run.model = program.build_model(cfg, run.state, run.device)
    crop = cfg["clip"]["crop_size"]
    run.inputs = data.make_clips(run.seed, run.device, p["pool"], p["clips"],
                                 p["frames"], crop).cpu().numpy()
    for _ in range(p["warmup_calls"]):
        run.model.predict_clips(run.inputs[0]).cpu()


def window(run) -> None:
    model, pool = run.model, run.inputs
    outputs = []
    t0 = time.perf_counter()
    while True:
        i = len(outputs) % len(pool)
        with torch.profiler.record_function("clips.call"):
            out = model.predict_clips(pool[i]).cpu().numpy()
        outputs.append((i, out))
        if time.perf_counter() - t0 >= run.seconds:
            break
    elapsed = time.perf_counter() - t0
    frames = len(outputs) * out.shape[0] * out.shape[1]
    run.counts.update(attempted=len(outputs), calls=len(outputs),
                      frames=frames, window_s=elapsed)
    run.values["frames_per_s"] = frames / elapsed
    run.observed = outputs


def outputs(run, ref):
    """The reference's outputs for every checked item."""
    wanted = sorted({i for i, _ in run.observed})
    return {i: ref.clips(torch.from_numpy(run.inputs[i]))
            .cpu().numpy() for i in wanted}


def pairs(observed, want) -> list:
    """(program, reference) output arrays, one pair a checked item."""
    return [(out, want[i]) for i, out in observed]


def expected(run, ref):
    return serving.expected(outputs, run, ref)


def numbers(observed, want) -> dict:
    return serving.numbers(pairs, as_observed, observed, want)


def as_observed(want):
    """The reference's outputs in the form of the program's, so that a
    reference put in the program's place (the control) is judged alike."""
    return sorted(want.items())
