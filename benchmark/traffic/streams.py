"""Live streams: ``StreamingSession.feed`` under an open loop.

``streams`` cameras of ``fps`` frames a second each send aligned face
crops; a stream's chunk of ``chunk`` frames is due when its last frame
has arrived, every ``chunk / fps`` seconds. The streams are live when the
window opens: stream s's first chunk is due at a phase drawn from the
seed, uniform over the first chunk period. Whenever the session is free,
the scheduler feeds every chunk that is due (one a stream) in one
``feed``; when none is due it sleeps until the next. A chunk's latency
runs from the moment it was due to the moment its predictions are on the
host, so a stall counts against every chunk that waits behind it. The
chunks due before the window closes are all served; ``feed_p95_ms`` is
the 95th percentile over them. How late the scheduler woke for a due
chunk is reported beside it.

A stream's chunks are drawn in turn from a pool of ``pool_chunks`` chunks
made from the seed, from an offset drawn from the seed.

Correct: ``check_streams`` streams drawn from the seed, every chunk the
window served them, against the reference over each stream's whole
sequence of frames in clip mode (``out_err``, ``harness/serving.py``): a
stream fed chunk by chunk with its GRU state and pair context carried
equals that.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mimamo_tpu_torch.streaming import StreamingSession

from ..harness import data, program, serving


def setup(run) -> None:
    p, cfg = run.mix, run.config
    run.model = program.build_model(cfg, run.state, run.device)
    crop = cfg["clip"]["crop_size"]
    pool = data.make_clips(run.seed, run.device, 1, p["pool_chunks"],
                           p["chunk"], crop)[0].cpu().numpy()
    r = data.rng(run.seed, "order")
    period = p["chunk"] / p["fps"]
    run.inputs = {"pool": pool,
                  "offset": r.integers(0, p["pool_chunks"], p["streams"]),
                  "phase": r.uniform(0, period, p["streams"]),
                  "period": period,
                  "checked": sorted(r.choice(p["streams"], p["check_streams"],
                                             replace=False).tolist())}
    # the feed's shapes, warmed on a session of their own: the measured
    # session starts with every stream fresh
    warm = StreamingSession(run.model, capacity=p["capacity"],
                            chunk=p["chunk"], dtype=np.uint8)
    slots = [warm.add_stream() for _ in range(p["streams"])]
    for _ in range(p["warmup_feeds"]):
        warm.feed({s: pool[s % len(pool)] for s in slots})
    del warm
    run.program = StreamingSession(run.model, capacity=p["capacity"],
                                   chunk=p["chunk"], dtype=np.uint8)
    for s in range(p["streams"]):
        if run.program.add_stream() != s:
            raise RuntimeError("the session gave slots out of order")


def window(run) -> None:
    session, x = run.program, run.inputs
    pool, offset, phase, period = (x["pool"], x["offset"], x["phase"],
                                   x["period"])
    n = len(phase)
    checked = set(x["checked"])
    served = np.zeros(n, np.int64)           # chunks fed so far, a stream
    latency, feed_s, late, lanes = [], [], [], 0
    outputs = {s: [] for s in checked}
    t0 = time.perf_counter()
    close = t0 + run.seconds
    while True:
        now = time.perf_counter()
        due = t0 + phase + served * period
        ready = np.nonzero((due <= now) & (due < close))[0]
        if ready.size == 0:
            pending = due[due < close]
            if pending.size == 0:
                break
            wake = pending.min()
            with torch.profiler.record_function("streams.wait"):
                time.sleep(max(0.0, wake - now))
            late.append(time.perf_counter() - wake)
            continue
        frames = {int(s): pool[(offset[s] + served[s]) % len(pool)]
                  for s in ready}
        start = time.perf_counter()
        with torch.profiler.record_function("streams.feed"):
            out = session.feed(frames)
        done = time.perf_counter()
        feed_s.append(done - start)
        latency.extend((done - due[ready]).tolist())
        lanes += len(ready)
        for s in ready:
            if s in checked:
                outputs[int(s)].append(out[int(s)])
        served[ready] += 1
    elapsed = time.perf_counter() - t0
    run.counts.update(attempted=int(served.sum()), feeds=len(feed_s),
                      lanes_fed=lanes,
                      lanes_run=len(feed_s) * session.capacity,
                      feed_s=feed_s, latency_s=latency,
                      late_s=late, window_s=elapsed,
                      served=served.tolist(),
                      report={"chunks": int(served.sum()),
                              "feeds": len(feed_s),
                              "generator_late_max_ms":
                                  max(late, default=0.0) * 1e3,
                              "sleeps": len(late)})
    run.values["feed_p95_ms"] = float(np.percentile(latency, 95)) * 1e3
    run.observed = {s: np.concatenate(o) for s, o in outputs.items()}


def _frames(run, s: int) -> np.ndarray:
    x = run.inputs
    k = run.counts["served"][s]
    pool = x["pool"]
    return np.concatenate([pool[(x["offset"][s] + i) % len(pool)]
                           for i in range(k)])


def outputs(run, ref):
    """The reference's outputs for every checked item."""
    return {s: ref.clips(torch.from_numpy(_frames(run, s))[None])[0]
            .cpu().numpy() for s in run.observed}


def pairs(observed, want) -> list:
    """(program, reference) output arrays, one pair a checked item."""
    return [(observed[s], want[s]) for s in sorted(observed)]


def expected(run, ref):
    return serving.expected(outputs, run, ref)


def numbers(observed, want) -> dict:
    return serving.numbers(pairs, as_observed, observed, want)


def as_observed(want):
    """The reference's outputs in the form of the program's, so that a
    reference put in the program's place (the control) is judged alike."""
    return want
