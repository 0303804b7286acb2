"""Spans in the port (``mimamo_tpu_torch.tracing``), on the CPU at a small
config: with tracing off the entry points record nothing and call neither
``record_function`` nor a CUDA event; with it on each entry yields its
span tree (names, parents, one request id a call, no device time on the
CPU), also in a ``torch.profiler`` trace; the outputs are bit-equal on and
off; ``collect`` clears the list; threads keep their own stacks."""

import threading

import numpy as np
import pytest
import torch

from mimamo_tpu_torch import StreamingSession, tracing, train, weights
from mimamo_tpu_torch import config as tc
from mimamo_tpu_torch.runner import Mimamo

# crop 32 -> backbone input 64; 2 scales x 2 orientations; small temporal
B, T, S = 2, 4, 32
CFG = tc.MimamoConfig(
    pyramid=tc.PyramidSpec(height=2, orientations=2, input_size=(S, S)),
    phase=tc.PhaseSpec(phase_size=16),
    backbone=tc.BackboneSpec(input_size=2 * S),
    temporal=tc.TemporalSpec(micro_cnn_features=(8,), micro_embed_dim=16,
                             macro_embed_dim=16, gru_hidden=16,
                             fusion_hidden=16),
    clip=tc.ClipSpec(clip_len=T, stride=2, crop_size=S))
ENTRIES = ("predict_clips", "feed", "train_step")


def _micro_backbone(parent):
    """(name, parent's name) of the phase stage and the backbone."""
    return [("micro", parent), ("micro.bands", "micro"),
            ("micro.phase_kernel", "micro"), ("backbone", parent),
            *[(f"backbone.{stage}", "backbone") for stage in
              ("stem", "layer1", "layer2", "layer3", "layer4", "pool")]]


def _forward(parent):
    return [("runner.forward", parent), ("runner.h2d", "runner.forward"),
            *_micro_backbone("runner.forward"),
            ("temporal", "runner.forward")]


TREES = {
    "predict_clips": [("runner.predict_clips", None),
                      *_forward("runner.predict_clips")],
    "feed": [("streaming.feed", None),
             ("streaming.assemble", "streaming.feed"),
             *_forward("streaming.feed"),
             ("streaming.commit", "streaming.feed"),
             ("streaming.d2h", "streaming.feed")],
    "train_step": [("train.step", None), *_micro_backbone("train.step"),
                   ("temporal", "train.step"), ("train.loss", "train.step"),
                   ("train.backward", "train.step"),
                   ("train.optimizer", "train.step")],
}
SPAN_NAMES = {name for tree in TREES.values() for name, _ in tree}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.enable(False)
    tracing.collect()
    yield
    tracing.enable(False)
    tracing.collect()


@pytest.fixture(scope="module")
def state():
    return weights.init_variables(CFG, 0)


def _entry(name, state):
    """A call of entry point ``name`` on a fresh model (each call after the
    first carries state on: a stream's context, Adam's moments); it
    returns the outputs to compare."""
    model = Mimamo(CFG, device="cpu")
    model.load_state_dict(state)
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
    if name == "predict_clips":
        return lambda: [model.predict_clips(clips)]
    if name == "feed":
        sess = StreamingSession(model, capacity=B, chunk=T, dtype=np.uint8)
        slots = [sess.add_stream() for _ in range(B)]
        return lambda: [torch.from_numpy(v) for v in sess.feed(
            {s: clips[s] for s in slots}).values()]
    st = train.create_train_state(model)
    step = train.make_train_step(model)
    batch = {"clips": clips,
             "labels": np.tanh(rng.normal(size=(B, T, 2))).astype(np.float32),
             "mask": np.ones((B, T), np.float32)}

    def run():
        _, metrics = step(st, batch)
        return [metrics["loss"], *(p.detach().clone()
                                   for p in model.temporal.parameters())]
    return run


@pytest.fixture
def counted_ranges(monkeypatch):
    """The names ``torch.profiler.record_function`` is entered with (it
    still runs); a CUDA event raises."""
    names = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        names.append(name)
        return real(name, *args, **kwargs)

    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event on the CPU")

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    return names


def _profiled(fn, calls=2):
    """``calls`` calls of ``fn`` under a CPU ``torch.profiler`` run; returns
    the names of the events it recorded."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("name", ENTRIES)
def test_off_records_nothing(name, state, counted_ranges):
    seen = _profiled(_entry(name, state))
    assert tracing.collect() == []
    assert counted_ranges == []
    assert not seen & SPAN_NAMES


@pytest.mark.parametrize("name", ENTRIES)
def test_on_gives_the_span_tree(name, state, counted_ranges):
    tracing.enable()
    seen = _profiled(_entry(name, state))
    records = tracing.collect()
    tree = TREES[name]
    assert [(r.name, None if r.parent is None else records[r.parent].name)
            for r in records] == tree * 2
    requests = [r.request for r in records]
    n = len(tree)
    assert len(set(requests[:n])) == len(set(requests[n:])) == 1
    assert requests[0] != requests[n]
    assert all(r.device_ms is None and r.start is None for r in records)
    assert counted_ranges == [span for span, _ in tree] * 2
    assert {span for span, _ in tree} <= seen


@pytest.mark.parametrize("name", ENTRIES)
def test_same_outputs_on_and_off(name, state):
    off = _entry(name, state)
    want = [off(), off()]
    tracing.enable()
    on = _entry(name, state)
    got = [on(), on()]
    for a, b in zip(want, got):
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_collect_clears_and_off_is_one_null_context():
    assert tracing.span("a") is tracing.span("b")
    tracing.enable()
    assert tracing.enabled()
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    with tracing.span("c", "cpu"):
        pass
    records = tracing.collect()
    assert [(r.name, r.parent) for r in records] == [
        ("a", None), ("b", 0), ("c", None)]
    assert records[0].request == records[1].request != records[2].request
    assert tracing.collect() == []


def test_threads_keep_their_own_stacks():
    tracing.enable()
    barrier = threading.Barrier(2)

    def work(tag):
        with tracing.span(f"{tag}.outer"):
            barrier.wait(timeout=10)
            with tracing.span(f"{tag}.inner"):
                barrier.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    records = tracing.collect()
    by_name = {r.name: r for r in records}
    assert len(records) == len(by_name) == 4
    for tag in "ab":
        outer, inner = by_name[f"{tag}.outer"], by_name[f"{tag}.inner"]
        assert outer.parent is None
        assert records[inner.parent] is outer
        assert inner.request == outer.request
    assert by_name["a.outer"].request != by_name["b.outer"].request
