"""The streaming path on the CPU, in f32, against the JAX package: the
temporal model with carries, ``predict_stream`` chunk by chunk, and
``StreamingSession`` (the cases of tests/test_streaming.py). Weights are
carried over by ``weights.from_jax_variables``; inputs come from numpy
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimamo_tpu import config as jc
from mimamo_tpu import temporal as jtemporal
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import config as tc
from mimamo_tpu_torch import temporal as ttemporal
from mimamo_tpu_torch import streaming, weights
from mimamo_tpu_torch.runner import Mimamo
from mimamo_tpu_torch.streaming import StreamingSession

# crop 32 -> backbone input 64; 2 scales x 2 orientations
S, CHUNK, CAPACITY = 32, 4, 3
SMALL_TEMPORAL = dict(micro_cnn_features=(8,), micro_embed_dim=16,
                      macro_embed_dim=16, gru_hidden=16, fusion_hidden=16)


def _configs(weighting=False):
    jcfg = jc.MimamoConfig(
        pyramid=jc.PyramidSpec(height=2, orientations=2, input_size=(S, S)),
        phase=jc.PhaseSpec(phase_size=16, amplitude_weighting=weighting),
        backbone=jc.BackboneSpec(input_size=2 * S),
        temporal=jc.TemporalSpec(**SMALL_TEMPORAL),
        clip=jc.ClipSpec(clip_len=CHUNK, stride=2, crop_size=S))
    tcfg = tc.MimamoConfig(
        pyramid=tc.PyramidSpec(height=2, orientations=2, input_size=(S, S)),
        phase=tc.PhaseSpec(phase_size=16, amplitude_weighting=weighting),
        backbone=tc.BackboneSpec(input_size=2 * S),
        temporal=tc.TemporalSpec(**SMALL_TEMPORAL),
        clip=tc.ClipSpec(clip_len=CHUNK, stride=2, crop_size=S))
    return jcfg, tcfg


def _video(t, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (t, S, S, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    """One set of weights in both packages, and the JAX ``predict_stream``
    of two 12-frame videos over 3 chunks."""
    jcfg, tcfg = _configs()
    jm = JaxMimamo(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init_variables(jax.random.PRNGKey(0), clip_len=CHUNK))
    state = weights.from_jax_variables(variables)
    videos = np.stack([_video(12, 1), _video(12, 2)])
    outs, carries = [], None
    for start in range(0, 12, CHUNK):
        out, carries = jm.predict_stream(
            variables, jnp.asarray(videos[:, start:start + CHUNK]), carries)
        outs.append(np.asarray(out))
    model = Mimamo(tcfg, device="cpu")
    model.load_state_dict(state)
    return model, state, videos, np.concatenate(outs, axis=1)


def _stream(model, video, chunk=CHUNK):
    """The port's ``predict_stream`` over one video [T, S, S, 3]."""
    outs, carries = [], None
    for start in range(0, video.shape[0], chunk):
        out, carries = model.predict_stream(video[None, start:start + chunk],
                                            carries)
        outs.append(out[0].numpy())
    return np.concatenate(outs, axis=0)


# -- temporal model with carries ---------------------------------------------

@pytest.mark.parametrize("mode", ["clip", "stream", "stream_invalid"])
def test_two_stream_rnn_carries_match_jax(mode):
    """Outputs and both carries vs JAX ``TwoStreamRNN.apply``, atol 1e-5:
    clip mode (T-1 pairs, zero carries), streaming (T pairs, carries in)
    and streaming with ``first_pair_invalid`` on some rows."""
    b, t, c, p, f = 3, 5, 4, 16, 32
    tm1 = t - 1 if mode == "clip" else t
    rng = np.random.default_rng(5)
    phases = rng.uniform(-np.pi, np.pi, (b, tm1, c, p, p)).astype(np.float32)
    feats = rng.standard_normal((b, t, f)).astype(np.float32)
    carries = None if mode == "clip" else tuple(
        rng.standard_normal((b, 16)).astype(np.float32) for _ in range(2))
    invalid = (np.array([True, False, True]) if mode == "stream_invalid"
               else None)
    jmodel = jtemporal.TwoStreamRNN(jc.TemporalSpec(**SMALL_TEMPORAL))
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(3), jnp.asarray(phases), jnp.asarray(feats)))
    want, want_carries = jmodel.apply(
        variables, jnp.asarray(phases), jnp.asarray(feats),
        None if carries is None else tuple(map(jnp.asarray, carries)),
        first_pair_invalid=None if invalid is None else jnp.asarray(invalid))
    tmodel = ttemporal.TwoStreamRNN(tc.TemporalSpec(**SMALL_TEMPORAL), c, p,
                                    f).eval()
    tmodel.load_state_dict(weights.temporal_from_jax(variables))
    with torch.no_grad():
        got, got_carries = tmodel(
            torch.from_numpy(phases), torch.from_numpy(feats),
            None if carries is None else tuple(map(torch.from_numpy,
                                                   carries)),
            None if invalid is None else torch.from_numpy(invalid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    for g, w in zip(got_carries, want_carries):
        assert g.shape == (b, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_first_pair_invalid_selects():
    """A non-finite step-0 micro embedding of a marked row must not reach
    the output: the mask selects, it does not multiply."""
    spec = tc.TemporalSpec(**SMALL_TEMPORAL)
    model = ttemporal.TwoStreamRNN(spec, 4, 16, 32).eval()
    phases = torch.zeros((2, 3, 4, 16, 16))
    phases[0, 0] = float("nan")
    with torch.no_grad():
        out, carries = model(phases, torch.zeros((2, 3, 32)),
                             ttemporal.init_carries(spec, 2),
                             torch.tensor([True, False]))
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(c).all() for c in carries)


def test_pair_count_mismatch_raises():
    model = ttemporal.TwoStreamRNN(tc.TemporalSpec(**SMALL_TEMPORAL), 4, 16,
                                   32).eval()
    with pytest.raises(ValueError, match="phase stacks"):
        model(torch.zeros((1, 2, 4, 16, 16)), torch.zeros((1, 5, 32)))


# -- predict_stream --------------------------------------------------------------

def test_predict_stream_matches_jax(case):
    """3 chunks of 4 frames, 2 videos: atol 1e-5 vs the JAX
    ``predict_stream`` with the same weights."""
    model, _state, videos, want = case
    outs, carries = [], None
    for start in range(0, 12, CHUNK):
        out, carries = model.predict_stream(videos[:, start:start + CHUNK],
                                            carries)
        assert out.shape == (2, CHUNK, 2)
        outs.append(out.numpy())
    (h_micro, h_macro), last = carries
    assert h_micro.shape == h_macro.shape == (2, 16)
    assert last.shape == (2, 1, S, S, 3)
    np.testing.assert_allclose(np.concatenate(outs, axis=1), want,
                               atol=1e-5, rtol=0)


def test_predict_stream_matches_predict_clips(case):
    """Chunked streaming equals the whole clip in one forward, atol 1e-5
    (the GRUs run the same steps, split at the chunk borders)."""
    model, _state, videos, _want = case
    whole = model.predict_clips(videos).numpy()
    for i in range(2):
        np.testing.assert_allclose(_stream(model, videos[i]), whole[i],
                                   atol=1e-5, rtol=0)


def test_predict_stream_single_frame_chunks(case):
    """Later chunks may be one frame long (one pair per slot)."""
    model, _state, videos, _want = case
    whole = model.predict_clips(videos[:1, :6]).numpy()[0]
    outs, carries = [], None
    for start, stop in ((0, 2), (2, 3), (3, 4), (4, 6)):
        out, carries = model.predict_stream(videos[:1, start:stop], carries)
        outs.append(out[0].numpy())
    np.testing.assert_allclose(np.concatenate(outs), whole, atol=1e-5,
                               rtol=0)


def test_predict_stream_rejects_bad_shapes(case):
    model = case[0]
    with pytest.raises(ValueError):
        model.predict_stream(np.zeros((1, 4, S + 2, S + 2, 3), np.uint8))
    with pytest.raises(ValueError):          # a first chunk needs a pair
        model.predict_stream(np.zeros((1, 1, S, S, 3), np.uint8))


# -- StreamingSession --------------------------------------------------------------

def test_session_matches_independent_streams(case):
    """Two slots fed together reproduce each video's own ``predict_stream``
    (atol 1e-5) and the JAX package's (atol 1e-5)."""
    model, _state, videos, want = case
    sess = StreamingSession(model, capacity=CAPACITY, chunk=CHUNK)
    slots = [sess.add_stream(), sess.add_stream()]
    assert sess.active_slots == slots and sess.free_slots == CAPACITY - 2
    got = {slot: [] for slot in slots}
    for start in range(0, 12, CHUNK):
        out = sess.feed({slot: videos[i, start:start + CHUNK]
                         for i, slot in enumerate(slots)})
        assert sorted(out) == slots
        for slot, o in out.items():
            assert o.shape == (CHUNK, 2)
            got[slot].append(o)
    for i, slot in enumerate(slots):
        series = np.concatenate(got[slot])
        np.testing.assert_allclose(series, _stream(model, videos[i]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(series, want[i], atol=1e-5, rtol=0)
    assert sess.feed({}) == {}


def test_session_staggered_add_remove(case):
    """A stream added mid-session gets fresh state; a removed stream's slot
    is reused with zeroed carries; a slot that is not fed keeps its state."""
    model, _state, videos, _want = case
    va, vb = videos[0], videos[1]
    sess = StreamingSession(model, capacity=2, chunk=CHUNK)
    a = sess.add_stream()
    out_a1 = sess.feed({a: va[:4]})[a]
    b = sess.add_stream()
    out_b1 = sess.feed({b: vb[:4]})[b]             # a is not fed: no move
    out = sess.feed({a: va[4:8], b: vb[4:8]})
    np.testing.assert_allclose(
        np.concatenate([out_a1, out[a]]), _stream(model, va[:8]),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        np.concatenate([out_b1, out[b]]), _stream(model, vb[:8]),
        atol=1e-5, rtol=0)
    sess.remove_stream(a)
    assert sess.active_slots == [b] and sess.free_slots == 1
    c = sess.add_stream()                          # reuses slot a
    assert c == a
    np.testing.assert_allclose(sess.feed({c: va[:4]})[c], out_a1,
                               atol=1e-5, rtol=0)


def test_session_uint8_equals_float(case):
    """A uint8 session gives the float session's outputs exactly on the
    same integral pixel values."""
    model, _state, videos, _want = case
    outs = {}
    for dt in (np.float32, np.uint8):
        sess = StreamingSession(model, capacity=2, chunk=CHUNK, dtype=dt)
        slot = sess.add_stream()
        outs[dt] = np.concatenate([
            sess.feed({slot: videos[0, :4].astype(dt)})[slot],
            sess.feed({slot: videos[0, 4:8].astype(dt)})[slot]])
    np.testing.assert_array_equal(outs[np.uint8], outs[np.float32])


def test_session_capacity_exhausted(case):
    sess = StreamingSession(case[0], capacity=1, chunk=CHUNK)
    sess.add_stream()
    with pytest.raises(RuntimeError, match="slots in use"):
        sess.add_stream()


@pytest.mark.parametrize("feed,match", [
    (lambda slot: {slot: _video(3, 0)}, "expected"),
    (lambda slot: {1: _video(4, 0)}, "not active"),
    (lambda slot: {7: _video(4, 0)}, "not active"),
    (lambda slot: {"0": _video(4, 0)}, "not active"),
])
def test_session_bad_feeds_rejected(case, feed, match):
    sess = StreamingSession(case[0], capacity=2, chunk=CHUNK)
    slot = sess.add_stream()
    with pytest.raises(ValueError, match=match):
        sess.feed(feed(slot))
    with pytest.raises(ValueError, match="not active"):
        sess.remove_stream(1)


@pytest.mark.parametrize("weighting", [False, True])
def test_fresh_slot_and_unfed_lanes_are_finite(case, weighting):
    """A fresh slot's pair 0 is a frame against itself (phase difference 0
    everywhere) and an unfed lane is all zeros (every band value 0, and with
    amplitude weighting a divisor of 0 + 1e-6): every lane of the forward
    stays finite, and so does the committed state."""
    model = Mimamo(_configs(weighting)[1], device="cpu")
    model.load_state_dict(case[1])
    sess = StreamingSession(model, capacity=CAPACITY, chunk=CHUNK)
    slot = sess.add_stream()
    x = np.zeros((CAPACITY, CHUNK + 1, S, S, 3), np.float32)
    x[slot, 1:] = _video(CHUNK, 3)
    x[slot, 0] = x[slot, 1]
    with torch.no_grad():
        stacks = model._micro_motion(
            torch.from_numpy(x).mean(dim=-1))
        out, carries = model(torch.from_numpy(x), include_first_pair=True,
                             first_pair_invalid=torch.tensor(
                                 [True] + [False] * (CAPACITY - 1)))
    assert torch.isfinite(stacks).all()
    assert not stacks[slot, 0].any() and not stacks[1:].any()
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(c).all() for c in carries)
    assert np.isfinite(sess.feed({slot: x[slot, 1:]})[slot]).all()
    assert all(torch.isfinite(c).all() for c in sess._gru)


# -- lane gathering ------------------------------------------------------------

def _state_of(sess, slot):
    """A slot's carries and pair context, as they are on the device."""
    return ([c.select(sess._slot_axis, slot).clone() for c in sess._gru]
            + [sess._context[slot].clone()])


def test_subset_feed_matches_streams_and_jax(case):
    """2 of 8 slots, not adjacent, fed 3 chunks while the other 6 hold
    state from a feed of their own: each fed slot equals its video's own
    ``predict_stream`` and the JAX session (atol 1e-5), and every unfed
    slot's carries and context are bit for bit what they were."""
    model, _state, videos, want = case
    sess = StreamingSession(model, capacity=8, chunk=CHUNK)
    slots = [sess.add_stream() for _ in range(8)]
    fed = (2, 5)
    rest = [s for s in slots if s not in fed]
    sess.feed({s: _video(CHUNK, 20 + s) for s in rest})
    before = {s: _state_of(sess, s) for s in rest}
    got = {s: [] for s in fed}
    for start in range(0, 12, CHUNK):
        out = sess.feed({s: videos[i, start:start + CHUNK]
                         for i, s in enumerate(fed)})
        assert sorted(out) == list(fed)
        for s in fed:
            got[s].append(out[s])
        for s in rest:
            assert all(torch.equal(a, b) for a, b in
                       zip(_state_of(sess, s), before[s])), s
    for i, s in enumerate(fed):
        series = np.concatenate(got[s])
        np.testing.assert_allclose(series, _stream(model, videos[i]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(series, want[i], atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_fed,lanes", [(1, 1), (3, 3), (5, 8), (8, 8)])
def test_lane_counters_read_the_buckets(case, n_fed, lanes):
    """At capacity 8 a feed of k slots runs the smallest lane count of
    1, 2, 3, 4, 8 that holds k (a CPU session runs every candidate, and
    every one gives the full capacity's bits there): the frame stages'
    batch, ``lanes_fed`` and ``lanes_run`` say so."""
    model = case[0]
    sess = StreamingSession(model, capacity=8, chunk=CHUNK, dtype=np.uint8)
    assert sess._lane_counts == sess._same_bits() == [1, 2, 3, 4, 8]
    slots = [sess.add_stream() for _ in range(8)]
    assert (sess.lanes_fed, sess.lanes_run) == (0, 0)
    seen = []
    hook = model.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].shape[0]))
    try:
        out = sess.feed({s: _video(CHUNK, s).astype(np.uint8)
                         for s in slots[::-1][:n_fed]})
    finally:
        hook.remove()
    assert len(out) == n_fed and seen == [lanes]
    assert (sess.lanes_fed, sess.lanes_run) == (n_fed, lanes)


def _twins(model, capacity, feeds):
    """Two sessions of ``capacity`` slots, all claimed, fed ``feeds``
    (slot -> seed of its chunk) in turn: the first with every other slot
    fed too, the second with those slots alone. Returns both sessions and
    their outputs, feed by feed."""
    rest = {s: 90 + s for s in range(capacity)}
    sessions, outs = [], []
    for chunks in ([{**rest, **f} for f in feeds], feeds):
        sess = StreamingSession(model, capacity=capacity, chunk=CHUNK)
        assert [sess.add_stream() for _ in range(capacity)] == list(
            range(capacity))
        outs.append([sess.feed({s: _video(CHUNK, seed)
                                for s, seed in c.items()}) for c in chunks])
        sessions.append(sess)
    return sessions, outs


def test_full_feed_and_gathered_bucket_agree(case):
    """Slots 0-7 of 16, fed two chunks, run gathered into a lane count of
    8; a twin session fed all 16 slots runs them at the full capacity.
    The eight slots' outputs are equal, and so are their carries and
    contexts."""
    model = case[0]
    feeds = [{s: 40 + 8 * k + s for s in range(8)} for k in range(2)]
    (full, gathered), (a, b) = _twins(model, 16, feeds)
    assert (gathered.lanes_fed, gathered.lanes_run) == (16, 16)
    assert (full.lanes_fed, full.lanes_run) == (32, 32)
    for x, y in zip(a, b):
        for s in range(8):
            np.testing.assert_array_equal(x[s], y[s])
    for s in range(8):
        assert all(torch.equal(x, y) for x, y in
                   zip(_state_of(full, s), _state_of(gathered, s)))


def test_lane_counts_skip_other_bits(case, monkeypatch):
    """A lane count whose frame stages give other bits than the full
    capacity's is not run where sessions check their bits (here the CPU,
    as a card's): with the embeddings of 2-row batches nudged, a session
    of 8 drops 2, feeds of 2 slots run 3 lanes, and those slots get the
    outputs of a feed of every slot bit for bit."""
    _, state, _, _ = case
    model = Mimamo(_configs()[1], device="cpu")
    model.load_state_dict(state)
    embed = model.embed_frames

    def nudged(crops):
        emb = embed(crops)
        return emb + 1e-3 if crops.shape[0] == 2 else emb

    monkeypatch.setattr(model, "embed_frames", nudged)
    monkeypatch.setattr(streaming, "checks_bits", lambda device: True)
    feeds = [{2: 60 + k, 5: 70 + k} for k in range(2)]
    (full, gathered), (a, b) = _twins(model, 8, feeds)
    assert gathered._lane_counts == [1, 3, 4, 8]
    assert (gathered.lanes_fed, gathered.lanes_run) == (4, 6)
    for x, y in zip(a, b):
        assert sorted(y) == [2, 5]
        for s in (2, 5):
            np.testing.assert_array_equal(x[s], y[s])

