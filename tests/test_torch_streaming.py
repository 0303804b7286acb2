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
from mimamo_tpu_torch import weights
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
