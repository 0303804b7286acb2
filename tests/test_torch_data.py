"""The port's datasets and eval (``mimamo_tpu_torch.data.datasets``,
``data.eval``) vs ``mimamo_tpu.data``: the synthetic corpora, the
annotation reader and the batches are bit-equal for the same seeds; the
host CCCs agree to float64 rounding; ``evaluate_affwild2`` /
``evaluate_omg`` with the same weights (``weights.from_jax_variables``)
agree at atol 1e-5, at the small config of ``test_torch_runner``."""

import functools
import os

import jax
import numpy as np
import pytest

from mimamo_tpu.data import datasets as jds
from mimamo_tpu.data import eval as jeval
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import weights
from mimamo_tpu_torch.data import datasets as tds
from mimamo_tpu_torch.data import eval as teval
from mimamo_tpu_torch.runner import Mimamo
from mimamo_tpu_torch.streaming import StreamingSession

from test_torch_decode import (  # noqa: F401
    drop_if_passed, drop_passed_tmp_path)
from test_torch_runner import S, T, _configs


@pytest.fixture(scope="module")
def corpora(request, tmp_path_factory):
    """Aff-Wild2 and OMG corpora written by each package's generator (same
    seeds), with feature sidecars in the Aff-Wild2 ones (the directories go
    when the module passed)."""
    failed = request.session.testsfailed
    out, roots = {}, []
    for name, mod in (("jax", jds), ("port", tds)):
        root = tmp_path_factory.mktemp(name)
        roots.append(root)
        aff = str(root / "aff")
        mod.make_synthetic_affwild2(aff, n_videos=3, frames=11, size=S,
                                    seed=4)
        for v in range(3):
            n = len(np.load(os.path.join(aff, "crops", f"vid{v}.npy")))
            np.save(os.path.join(aff, "crops", f"vid{v}.feat.npy"),
                    np.random.default_rng(v).normal(size=(n, 8))
                    .astype(np.float32))
        omg = str(root / "omg")
        manifest = mod.make_synthetic_omg(omg, n_videos=2, n_utts=3,
                                          frames=7, size=S, seed=5)
        out[name] = (aff, omg, manifest)
    yield out
    for root in roots:
        drop_if_passed(root, failed, request.session.testsfailed)


def _datasets(mod, paths, clip):
    aff, omg, manifest = paths
    return (mod.AffWild2Dataset(aff, clip=clip),
            mod.OMGEmotionDataset(omg, manifest, clip))


def test_synthetic_corpora_are_identical(corpora):
    for i in range(3):
        for sub, name in (("crops", f"vid{i}.npy"),):
            a = np.load(os.path.join(corpora["jax"][0], sub, name))
            b = np.load(os.path.join(corpora["port"][0], sub, name))
            np.testing.assert_array_equal(a, b)
        with open(os.path.join(corpora["jax"][0], "annotations",
                               f"vid{i}.txt")) as f, \
                open(os.path.join(corpora["port"][0], "annotations",
                                  f"vid{i}.txt")) as g:
            assert f.read() == g.read()
    with open(corpora["jax"][2]) as f, open(corpora["port"][2]) as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("kw", [
    {},
    {"shuffle": True, "seed": 3},
    {"shuffle": True, "seed": 3, "drop_remainder": True},
    {"shuffle": True, "seed": 7, "stratify": True},
    {"shuffle": True, "seed": 1, "features": False},
    {"shuffle": True, "seed": 2, "process_id": 1, "process_count": 2},
    {"shuffle": True, "seed": 2, "process_id": 0, "process_count": 3,
     "stratify": True},
])
def test_batches_bit_equal(corpora, kw):
    """Every batch key, in order, for both dataset kinds (the port reads
    the JAX generator's files)."""
    _, tcfg = _configs("float32")
    clip = tcfg.clip
    from mimamo_tpu import config as jc
    jclip = jc.ClipSpec(clip_len=clip.clip_len, stride=clip.stride,
                        crop_size=clip.crop_size)
    for jd, td in zip(_datasets(jds, corpora["jax"], jclip),
                      _datasets(tds, corpora["jax"], clip)):
        assert len(jd) == len(td) > 0
        jb = list(jd.batches(2, **kw))
        tb = list(td.batches(2, **kw))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_process_slice_rejects_bad_id(corpora):
    _, tcfg = _configs("float32")
    aff = tds.AffWild2Dataset(corpora["port"][0], clip=tcfg.clip)
    with pytest.raises(ValueError, match="out of range"):
        next(aff.batches(2, process_id=2, process_count=2))


def test_annotation_reader(tmp_path):
    cases = {"header": "valence,arousal\n0.1,0.2\n-5,-5\n",
             "no_header": ".5,.3\n+0.2,0.1\n",
             "blank_lines": "\nvalence,arousal\n\n0.4,-0.4\n\n"}
    for name, text in cases.items():
        path = str(tmp_path / f"{name}.txt")
        with open(path, "w") as f:
            f.write(text)
        got = tds._read_affwild2_annotations(path)
        want = jds._read_affwild2_annotations(path)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_stale_feature_sidecar_raises(tmp_path):
    root = str(tmp_path / "aff")
    tds.make_synthetic_affwild2(root, n_videos=1, frames=6, size=S)
    np.save(os.path.join(root, "crops", "vid0.feat.npy"),
            np.zeros((5, 8), np.float32))
    with pytest.raises(ValueError, match="feature rows"):
        tds.AffWild2Dataset(root, clip=_configs("float32")[1].clip)


def test_ccc_np_and_moment_sums():
    rng = np.random.default_rng(6)
    p = rng.normal(size=(40, 2))
    y = 0.5 * p + rng.normal(size=(40, 2))
    np.testing.assert_array_equal(teval.ccc_np(p, y), jeval.ccc_np(p, y))
    sums = teval.ccc_moment_sums(p, y)
    np.testing.assert_array_equal(sums, jeval.ccc_moment_sums(p, y))
    parts = teval.ccc_moment_sums(p[:15], y[:15]) + teval.ccc_moment_sums(
        p[15:], y[15:])
    np.testing.assert_allclose(parts, sums, atol=1e-12, rtol=0)
    np.testing.assert_allclose(teval.ccc_from_moment_sums(parts),
                               teval.ccc_np(p, y), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(teval.ccc_from_moment_sums(sums),
                                  jeval.ccc_from_moment_sums(sums))
    np.testing.assert_array_equal(teval.ccc_moment_sums(p[:0], y[:0]),
                                  jeval.ccc_moment_sums(p[:0], y[:0]))


@pytest.fixture(scope="module")
def eval_case(corpora):
    jcfg, tcfg = _configs("float32")
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(functools.partial(
            JaxMimamo(jcfg).init_variables, clip_len=T))(
            jax.random.PRNGKey(3)))
    jaff, jomg = _datasets(jds, corpora["jax"], jcfg.clip)
    jm = JaxMimamo(jcfg)
    ref = {"aff": jeval.evaluate_affwild2(jm, variables, jaff, chunk=T,
                                          batch_streams=2),
           "omg": jeval.evaluate_omg(jm, variables, jomg, chunk=T,
                                     batch_streams=2)}
    model = Mimamo(tcfg, device="cpu")
    model.load_state_dict(weights.from_jax_variables(variables))
    return (model, _datasets(tds, corpora["jax"], tcfg.clip), ref,
            variables)


@pytest.mark.parametrize("kind", ["aff", "omg"])
def test_evaluate_matches_jax(eval_case, kind):
    """Frame-level (Aff-Wild2) and utterance-level (OMG) CCCs: atol 1e-5;
    the counts equal."""
    model, (aff, omg), ref, _ = eval_case
    got = (teval.evaluate_affwild2(model, aff, chunk=T) if kind == "aff"
           else teval.evaluate_omg(model, omg, chunk=T))
    want = ref[kind]
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5, k


def test_stream_predict_many_pads_and_keeps_order(eval_case):
    """Sequences of 0, 3 and 9 frames at chunk 4: they finish in this
    order, one row per frame, and each equals a ``StreamingSession`` fed
    the same chunks (the tail padded by its last frame) in the same slots
    and steps."""
    model = eval_case[0]
    rng = np.random.default_rng(8)
    seqs = {k: rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
            for k, n in (("a", 0), ("b", 3), ("c", 9))}
    out = list(teval.stream_predict_many(model, seqs.items(), chunk=T))
    assert [k for k, _ in out] == ["a", "b", "c"]
    assert [len(s) for _, s in out] == [0, 3, 9]

    def padded(x, start):
        piece = x[start:start + T]
        return np.concatenate([piece, np.repeat(
            piece[-1:], T - len(piece), axis=0)]).astype(np.float32)

    sess = StreamingSession(model, capacity=8, chunk=T)
    sb, sc = sess.add_stream(), sess.add_stream()
    first = sess.feed({sb: padded(seqs["b"], 0), sc: padded(seqs["c"], 0)})
    sess.remove_stream(sb)
    parts = [first[sc]] + [sess.feed({sc: padded(seqs["c"], s)})[sc]
                           for s in (4, 8)]
    np.testing.assert_array_equal(out[1][1], first[sb][:3])
    np.testing.assert_array_equal(out[2][1], np.concatenate(parts)[:9])


@pytest.mark.parametrize("batch_streams", [1, 2, 8])
def test_stream_predict_many_matches_jax(eval_case, batch_streams):
    """The batched ``stream_predict_many`` against the JAX one at the same
    ``batch_streams``: the same completion order (a long sequence first, so
    shorter ones overtake it when they share a step; zero-frame sources at
    once) and the series at atol 1e-5."""
    model = eval_case[0]
    variables = eval_case[3]
    rng = np.random.default_rng(9)
    lengths = (("long", 11), ("empty", 0), ("short", 3), ("mid", 6),
               ("one", 1))
    seqs = [(k, rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8))
            for k, n in lengths]
    jm = JaxMimamo(_configs("float32")[0])
    want = list(jeval.stream_predict_many(jm, variables, seqs, chunk=T,
                                          batch_streams=batch_streams))
    got = list(teval.stream_predict_many(model, seqs, chunk=T,
                                         batch_streams=batch_streams))
    assert [k for k, _ in got] == [k for k, _ in want]
    if batch_streams > 1:
        assert [k for k, _ in got][:2] != ["long", "empty"]
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_evaluate_rejects_an_empty_corpus(tmp_path, eval_case):
    root = str(tmp_path / "empty")
    os.makedirs(os.path.join(root, "crops"))
    os.makedirs(os.path.join(root, "annotations"))
    with pytest.raises(ValueError, match="zero sequences"):
        teval.evaluate_affwild2(eval_case[0], tds.AffWild2Dataset(root))
