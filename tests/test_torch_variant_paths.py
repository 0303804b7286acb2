"""The model variants through the port's other entry points, against the
JAX package: ``StreamingSession`` chunk by chunk (``gru_layers=2``,
``streams="micro"``, ``appearance_stride=2``; atol 1e-5),
``FeatureExtractor.extract`` at stride 2 (one anchor plan over the whole
video), one frozen train step (``micro``, ``macro``, ``gru_layers=2``:
the loss and the temporal gradients, at the gates of
tests/test_torch_train.py) and ``cli convert --streams micro`` (the macro
tensors pruned, ``--verify`` through the micro-only reference forward).
The configs and weights are those of tests/test_torch_variants.py."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mimamo_tpu import api as japi
from mimamo_tpu import config as jc
from mimamo_tpu import streaming as jstreaming
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import api, checkpoints, cli, train
from mimamo_tpu_torch import config as tc
from mimamo_tpu_torch.streaming import StreamingSession
from mimamo_tpu_torch.temporal import TwoStreamRNN

from test_torch_convert import _save, _shapes, _values
from test_torch_decode import drop_passed_tmp_path  # noqa: F401
from test_torch_train import _grads, _jax_grads, _jax_steps
from test_torch_variants import S, T, configs, jax_variables, port

CHUNK, CAPACITY, FRAMES = 4, 2, 12
STREAM_VARIANTS = {"gru2": ({"gru_layers": 2}, {}),
                   "micro": ({"streams": "micro"}, {}),
                   "stride2": ({}, {"appearance_stride": 2})}


@pytest.fixture(scope="module", params=list(STREAM_VARIANTS))
def stream_case(request):
    """Two videos fed to the JAX ``StreamingSession`` chunk by chunk, the
    second slot joining one chunk late."""
    jcfg, tcfg = configs(*STREAM_VARIANTS[request.param])
    variables = jax_variables(jcfg)
    videos = np.random.default_rng(4).integers(
        0, 256, (2, FRAMES, S, S, 3), dtype=np.uint8)
    sess = jstreaming.StreamingSession(JaxMimamo(jcfg), variables,
                                       capacity=CAPACITY, chunk=CHUNK)
    want = _feed_all(sess, videos)
    return request.param, port(tcfg, variables), videos, want


def _feed_all(sess, videos):
    """Slot a from the first chunk, slot b from the second: the outputs
    of every feed."""
    a = sess.add_stream()
    outs = [sess.feed({a: videos[0, :CHUNK]})]
    b = sess.add_stream()
    for start in range(CHUNK, FRAMES, CHUNK):
        outs.append(sess.feed({a: videos[0, start:start + CHUNK],
                               b: videos[1, start - CHUNK:start]}))
    return [{k: np.asarray(v) for k, v in o.items()} for o in outs]


def test_session_variants_match_jax(stream_case):
    """Every chunk of both slots against the JAX session, atol 1e-5. At
    stride 2 each chunk is anchored after its context frame, as the JAX
    session anchors it; stacked GRUs keep their slots on axis 1 of
    [L, capacity, H] carries."""
    name, model, videos, want = stream_case
    sess = StreamingSession(model, capacity=CAPACITY, chunk=CHUNK)
    got = _feed_all(sess, videos)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for slot in g:
            np.testing.assert_allclose(g[slot], w[slot], atol=1e-5, rtol=0,
                                       err_msg=name)
    layers = model.config.temporal.gru_layers
    shape = ((CAPACITY, 16) if layers == 1 else (layers, CAPACITY, 16))
    assert all(tuple(c.shape) == shape for c in sess._gru)
    # a removed and re-added slot starts from zero carries
    sess.remove_stream(0)
    assert sess.add_stream() == 0
    assert all(not c.select(sess._slot_axis, 0).any() for c in sess._gru)


def test_feature_extractor_stride_uses_global_anchor_plan(tmp_path):
    """``extract`` at stride 2 over 10 frames in batches of 4 anchors
    against the JAX ``FeatureExtractor`` (the fp32 backbone gate: atol
    2e-4, rtol 1e-3) and, bit for bit up to batching, against
    ``embed_frames`` of the whole video."""
    backbone = {"appearance_stride": 2}
    jcfg, tcfg = configs(backbone=backbone)
    variables = jax_variables(jcfg)
    crops = np.random.default_rng(5).integers(0, 256, (10, S, S, 3),
                                              dtype=np.uint8)
    path = str(tmp_path / "crops.npy")
    np.save(path, crops)
    want = np.load(japi.FeatureExtractor(config=jcfg, variables=variables,
                                         batch_size=4).extract(
        path, str(tmp_path / "jax.npy")))
    fx = api.FeatureExtractor(config=tcfg, state_dict=port(
        tcfg, variables).state_dict(), batch_size=4, device="cpu")
    got = np.load(fx.extract(path))
    assert got.shape == (10, 2048)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    with torch.no_grad():
        whole = fx.model.embed_frames(torch.from_numpy(crops)[None].float())
    np.testing.assert_allclose(got, whole[0].numpy(), atol=1e-5, rtol=1e-6)


TRAIN_VARIANTS = {"micro": {"streams": "micro"},
                  "macro": {"streams": "macro"},
                  "gru2": {"gru_layers": 2}}


@pytest.mark.parametrize("name", list(TRAIN_VARIANTS))
def test_frozen_train_step_variants_match_jax(name):
    """One frozen step of each variant against the JAX train step: the loss
    atol 1e-5, each temporal gradient max |d| <= 1e-4 of its max |g|
    (tests/test_torch_train.py's first-step gates); only the active
    streams' parameters get gradients."""
    lr = 1e-4
    jcfg, tcfg = configs(TRAIN_VARIANTS[name])
    jcfg = dataclasses.replace(jcfg, train=jc.TrainSpec(learning_rate=lr))
    tcfg = dataclasses.replace(tcfg, train=tc.TrainSpec(learning_rate=lr))
    variables = jax_variables(jcfg)
    rng = np.random.default_rng(6)
    batch = {"clips": rng.integers(0, 256, (2, T, S, S, 3)).astype(
        np.float32),
             "labels": np.tanh(rng.normal(size=(2, T, 2))).astype(
                 np.float32),
             "mask": np.ones((2, T), np.float32)}
    (want,) = _jax_steps(jcfg, variables, batch, 1)
    model = port(tcfg, variables)
    state = train.create_train_state(model)
    _state, metrics = train.make_train_step(model)(state, batch)
    assert abs(float(metrics["loss"]) - want["metrics"]["loss"]) <= 1e-5
    jg, pg = _jax_grads(want, "temporal"), _grads(model, "temporal.")
    assert set(pg) == set(jg)
    for k, g in jg.items():
        assert float((pg[k] - g).abs().max()) <= 1e-4 * float(
            g.abs().max()), k
    spec = tcfg.temporal
    assert any("gru_macro" in k for k in pg) == spec.use_macro
    assert any("micro_cnn" in k for k in pg) == spec.use_micro


def test_convert_micro_prunes_macro_tensors(tmp_path, capsys):
    """A full two-stream ``.pth`` (fusion sized for one stream) converted
    with ``--streams micro``: the 4 ``gru_macro`` and 2 ``macro_proj``
    tensors are dropped and counted, the checkpoint holds none of them,
    and ``--verify`` holds the micro-only reference forward against the
    converted model (tests/test_train.py)."""
    spec = tc.TemporalSpec()              # the widths the CLI builds
    shapes = _shapes(lambda: TwoStreamRNN(spec, 4, 8, 2048))
    shapes["fusion.weight"] = (spec.fusion_hidden, spec.gru_hidden)
    sd = _values(shapes, 7)
    pth = _save(tmp_path / "full.pth", sd)
    ckpt = str(tmp_path / "ck")
    flags = ["--crop-size", str(S), "--backbone-size", str(2 * S),
             "--pyramid-height", "2", "--orientations", "2",
             "--phase-size", "8", "--clip-len", str(T), "--stride", "4",
             "--cpu"]
    rc = cli.main(["convert", "--temporal-pth", pth, "--out", ckpt,
                   "--streams", "micro", "--verify"] + flags)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["temporal_dropped_for_config"] == 6
    assert report["verify"]["temporal_outputs"]["rel"] <= 1e-5
    model = checkpoints.load(ckpt)["model"]
    assert not any("macro" in k for k in model)
    np.testing.assert_array_equal(
        model["temporal.gru_micro.weight_ih_l0"].numpy(),
        sd["gru_micro.weight_ih_l0"])
