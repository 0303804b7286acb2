"""Port checkpoints (``mimamo_tpu_torch.checkpoints``) vs
``mimamo_tpu.checkpoints``: the training state round-trips exactly
(weights, BN stats, Adam moments, step, rate); ``.pth`` files written with
``torch.save`` read to the same arrays and meta as the JAX readers; the
backbone meta sidecar is the same file; ``load_temporal_state_dict`` maps
what the JAX mapping maps; ``MimamoAPI(checkpoint_dir=...)`` equals the JAX
API built from the same variables (atol 1e-5), at the small config of
``test_torch_runner``."""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from mimamo_tpu import api as japi
from mimamo_tpu import checkpoints as jck
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import api, checkpoints, train, weights
from mimamo_tpu_torch import config as tc
from mimamo_tpu_torch.runner import Mimamo

from test_torch_decode import drop_passed_tmp_path  # noqa: F401
from test_torch_runner import S, T, _configs


@pytest.fixture(scope="module")
def variables():
    jcfg, _ = _configs("float32")
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(functools.partial(
            JaxMimamo(jcfg).init_variables, clip_len=T))(
            jax.random.PRNGKey(4)))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"clips": rng.integers(0, 256, (1, T, S, S, 3)).astype(np.float32),
            "labels": np.tanh(rng.normal(size=(1, T, 2))).astype(np.float32),
            "mask": np.ones((1, T), np.float32)}


def _state(variables, **train_kw):
    _, tcfg = _configs("float32")
    cfg = dataclasses.replace(tcfg, train=tc.TrainSpec(
        learning_rate=1e-3, lr_schedule="cosine", warmup_steps=2, **train_kw))
    model = Mimamo(cfg, device="cpu")
    model.load_state_dict(weights.from_jax_variables(variables))
    return train.create_train_state(model, total_steps=10)


@pytest.mark.parametrize("finetune", [False, True])
def test_save_restore_roundtrip(variables, tmp_path, finetune):
    """Two steps, save, restore into a fresh state: weights, BN stats,
    optimizer moments, step and rate equal; one more step from each gives
    the same weights."""
    kw = {"freeze_backbone": False, "remat_backbone": False} if finetune \
        else {}
    a = _state(variables, **kw)
    step_a = train.make_train_step(a.model)
    for i in range(2):
        step_a(a, _batch(i))
    path = checkpoints.save(str(tmp_path / "ck"), a)
    assert path == os.path.join(str(tmp_path / "ck"), "2")
    b = _state(variables, **kw)
    checkpoints.restore(str(tmp_path / "ck"), b)
    assert b.step == 2 and b.model._folded is None
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb["state"][i][k])), (i, k)
    assert a.optimizer.param_groups[0]["lr"] == \
        b.optimizer.param_groups[0]["lr"] == \
        train.lr_schedule(a.model.config.train, 10)(2)
    step_b = train.make_train_step(b.model)
    step_a(a, _batch(5))
    step_b(b, _batch(5))
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k


def test_latest_step(variables, tmp_path):
    path = str(tmp_path / "ck")
    assert checkpoints.latest_step(path) is None
    assert checkpoints.latest_step(None) is None
    state = _state(variables)
    for step in (3, 12, 7):
        checkpoints.save(path, state, step=step)
    os.makedirs(os.path.join(path, "99"))              # no state file
    os.makedirs(os.path.join(path, "notes"))
    assert checkpoints.latest_step(path) == 12
    assert checkpoints.load(path)["step"] == 12
    assert checkpoints.load(path, step=3)["step"] == 3
    assert sorted(os.listdir(path)) == ["12", "3", "7", "99", "notes"]
    with pytest.raises(FileNotFoundError):
        checkpoints.load(str(tmp_path / "none"))


def test_pth_readers_match_jax(tmp_path):
    """A bare ``state_dict``, one under ``state_dict`` / ``model`` with a
    MatConvNet-style ``meta``, and one without meta."""
    rng = np.random.default_rng(1)
    sd = {"conv1.weight": torch.from_numpy(rng.normal(size=(4, 3, 7, 7))
                                           .astype(np.float32)),
          "bn1.running_var": torch.rand(4),
          "bn1.num_batches_tracked": torch.tensor(3)}
    meta = {"mean": [131.0, 103.0, 91.0], "std": [1.0, 1.0, 1.0],
            "imageSize": [224, 224, 3], "imageOrder": "BGR"}
    cases = {"bare": sd, "nested": {"state_dict": sd, "meta": meta},
             "model": {"model": sd, "meta": {"mean": [1.0, 2.0]}}}
    for name, obj in cases.items():
        path = str(tmp_path / f"{name}.pth")
        torch.save(obj, path)
        got, want = checkpoints.load_pth(path), jck.load_pth(path)
        assert got.keys() == want.keys() == sd.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert checkpoints.load_pth_meta(path) == jck.load_pth_meta(path)
        (g_sd, g_meta), (w_sd, w_meta) = (checkpoints.load_pth_all(path),
                                          jck.load_pth_all(path))
        assert g_meta == w_meta and g_sd.keys() == w_sd.keys()
    assert checkpoints.load_pth_meta(str(tmp_path / "nested.pth")) == {
        "mean": [131.0, 103.0, 91.0], "std": [1.0, 1.0, 1.0],
        "image_size": 224, "channel_order": "bgr"}


def test_backbone_meta_matches_jax(tmp_path):
    d = str(tmp_path / "ck")
    assert checkpoints.load_backbone_meta(d) is None
    checkpoints.save_backbone_meta(d, (1.5, 2.5, 3.5), "bgr")
    assert checkpoints.load_backbone_meta(d) == jck.load_backbone_meta(d) \
        == {"mean_rgb": [1.5, 2.5, 3.5], "channel_order": "bgr"}
    jcfg, tcfg = _configs("float32")
    got = checkpoints.apply_backbone_meta(tcfg, d).backbone
    want = jck.apply_backbone_meta(jcfg, d).backbone
    assert got.mean_rgb == want.mean_rgb == (1.5, 2.5, 3.5)
    assert got.channel_order == want.channel_order == "bgr"
    assert checkpoints.apply_backbone_meta(tcfg, None) is tcfg
    assert checkpoints.apply_backbone_meta(tcfg, str(tmp_path / "no")) is tcfg


def _canonical_temporal(variables):
    return {k: v.numpy() for k, v in
            weights.temporal_from_jax(variables["temporal"]).items()}


def test_load_temporal_state_dict_matches_jax(variables):
    """A prefixed reference ``state_dict``: the JAX mapping, converted back
    to torch names, equals the port's; the result loads into the model."""
    _, tcfg = _configs("float32")
    sd = {"net." + k: v for k, v in _canonical_temporal(variables).items()}
    pm = {"net.": ""}
    jtree = jck.load_temporal_state_dict(
        sd, prefix_map=pm, spec=tcfg.temporal, phase_size=tcfg.phase.phase_size)
    jtree = jax.tree_util.tree_map(np.asarray, jtree)
    want = weights.temporal_from_jax(jtree)
    got = checkpoints.load_temporal_state_dict(
        sd, prefix_map=pm, spec=tcfg.temporal,
        phase_size=tcfg.phase.phase_size)
    assert set(got) == {k for k in want if "num_batches" not in k}
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k].numpy())
    model = Mimamo(tcfg, device="cpu")
    missing, unexpected = model.temporal.load_state_dict(got, strict=False)
    assert not unexpected and all("num_batches" in k for k in missing)


def test_load_temporal_state_dict_rejects_what_jax_rejects(variables):
    _, tcfg = _configs("float32")
    sd = _canonical_temporal(variables)
    for extra in ("foreign.weight", "micro_cnn.conv1.bias"):
        bad = dict(sd, **{extra: np.zeros(3, np.float32)})
        with pytest.raises(KeyError, match="unmapped"):
            jck.load_temporal_state_dict(bad, spec=tcfg.temporal,
                                         phase_size=tcfg.phase.phase_size)
        with pytest.raises(KeyError, match="unmapped"):
            checkpoints.load_temporal_state_dict(bad)
        assert extra not in checkpoints.load_temporal_state_dict(
            bad, strict=False)
    bad = dict(sd, **{"micro_cnn.fc.weight": np.zeros((256, 7), np.float32)})
    with pytest.raises(ValueError, match="in-dim"):
        checkpoints.load_temporal_state_dict(
            bad, spec=tcfg.temporal, phase_size=tcfg.phase.phase_size)
    h, w, c = checkpoints.micro_fc_input_shape(tcfg.temporal,
                                               tcfg.phase.phase_size)
    assert (h, w, c) == jck.micro_fc_input_shape(tcfg.temporal,
                                                 tcfg.phase.phase_size)


def test_checkpoint_dir_api_matches_jax_api(variables, tmp_path):
    """A port checkpoint with a bgr / custom-mean backbone meta:
    ``MimamoAPI(checkpoint_dir=...)`` holds the saved weights and the
    meta's preprocessing, and predicts as the JAX API built from the same
    variables and meta (atol 1e-5)."""
    jcfg, tcfg = _configs("float32")
    ck = str(tmp_path / "ck")
    state = _state(variables)
    checkpoints.save(ck, state)
    checkpoints.save_backbone_meta(ck, (120.0, 110.0, 100.0), "bgr")
    a = api.MimamoAPI(config=tcfg, device="cpu", checkpoint_dir=ck)
    assert a.model.config.backbone.channel_order == "bgr"
    assert a.model.config.backbone.mean_rgb == (120.0, 110.0, 100.0)
    for k, v in state.model.state_dict().items():
        assert torch.equal(a.model.state_dict()[k], v), k
    crops = np.random.default_rng(2).integers(0, 256, (9, S, S, 3),
                                              dtype=np.uint8)
    path = str(tmp_path / "crops.npy")
    np.save(path, crops)
    ja = japi.MimamoAPI(config=jcfg, variables=variables, checkpoint_dir=ck)
    np.testing.assert_allclose(a.predict_crops(path), ja.predict_crops(path),
                               atol=1e-5, rtol=0)
