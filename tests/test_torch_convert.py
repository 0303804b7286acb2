"""The port's importer of the reference's ``.pth`` weights
(``backbone.load_torch_state_dict`` and the ``dag`` names,
``checkpoints.load_temporal_state_dict`` / ``merge_temporal``,
``torch_ref``, ``cli convert``) against the JAX package's, the cases of
tests/test_train.py's convert classes and tests/test_backbone.py's
importer classes.

The sources are seeded synthetic ``state_dict``s made with numpy: a
ResNet-50 under the FER+ MatConvNet ``dag`` names (with the 1x1-conv
classifier and BN counters of the real asset) and a two-stream model
under a ``model.`` prefix. Bit for bit: the port's import against the JAX
import followed by ``weights.backbone_from_jax`` / ``temporal_from_jax``.
End to end, at the small config of tests/test_torch_serve.py: the port's
``cli convert`` then ``cli predict --crops --ckpt --cpu`` against the JAX
``predict_clips`` under the JAX-converted variables (atol 1e-4), the
embeddings at the fp32 backbone gate of tests/test_backbone.py (atol
2e-4, rtol 1e-3)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mimamo_tpu import backbone as jbackbone
from mimamo_tpu import checkpoints as jcheckpoints
from mimamo_tpu import torch_ref as jtorch_ref
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import backbone, checkpoints, cli, torch_ref, weights
from mimamo_tpu_torch.backbone import ResNet50
from mimamo_tpu_torch.config import BackboneSpec
from mimamo_tpu_torch.runner import Mimamo
from mimamo_tpu_torch.temporal import TwoStreamRNN

from test_torch_serve import CLIP, S, SMALL_FLAGS, small_configs

OUT_ATOL = 1e-4
EMB_ATOL, EMB_RTOL = 2e-4, 1e-3
FLAGS = SMALL_FLAGS + ["--cpu"]
MEAN = [120.5, 100.25, 90.125]
PREFIX_MAP = {"model.": ""}


def _shapes(module: torch.nn.Module) -> dict:
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in module().state_dict().items()}


def _values(shapes: dict, seed: int) -> dict:
    """Seeded float32 tensors for a ``state_dict``'s shapes: conv and
    linear weights at 1 / sqrt(fan_in), BN affine and stats near identity,
    counters 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            out[k] = np.zeros((), np.int64)
        elif k.endswith("running_var"):
            out[k] = (0.5 + rng.random(shape)).astype(np.float32)
        elif len(shape) == 1:
            bn_scale = k.endswith(".weight") and \
                k[:-len("weight")] + "running_var" in shapes
            out[k] = (float(bn_scale) + 0.1 * rng.standard_normal(shape)
                      ).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            out[k] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
    return out


def _dag(canonical: dict) -> dict:
    """Canonical ResNet-50 names -> the FER+ ``dag`` names, with the
    classifier as a 1x1 conv and the BN counters named after their dag
    module, as ``resnet50_ferplus_dag.pth`` holds them."""
    inv = {v: k for k, v in backbone.ferplus_dag_rename().items()}
    out = {}
    for k, v in canonical.items():
        if k.endswith("num_batches_tracked"):
            mod = inv[k.replace("num_batches_tracked", "running_mean")]
            out[mod.replace("running_mean", "num_batches_tracked")] = v
        elif k == "fc.weight":
            out[inv[k]] = v.reshape(v.shape + (1, 1))
        else:
            out[inv[k]] = v
    return out


def _save(path, sd: dict, meta=None) -> str:
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    torch.save(tensors if meta is None else {"state_dict": tensors,
                                             "meta": meta}, path)
    return str(path)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """The configs, the two source ``state_dict``s as numpy, their ``.pth``
    files (the backbone also with bgr / mean meta), a [1, CLIP] uint8 crop
    clip as ``.npy``, and one port ``convert`` of both files."""
    jcfg, tcfg = small_configs()
    root = tmp_path_factory.mktemp("convert")
    bb = _dag(_values(_shapes(lambda: ResNet50(BackboneSpec())), 11))
    tm = {f"model.{k}": v for k, v in _values(_shapes(
        lambda: TwoStreamRNN(tcfg.temporal, tcfg.num_phase,
                             tcfg.phase.phase_size,
                             tcfg.backbone.feature_dim)), 12).items()}
    prefix_map = str(root / "prefix.json")
    with open(prefix_map, "w") as f:
        json.dump(PREFIX_MAP, f)
    crops = np.random.default_rng(13).integers(
        0, 256, (CLIP, S, S, 3), dtype=np.uint8)
    np.save(root / "crops.npy", crops)
    case = {"jcfg": jcfg, "tcfg": tcfg, "root": root, "bb": bb, "tm": tm,
            "bb_pth": _save(root / "resnet50_ferplus_dag.pth", bb),
            "bb_meta_pth": _save(
                root / "meta.pth", bb,
                {"mean": MEAN, "std": [1.0, 1.0, 1.0],
                 "imageSize": [2 * S, 2 * S, 3], "imageOrder": "bgr"}),
            "tm_pth": _save(root / "two_stream.pth", tm),
            "prefix_map": prefix_map, "crops": str(root / "crops.npy"),
            "clip": crops[None]}
    case["ckpt"] = str(root / "ckpt")
    assert cli.main(["convert", "--backbone-pth", case["bb_pth"],
                     "--temporal-pth", case["tm_pth"],
                     "--temporal-prefix-map", prefix_map,
                     "--out", case["ckpt"]] + FLAGS) == 0
    return case


@pytest.fixture(scope="module")
def jax_variables(src):
    """The JAX package's conversion of the same files over its initialized
    variables, as ``mimamo_tpu.cli convert`` merges them."""
    jcfg = src["jcfg"]
    model = JaxMimamo(jcfg)
    variables = dict(model.init_variables(jax.random.PRNGKey(0),
                                          clip_len=CLIP))
    variables["backbone"] = jbackbone.load_torch_state_dict(
        jbackbone.normalize_dag_state_dict(src["bb"]))
    overlay = jcheckpoints.load_temporal_state_dict(
        src["tm"], prefix_map=PREFIX_MAP, spec=jcfg.temporal,
        phase_size=jcfg.phase.phase_size)
    variables["temporal"] = jcheckpoints.merge_variables(
        variables["temporal"], overlay)
    return model, jax.tree_util.tree_map(np.asarray, variables)


def test_backbone_import_matches_jax_bit_for_bit(src):
    """The port's ``load_torch_state_dict(normalize_dag_state_dict(sd))``
    equals the JAX importer followed by ``weights.backbone_from_jax``,
    every tensor bit for bit, the same keys."""
    sd = src["bb"]
    want = weights.backbone_from_jax(jax.tree_util.tree_map(
        np.asarray, jbackbone.load_torch_state_dict(
            jbackbone.normalize_dag_state_dict(sd))))
    got = backbone.load_torch_state_dict(backbone.normalize_dag_state_dict(sd))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_temporal_import_matches_jax_bit_for_bit(src):
    """A prefixed two-stream ``state_dict`` through the port's
    ``load_temporal_state_dict`` equals the JAX one followed by
    ``weights.temporal_from_jax`` (its BN counters aside), bit for bit."""
    jcfg, tcfg = src["jcfg"], src["tcfg"]
    jvars = jax.tree_util.tree_map(
        np.asarray, jcheckpoints.load_temporal_state_dict(
            src["tm"], prefix_map=PREFIX_MAP, spec=jcfg.temporal,
            phase_size=jcfg.phase.phase_size))
    want = {k: v for k, v in weights.temporal_from_jax(jvars).items()
            if not k.endswith("num_batches_tracked")}
    got = checkpoints.load_temporal_state_dict(
        src["tm"], prefix_map=PREFIX_MAP, spec=tcfg.temporal,
        phase_size=tcfg.phase.phase_size)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_rename_covers_the_port_schema_exactly():
    m = backbone.ferplus_dag_rename()
    assert m == jbackbone.ferplus_dag_rename()
    assert sorted(m.values()) == sorted(backbone.canonical_keys())
    assert len(set(m.values())) == len(m) == 267


def test_explicit_rename_wins_over_dag_detection(src):
    sd = dict(src["bb"])
    rename = {"conv1_7x7_s2.weight": "conv1.weight"}
    got, how = backbone.resolve_torch_names(sd, rename)
    want, jhow = jbackbone.resolve_torch_names(sd, rename)
    assert how == jhow == "rename" and sorted(got) == sorted(want)
    assert backbone.resolve_torch_names(sd)[1] == "dag"
    canonical = backbone.normalize_dag_state_dict(sd)
    assert backbone.resolve_torch_names(canonical)[1] == "as-is"


def _predict_csv(tmp_path, capsys, ckpt, crops):
    out = str(tmp_path / "p.csv")
    capsys.readouterr()
    assert cli.main(["predict", "--crops", crops, "--ckpt", ckpt,
                     "--out", out] + FLAGS) == 0
    capsys.readouterr()
    return np.loadtxt(out, delimiter=",", skiprows=1, ndmin=2)


def test_convert_then_predict_matches_jax(src, jax_variables, capsys,
                                          tmp_path):
    """``cli convert`` of both files, then ``cli predict --crops --ckpt
    --cpu``: the series equals the JAX ``predict_clips`` under the JAX
    package's conversion of the same files."""
    model, variables = jax_variables
    want = np.asarray(model.predict_clips(variables, src["clip"]))[0]
    got = _predict_csv(tmp_path, capsys, src["ckpt"], src["crops"])
    assert got.shape[0] == CLIP
    np.testing.assert_allclose(got[:, -2:], want, atol=OUT_ATOL)


def test_converted_embeddings_match_jax(src, jax_variables):
    """The converted checkpoint's pool5 embeddings against the JAX
    package's under its conversion, at the fp32 backbone gate."""
    model, variables = jax_variables
    want = np.asarray(model.embed_frames(
        variables, src["clip"].astype(np.float32)))
    port = Mimamo(src["tcfg"], device="cpu")
    port.load_state_dict(checkpoints.load(src["ckpt"])["model"])
    with torch.no_grad():
        got = port.embed_frames(torch.from_numpy(src["clip"]).float())
    np.testing.assert_allclose(got.numpy(), want, atol=EMB_ATOL,
                               rtol=EMB_RTOL)


def test_convert_reports_and_restores_the_sources(src, capsys, tmp_path):
    """The JSON line counts the tensors, and the checkpoint holds the
    source tensors where the port's schema puts them."""
    ckpt = str(tmp_path / "ck")
    assert cli.main(["convert", "--backbone-pth", src["bb_pth"],
                     "--temporal-pth", src["tm_pth"],
                     "--temporal-prefix-map", src["prefix_map"],
                     "--out", ckpt] + FLAGS) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["backbone_dag_rename"] == "auto"
    assert row["backbone_tensors"] == 267
    assert row["temporal_tensors"] == sum(
        not k.endswith("num_batches_tracked") for k in src["tm"])
    model = checkpoints.load(ckpt)["model"]
    np.testing.assert_array_equal(model["backbone.conv1.weight"].numpy(),
                                  src["bb"]["conv1_7x7_s2.weight"])
    np.testing.assert_array_equal(
        model["backbone.fc.weight"].numpy(),
        src["bb"]["classifier.weight"][:, :, 0, 0])
    np.testing.assert_array_equal(
        model["temporal.gru_micro.weight_hh_l0"].numpy(),
        src["tm"]["model.gru_micro.weight_hh_l0"])


def test_meta_pth_writes_backbone_meta_and_predict_uses_it(
        src, jax_variables, capsys, tmp_path):
    """A backbone ``.pth`` with bgr / mean meta: ``convert`` folds it into
    the config and writes ``backbone_meta.json``; ``predict --ckpt``
    preprocesses with it, as the JAX package does under the same meta."""
    import dataclasses
    ckpt = str(tmp_path / "ck_meta")
    assert cli.main(["convert", "--backbone-pth", src["bb_meta_pth"],
                     "--temporal-pth", src["tm_pth"],
                     "--temporal-prefix-map", src["prefix_map"],
                     "--out", ckpt] + FLAGS) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["backbone_meta"] == {"mean_rgb": MEAN,
                                    "channel_order": "bgr"}
    assert checkpoints.load_backbone_meta(ckpt) == row["backbone_meta"]
    model, variables = jax_variables
    jcfg = src["jcfg"]
    bgr = JaxMimamo(dataclasses.replace(jcfg, backbone=dataclasses.replace(
        jcfg.backbone, mean_rgb=tuple(MEAN), channel_order="bgr")))
    want = np.asarray(bgr.predict_clips(variables, src["clip"]))[0]
    rgb = np.asarray(model.predict_clips(variables, src["clip"]))[0]
    got = _predict_csv(tmp_path, capsys, ckpt, src["crops"])
    np.testing.assert_allclose(got[:, -2:], want, atol=OUT_ATOL)
    assert np.abs(want - rgb).max() > 10 * OUT_ATOL


def test_verify_passes_and_reports(src, capsys, tmp_path):
    ckpt = str(tmp_path / "ck_v")
    assert cli.main(["convert", "--backbone-pth", src["bb_pth"],
                     "--temporal-pth", src["tm_pth"],
                     "--temporal-prefix-map", src["prefix_map"],
                     "--out", ckpt, "--verify"] + FLAGS) == 0
    err = capsys.readouterr().err
    v = json.loads([ln for ln in err.splitlines()
                    if ln.startswith('{"verify"')][-1])["verify"]
    assert sorted(v) == ["backbone_embeddings", "backbone_logits",
                         "temporal_outputs"]
    for name, row in v.items():
        assert row["rel"] < 1e-5 and row["scale"] > 0, (name, row)
    assert os.path.isdir(ckpt)


def _corrupt_backbone(monkeypatch):
    real = backbone.load_torch_state_dict

    def corrupted(sd, rename=None, strict=True):
        out = real(sd, rename=rename, strict=strict)
        out["conv1.weight"] = -out["conv1.weight"]
        return out
    monkeypatch.setattr(backbone, "load_torch_state_dict", corrupted)


def _corrupt_temporal(monkeypatch):
    real = checkpoints.load_temporal_state_dict

    def corrupted(*args, **kwargs):
        out = real(*args, **kwargs)
        out["head.weight"] = out["head.weight"].flip(0)
        return out
    monkeypatch.setattr(checkpoints, "load_temporal_state_dict", corrupted)


@pytest.mark.parametrize("corrupt", [_corrupt_backbone, _corrupt_temporal],
                         ids=["backbone", "temporal"])
def test_verify_fails_on_a_corrupted_tensor_and_writes_nothing(
        src, monkeypatch, tmp_path, corrupt):
    """A conversion that gets one tensor wrong (same shape: conv1 negated,
    the head's output rows swapped) trips ``--verify`` before anything is
    written."""
    corrupt(monkeypatch)
    ckpt = str(tmp_path / "ck_bad")
    with pytest.raises(SystemExit, match="verify FAILED"):
        cli.main(["convert", "--backbone-pth", src["bb_pth"],
                  "--temporal-pth", src["tm_pth"],
                  "--temporal-prefix-map", src["prefix_map"],
                  "--out", ckpt, "--verify"] + FLAGS)
    assert not os.path.exists(ckpt)


def _with_unknown_key(src, root):
    return ["--backbone-pth", _save(root / "u.pth", {
        **src["bb"], "bogus.weight": np.zeros(3, np.float32)})]


def _with_missing_key(src, root):
    sd = dict(src["bb"])
    del sd["conv3_2_3x3.weight"]
    return ["--backbone-pth", _save(root / "m.pth", sd)]


def _with_bad_map(src, root):
    bad = root / "map.json"
    bad.write_text('["not", "a", "dict"]')
    return ["--temporal-pth", src["tm_pth"], "--temporal-prefix-map",
            str(bad)]


def _with_no_input(src, root):
    return []


def _with_3x3_classifier(src, root):
    return ["--backbone-pth", _save(root / "c.pth", {
        **src["bb"], "classifier.weight": np.zeros((8, 2048, 3, 3),
                                                   np.float32)})]


@pytest.mark.parametrize("make, error, match", [
    (_with_unknown_key, KeyError, "unmapped torch key: bogus.weight"),
    (_with_missing_key, KeyError, "missing torch keys"),
    (_with_bad_map, SystemExit, "expected a flat"),
    (_with_no_input, SystemExit, "convert needs"),
    (_with_3x3_classifier, ValueError, "1x1")],
    ids=["unknown-key", "missing-key", "bad-map", "no-input",
         "non-1x1-classifier"])
def test_strict_errors(src, tmp_path, make, error, match):
    """Each strict refusal raises with its reason and writes nothing; the
    JAX importer refuses the same backbone sources."""
    argv = make(src, tmp_path)
    ckpt = str(tmp_path / "out")
    with pytest.raises(error, match=match):
        cli.main(["convert", *argv, "--out", ckpt] + FLAGS)
    assert not os.path.exists(ckpt)
    if argv and argv[0] == "--backbone-pth":
        sd = checkpoints.load_pth(argv[1])
        with pytest.raises(error):
            jbackbone.load_torch_state_dict(
                jbackbone.normalize_dag_state_dict(sd))


def test_no_strict_skips_unknown_keys(src, tmp_path, capsys):
    argv = _with_unknown_key(src, tmp_path)
    assert cli.main(["convert", *argv, "--out", str(tmp_path / "o"),
                     "--no-strict"] + FLAGS) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "backbone_tensors"] == 267


def test_temporal_shape_mismatch_strict_and_dropped(src, tmp_path, capsys):
    """A temporal tensor whose shape differs from the config's (a fusion
    layer of another width) is an error under strict mode, naming it, and
    is dropped and counted under ``--no-strict``; the tensors that fit
    are merged."""
    sd = dict(src["tm"])
    sd["model.fusion.weight"] = np.zeros((256, 384), np.float32)
    pth = _save(tmp_path / "t.pth", sd)
    argv = ["convert", "--temporal-pth", pth, "--temporal-prefix-map",
            src["prefix_map"], "--out", str(tmp_path / "o")] + FLAGS
    with pytest.raises(SystemExit, match="fusion.weight: checkpoint "
                                         r"\(256, 384\)"):
        cli.main(argv)
    capsys.readouterr()
    assert cli.main(argv + ["--no-strict"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["temporal_dropped_for_config"] == 1
    model = checkpoints.load(str(tmp_path / "o"))["model"]
    np.testing.assert_array_equal(model["temporal.head.weight"].numpy(),
                                  src["tm"]["model.head.weight"])


def test_torch_ref_matches_the_jax_package_twins(src):
    """The port's own reference forwards against the JAX package's on the
    same source tensors and inputs: the same ``torch.nn`` graphs."""
    rng = np.random.default_rng(5)
    tv = backbone.normalize_dag_state_dict(src["bb"])
    imgs = rng.uniform(-120, 120, (2, 2 * S, 2 * S, 3)).astype(np.float32)
    for got, want in zip(torch_ref.backbone_forward(tv, imgs),
                         jtorch_ref.backbone_forward(tv, imgs)):
        np.testing.assert_array_equal(got, want)
    tcfg = src["tcfg"]
    sd = {k[len("model."):]: v for k, v in src["tm"].items()}
    p = tcfg.phase.phase_size
    ph = rng.standard_normal((2, 3, tcfg.num_phase, p, p)).astype(np.float32)
    ft = rng.standard_normal((2, 4, 2048)).astype(np.float32)
    np.testing.assert_array_equal(
        torch_ref.temporal_forward(sd, tcfg.temporal, ph, ft),
        jtorch_ref.temporal_forward(sd, src["jcfg"].temporal, ph, ft))


def test_torch_ref_refuses_variants_not_ported(src):
    """The reference backbone forward refuses no stride placement:
    ``stride_in_1x1=False`` (torchvision's) builds and equals the JAX
    package's ``torch_ref`` bit for bit, and differs from the Caffe
    placement's forward."""
    tv = backbone.normalize_dag_state_dict(src["bb"])
    imgs = np.random.default_rng(3).uniform(
        -120, 120, (2, 2 * S, 2 * S, 3)).astype(np.float32)
    got = torch_ref.backbone_forward(tv, imgs, stride_in_1x1=False)
    want = jtorch_ref.backbone_forward(tv, imgs, stride_in_1x1=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], torch_ref.backbone_forward(tv, imgs)[0])


def test_convert_without_cuda_raises(src, monkeypatch, tmp_path):
    """``convert`` builds its model on the card unless ``--cpu`` is
    given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["convert", "--temporal-pth", src["tm_pth"],
                  "--temporal-prefix-map", src["prefix_map"],
                  "--out", str(tmp_path / "o")] + SMALL_FLAGS)
