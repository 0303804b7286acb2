"""The port's command line (``python -m mimamo_tpu_torch.cli``) against the
JAX package's library calls with the same weights: every subcommand's
JSON line and output files (``predict`` with a video and boxes, with
crops and with emotions; ``extract``; ``eval`` batched over streams;
``predict-corpus``) at atol 1e-5; ``train`` against ``train.fit`` (which
tests/test_torch_train.py holds against the JAX step). Also: argument
coherence, the model-variant flags (each builds its variant and runs
through ``predict`` and ``serve``), the TPU flags that are not registered
(``train --tensorboard`` / ``--debug-nans`` are in
tests/test_torch_train_flags.py),
the multi-process flags failing as the JAX CLI's do, and that every
subcommand raises without a card unless ``--cpu`` is given.

The weights are the JAX package's, converted with
``weights.from_jax_variables`` and saved as a port checkpoint that
``--ckpt`` reads. The config is ``test_torch_serve``'s small one, given as
flags."""

import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from mimamo_tpu import api as japi
from mimamo_tpu import corpus as jcorpus
from mimamo_tpu.backbone import FERPLUS_CLASSES
from mimamo_tpu.data import datasets as jds
from mimamo_tpu.data import eval as jeval
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import api, checkpoints, cli, train
from mimamo_tpu_torch.config import TrainSpec
from mimamo_tpu_torch.data import datasets
from mimamo_tpu_torch.io import decode
from mimamo_tpu_torch.runner import Mimamo

from test_torch_decode import same_native_library  # noqa: F401
from test_torch_serve import (CLIP, S, SMALL_FLAGS, small_configs,
                              small_weights)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "bench"))
import tracker_eval  # noqa: E402

pytest.importorskip("cv2")

ATOL = 1e-5
T_VIDEO = 14
FLAGS = SMALL_FLAGS + ["--cpu"]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The configs, the JAX variables, a port checkpoint of them, a
    written video with a boxes file, and a synthetic Aff-Wild2 corpus."""
    jcfg, tcfg = small_configs()
    variables, state = small_weights(2)
    root = tmp_path_factory.mktemp("cli")
    ckpt = str(root / "ckpt")
    model = Mimamo(tcfg, device="cpu")
    model.load_state_dict(state)
    checkpoints.save(ckpt, train.create_train_state(model))
    video = str(root / "clip.mp4")
    frames, boxes, _eyes = tracker_eval.render_clip(
        t=T_VIDEO, h=64, w=80, face_size=40, motion="sine", speed=1.5,
        seed=4)
    decode.write_video(video, frames)
    boxes_path = str(root / "clip.boxes_in.npy")
    np.save(boxes_path, boxes.astype(np.float32))
    aff = str(root / "aff")
    datasets.make_synthetic_affwild2(aff, n_videos=3, frames=2 * CLIP + 5,
                                     size=S, seed=6)
    return {"jcfg": jcfg, "tcfg": tcfg, "variables": variables,
            "ckpt": ckpt, "video": video, "boxes": boxes_path, "aff": aff,
            "root": root}


@pytest.fixture(scope="module")
def jax_api(case):
    return japi.MimamoAPI(config=case["jcfg"], variables=case["variables"])


def _run(capsys, argv):
    """``cli.main(argv)``: (exit code, the JSON lines it printed)."""
    rc = cli.main(argv)
    out = capsys.readouterr().out
    return rc, [json.loads(x) for x in out.splitlines() if x.strip()]


def _csv(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def test_help_lists_the_subcommands(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for sub in ("predict", "extract", "train", "eval", "predict-corpus",
                "serve", "convert", "bench"):
        assert sub in out


def test_predict_video_matches_jax(case, jax_api, capsys, tmp_path):
    """``predict --video --boxes --out --ckpt``: the JSON line and the
    CSV against the JAX ``MimamoAPI.predict``."""
    out = str(tmp_path / "p.csv")
    want = jax_api.predict(case["video"], boxes_path=case["boxes"])
    rc, lines = _run(capsys, ["predict", "--video", case["video"],
                              "--boxes", case["boxes"], "--out", out,
                              "--ckpt", case["ckpt"]] + FLAGS)
    assert rc == 0 and len(lines) == 1
    row = lines[0]
    assert set(row) == {"frames", "valence_mean", "arousal_mean", "out"}
    assert row["frames"] == T_VIDEO and row["out"] == out
    assert abs(row["valence_mean"] - want[:, 0].mean()) <= ATOL
    assert abs(row["arousal_mean"] - want[:, 1].mean()) <= ATOL
    got = _csv(out)
    assert got.shape == (T_VIDEO, 3)
    np.testing.assert_allclose(got[:, 1:], want, atol=ATOL, rtol=0)


def test_predict_crops_with_emotions_matches_jax(case, jax_api, capsys,
                                                 tmp_path):
    """``predict --crops --emotions --smooth 3``: the series, the CSV's
    emotion columns and the top emotion against the JAX API."""
    crops = np.random.default_rng(3).integers(0, 256, (11, S, S, 3),
                                              dtype=np.uint8)
    path = str(tmp_path / "c.npy")
    np.save(path, crops)
    out = str(tmp_path / "c.csv")
    series, probs = jax_api.predict_crops(path, emotions=True, smooth=3)
    rc, (row,) = _run(capsys, ["predict", "--crops", path, "--out", out,
                               "--emotions", "--smooth", "3", "--ckpt",
                               case["ckpt"]] + FLAGS)
    assert rc == 0 and row["frames"] == 11
    assert row["top_emotion"] == FERPLUS_CLASSES[
        int(np.argmax(probs.mean(axis=0)))]
    got = _csv(out)
    assert got.shape == (11, 3 + 8)
    np.testing.assert_allclose(got[:, 1:3], series, atol=ATOL, rtol=0)
    # the CSV writes probabilities at 4 decimals
    np.testing.assert_allclose(got[:, 3:], probs, atol=1e-4, rtol=0)


def test_extract_matches_jax(case, capsys, tmp_path):
    """``extract``: the crops file against the JAX ``VideoProcessor``
    (within one level of uint8 rounding) and the features against the JAX
    ``FeatureExtractor`` on the same crops file, relative to their scale:
    pool5 features reach ~200, where fp32 sums differ by ~1e-4."""
    jcfg = case["jcfg"]
    crops_j = japi.VideoProcessor(save_size=S, config=jcfg).process(
        case["video"], str(tmp_path / "jax"), boxes_path=case["boxes"])
    rc, (row,) = _run(capsys, ["extract", "--video", case["video"],
                               "--out-dir", str(tmp_path / "port"),
                               "--boxes", case["boxes"], "--ckpt",
                               case["ckpt"]] + FLAGS)
    assert rc == 0 and row["weights"] == "checkpoint"
    crops = np.load(row["crops"])
    assert crops.shape == (T_VIDEO, S, S, 3) and crops.dtype == np.uint8
    assert np.abs(crops.astype(int) - np.load(crops_j)).max() <= 1
    feats_j = np.load(japi.FeatureExtractor(
        config=jcfg, variables=case["variables"]).extract(
        row["crops"], str(tmp_path / "jax.feat.npy")))
    feats = np.load(row["features"])
    assert feats.shape == (T_VIDEO, 2048)
    assert np.abs(feats - feats_j).max() <= ATOL * np.abs(feats_j).max()


@pytest.fixture(scope="module")
def jax_eval(case):
    """``evaluate_affwild2`` of the JAX package at 2 streams a step."""
    return jeval.evaluate_affwild2(
        JaxMimamo(case["jcfg"]), case["variables"],
        jds.AffWild2Dataset(case["aff"], clip=case["jcfg"].clip),
        chunk=CLIP, batch_streams=2)


@pytest.mark.parametrize("batch_streams", [1, 2])
def test_eval_matches_jax(case, jax_eval, capsys, batch_streams):
    """``eval --batch-streams 1`` and ``2`` against the JAX
    ``evaluate_affwild2`` at 2 streams (the batch of streams moves the
    CCCs by rounding only)."""
    want = jax_eval
    rc, (got,) = _run(capsys, ["eval", "--dataset", "affwild2", "--root",
                               case["aff"], "--ckpt", case["ckpt"],
                               "--batch-streams", str(batch_streams)]
                      + FLAGS)
    assert rc == 0 and got.keys() == want.keys()
    assert got["n_frames"] == want["n_frames"]
    for k in ("valence_ccc", "arousal_ccc", "mean_ccc"):
        assert abs(got[k] - want[k]) <= ATOL, k


def test_train_writes_a_restorable_checkpoint(case, capsys, tmp_path):
    """``train`` for one epoch prints ``train.fit``'s row and leaves a
    checkpoint (with its metrics file) that ``MimamoAPI(checkpoint_dir=)``
    restores to the weights ``fit`` ends with."""
    ckpt = str(tmp_path / "trained")
    rc, lines = _run(capsys, ["train", "--dataset", "affwild2", "--root",
                              case["aff"], "--ckpt", ckpt, "--epochs", "1",
                              "--batch", "2", "--lr", "1e-3"] + FLAGS)
    assert rc == 0 and len(lines) == 1
    row = lines[0]
    cfg = dataclasses.replace(case["tcfg"], train=TrainSpec(
        learning_rate=1e-3, batch_size=2, epochs=1))
    ds = datasets.AffWild2Dataset(case["aff"], clip=cfg.clip)
    state, history = train.fit(cfg, ds, epochs=1, device="cpu")
    assert row["steps"] == history[0]["steps"] == len(ds) // 2
    for k in ("loss", "ccc_v", "ccc_a"):
        assert row[k] == history[0][k], k
    assert checkpoints.latest_step(ckpt) == row["steps"]
    assert os.path.exists(ckpt + ".metrics.jsonl")
    restored = api.MimamoAPI(config=case["tcfg"], checkpoint_dir=ckpt,
                             device="cpu").model.state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored[k], v), k


def test_predict_corpus_matches_jax(case, capsys, tmp_path):
    """``predict-corpus --no-native``: the summary line's keys and counts
    and the per-video CSVs against the JAX ``CorpusRunner``."""
    videos = tmp_path / "videos"
    videos.mkdir()
    rng = np.random.default_rng(5)
    for i, t in enumerate((12, 5)):
        decode.write_video(str(videos / f"w{i}.mp4"), rng.uniform(
            0, 255, (t, 48, 64, 3)).astype(np.uint8))
    paths = sorted(str(p) for p in videos.glob("*.mp4"))
    want_dir = str(tmp_path / "jax")
    want = jcorpus.CorpusRunner(JaxMimamo(case["jcfg"]), case["variables"],
                                want_dir, batch_clips=2,
                                use_native=False).run(paths)
    out = str(tmp_path / "port")
    rc, (got,) = _run(capsys, ["predict-corpus", "--videos",
                               str(videos / "*.mp4"), "--out-dir", out,
                               "--batch", "2", "--no-native", "--ckpt",
                               case["ckpt"]] + FLAGS)
    # the port's summary also names the loader that ran
    assert rc == 0 and got.keys() == want.keys() | {"loader"}
    assert got["loader"] == "python"
    for k in ("videos", "failed", "frames", "resumed_skipped"):
        assert got[k] == want[k], k
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0] + ".csv"
        np.testing.assert_allclose(_csv(os.path.join(out, name)),
                                   _csv(os.path.join(want_dir, name)),
                                   atol=ATOL, rtol=0)
    rc, (again,) = _run(capsys, ["predict-corpus", "--videos",
                                 str(videos / "*.mp4"), "--out-dir", out,
                                 "--no-native"] + FLAGS)
    assert again["resumed_skipped"] == 2 and again["videos"] == 0


@pytest.mark.parametrize("argv", [
    ["predict"],
    ["predict", "--crops", "c.npy", "--video", "x.mp4"],
    ["predict", "--crops", "c.npy", "--align"],
    ["predict", "--crops", "c.npy", "--boxes", "b.npy"],
    ["train", "--dataset", "omg", "--root", "."],
    ["train", "--dataset", "affwild2", "--root", ".", "--eval-every", "0"],
    ["train", "--dataset", "affwild2", "--root", ".", "--loss", "ccc+mse"],
    ["predict-corpus", "--videos", "/nonexistent/*.mp4", "--out-dir", "o"],
], ids=["predict-none", "predict-both", "crops-align", "crops-boxes",
        "omg-no-manifest", "eval-every-0", "mse-without-weight",
        "corpus-no-match"])
def test_argument_coherence_exits(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(argv + FLAGS)
    assert e.value.code not in (0, None)


# a smaller config for the variant runs: crop 16, backbone 32, clips of 8
VARIANT_FLAGS = ["--crop-size", "16", "--backbone-size", "32",
                 "--pyramid-height", "2", "--orientations", "2",
                 "--phase-size", "8", "--clip-len", "8", "--stride", "4",
                 "--cpu"]


@pytest.mark.parametrize("flags, field, want", [
    (["--streams", "micro"], "temporal.streams", "micro"),
    (["--snippet-len", "4"], "temporal.snippet_len", 4),
    (["--gru-layers", "2"], "temporal.gru_layers", 2),
    (["--appearance-stride", "2"], "backbone.appearance_stride", 2),
    (["--backbone-size", "16"], "backbone.input_size", 16)],
    ids=["streams", "snippet-len", "gru-layers", "appearance-stride",
         "backbone-size"])
@pytest.mark.parametrize("sub", ["predict", "serve"])
def test_model_variant_flags_name_a16(flags, field, want, sub, tmp_path,
                                      capsys, monkeypatch):
    """Each model-variant flag builds its variant (it no longer exits
    naming ROADMAP.md A16) and runs through ``predict --crops`` and
    ``serve`` (a stream opened, fed one chunk, closed) on the CPU: finite
    values, one per frame."""
    built = []
    config = cli._config
    monkeypatch.setattr(cli, "_config",
                        lambda args: built.append(config(args)) or built[-1])
    crops = np.random.default_rng(3).integers(0, 256, (12, 16, 16, 3),
                                              dtype=np.uint8)
    path = str(tmp_path / "c.npy")
    np.save(path, crops)
    if sub == "predict":
        rc = cli.main(["predict", "--crops", path] + VARIANT_FLAGS + flags)
        row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and row["frames"] == 12
        assert np.isfinite([row["valence_mean"], row["arousal_mean"]]).all()
    else:
        np.save(str(tmp_path / "chunk.npy"), crops[:8])
        reqs = [{"cmd": "stream_open", "stream": "s"},
                {"cmd": "stream_feed", "stream": "s",
                 "crops": str(tmp_path / "chunk.npy")},
                {"cmd": "stream_close", "stream": "s"},
                {"cmd": "shutdown"}]
        monkeypatch.setattr(sys, "stdin", io.StringIO(
            "".join(json.dumps(r) + "\n" for r in reqs)))
        rc = cli.main(["serve", "--capacity", "2", "--chunk", "8",
                       "--no-warmup"] + VARIANT_FLAGS + flags)
        lines = [json.loads(x)
                 for x in capsys.readouterr().out.strip().splitlines()]
        assert rc == 0 and lines[0]["ready"]
        assert all(r["ok"] for r in lines[1:]), lines
        values = np.asarray(lines[2]["values"])
        assert values.shape == (8, 2) and np.isfinite(values).all()
    section, name = field.split(".")
    assert getattr(getattr(built[0], section), name) == want


@pytest.mark.parametrize("argv", [
    ["serve", "--fft-mode", "fft"], ["serve", "--stem-mode", "upscale"],
    ["serve", "--use-pallas"],
    ["convert", "--out", "o", "--use-pallas"], ["bench"]],
    ids=["fft-mode", "stem-mode", "use-pallas", "convert", "bench"])
def test_flags_not_carried_over_are_rejected(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv + FLAGS)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "unrecognized arguments" in err or (
        argv == ["bench"] and "A15" in err)


@pytest.mark.parametrize("argv, error, text", [
    (["eval", "--dataset", "affwild2", "--root", ".", "--data-parallel"],
     FileNotFoundError, "crops"),
    (["train", "--dataset", "affwild2", "--root", ".", "--coordinator",
      "h:1"], SystemExit, "requires --data-parallel"),
    (["predict-corpus", "--videos", "x", "--out-dir", "o",
      "--num-processes", "2"], SystemExit, "require --coordinator")],
    ids=["data-parallel", "coordinator", "num-processes"])
def test_multiprocess_flags_fail_as_jax(argv, error, text, tmp_path,
                                        monkeypatch):
    """The multi-process flags parse, and the same argv fails as the JAX
    CLI fails it, with its text: ``eval --data-parallel`` on an empty root
    finds no crops directory; ``train --coordinator`` needs
    ``--data-parallel``;
    ``--num-processes`` needs ``--coordinator``."""
    from mimamo_tpu import cli as jcli
    monkeypatch.chdir(tmp_path)
    raised = []
    for main in (cli.main, jcli.main):
        with pytest.raises(error, match=text) as e:
            main(argv + FLAGS)
        raised.append(str(e.value))
    if error is SystemExit:
        assert raised[0] == raised[1]


@pytest.mark.parametrize("argv", [
    ["predict", "--crops", "c.npy"],
    ["extract", "--video", "v.mp4", "--out-dir", "o"],
    ["train", "--dataset", "affwild2", "--root", "AFF"],
    ["eval", "--dataset", "affwild2", "--root", "AFF"],
    ["predict-corpus", "--videos", "*.mp4", "--out-dir", "o"],
    ["serve"]], ids=["predict", "extract", "train", "eval",
                     "predict-corpus", "serve"])
def test_no_card_without_cpu_raises(argv, case, monkeypatch):
    """Without a card, each subcommand raises unless ``--cpu`` is
    given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [case["aff"] if a == "AFF" else a for a in argv]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv + SMALL_FLAGS)
