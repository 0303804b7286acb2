"""Data parallelism of the port on 2 gloo CPU ranks against the JAX
package's sharded functions on a 2-device mesh (of the 8 virtual CPU
devices of ``conftest.py``), with the same weights
(``weights.from_jax_variables``) and inputs (``dryrun.inputs``).

The 2 ranks run once per module, through ``dryrun``'s launcher, at its
small config; each check reads their saved results:
  * the frame-level and the batch-level (OMG) train step, one all-padding
    clip on rank 1, against JAX ``train.make_train_step`` on the mesh over
    the same global batch (``tests/test_train.py``'s sharded step): loss
    and CCCs atol 1e-5; each temporal gradient max |d| <= 1e-4 x its max
    |g|; the updated temporal parameters with a well-determined gradient
    (|g| >= 1e-3 of the tensor's largest) within 1e-4 of the tensor's max
    |p|, every element within 2 lr (Adam's first update moves an element
    whose gradient is rounding noise by up to lr either way, see
    ``test_torch_train``); BN running stats atol 1e-5;
  * the fine-tune step (``remat_backbone``: the backbone's synced
    BatchNorms, their collectives reissued by the recompute) against the
    JAX sharded fine-tune step, at ``test_torch_train``'s fine-tune
    bounds: loss 1e-4, backbone BN stats max-rel 1e-3, the gradient as a
    whole (cosine >= 0.99, norms within 1%);
  * ``predict_batch`` of 5 clips against JAX ``predict_batch`` on the
    mesh, atol 1e-5;
  * the slot-split session (1 and 2 GRU layers) against the JAX session
    sharded over the mesh, atol 1e-5;
  * ``sharded_ccc`` of a masked ragged batch against JAX ``sharded_ccc``,
    atol 1e-6; ``host_allgather_f64`` bit for bit; the ranks' parameters
    identical after the step; each rank's own checks against a world of
    one.
Also ``pad_to_multiple`` and ``shard_paths`` against JAX's, the CLI's
multi-process exits, a group whose rank 0 never joins, and the command line in
two processes: ``eval --data-parallel`` against one process (1e-6) and
JAX ``evaluate_affwild2`` (1e-5), ``train`` against one process stepping
the union of the two slices, ``predict-corpus`` against one process.
"""

import dataclasses
import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mimamo_tpu import config as jc
from mimamo_tpu import parallel as jparallel
from mimamo_tpu import train as jtrain
from mimamo_tpu.data import datasets as jds
from mimamo_tpu.data import eval as jeval
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu.streaming import StreamingSession as JaxSession
from mimamo_tpu_torch import (checkpoints, cli, dryrun, parallel, train,
                              weights)
from mimamo_tpu_torch import config as tc
from mimamo_tpu_torch.corpus import CorpusRunner
from mimamo_tpu_torch.data import datasets
from mimamo_tpu_torch.data.eval import evaluate_affwild2
from mimamo_tpu_torch.runner import Mimamo

from test_torch_train import _capture, _jax_grads

WORLD = 2
LR = dryrun.config().train.learning_rate
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the subprocesses share this machine with the other test workers
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
TIMEOUT_S = 300


def _jax_config(cfg):
    """The JAX package's config with the port config's fields."""
    return jc.MimamoConfig(**{
        f.name: getattr(jc, type(spec).__name__)(**dataclasses.asdict(spec))
        for f in dataclasses.fields(cfg)
        for spec in [getattr(cfg, f.name)]})


def _jax_variables(cfg, seed):
    init = jax.jit(functools.partial(JaxMimamo(cfg).init_variables,
                                     clip_len=dryrun.T))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The dry run on 2 CPU ranks, with JAX weights for the flagship and
    the 2-layer variant: each rank's row and raw results."""
    root = tmp_path_factory.mktemp("dryrun")
    variables = {}
    for seed, variant in enumerate(("flagship", "gru2")):
        variables[variant] = _jax_variables(
            _jax_config(dryrun.config(variant)), seed)
        torch.save(weights.from_jax_variables(variables[variant]),
                   str(root / f"{variant}.pt"))
    rows = dryrun.rows(dryrun.start(WORLD, cpu=True, weights_dir=str(root),
                                    out_dir=str(root), timeout=TIMEOUT_S,
                                    env=ENV).wait())
    assert all(row is not None for row in rows), rows
    raw = [torch.load(str(root / f"rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    return {"rows": rows, "raw": raw, "variables": variables,
            "data": dryrun.inputs(WORLD)}


@pytest.fixture(scope="module")
def mesh():
    return jparallel.make_mesh(jax.devices()[:WORLD])


def _jax_step(step, variables, batch, mesh):
    """The JAX step (``dryrun.STEPS``) on the mesh over the global batch:
    metrics, gradients (captured ahead of Adam), new weights under the
    port's names."""
    cfg = _jax_config(dryrun.config("flagship", step))
    model = JaxMimamo(cfg)
    tx = optax.chain(_capture(), jtrain.make_optimizer(cfg))
    state, tx = jtrain.create_train_state(model, jax.random.PRNGKey(0),
                                          tx=tx, variables=variables)
    step = jtrain.make_train_step(model, tx)
    state, metrics = step(
        jparallel.replicate(state, mesh),
        jparallel.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              mesh))
    tree = jax.tree_util.tree_map(np.asarray, state)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": tree.opt_state[0]["g"],
            "state": weights.from_jax_variables(
                jtrain.variables_from_state(tree))}


# -- the dry run's ranks against the JAX package's sharded functions ---------

@pytest.mark.parametrize("axis", ["time", "batch"])
def test_train_step_matches_jax_sharded(ranks, mesh, axis):
    data = ranks["data"]
    labels = "labels" if axis == "time" else "omg_labels"
    want = _jax_step(axis, ranks["variables"]["flagship"],
                     {"clips": data["clips"], "labels": data[labels],
                      "mask": data["mask"]}, mesh)
    jg = _jax_grads(want, "temporal")
    for raw in ranks["raw"]:
        got = raw[axis]
        for k in ("loss", "ccc_v", "ccc_a"):
            assert abs(got["metrics"][k] - want["metrics"][k]) <= 1e-5, k
        pg = got["grads"]
        assert set(pg) == set(jg)
        for k, g in jg.items():
            gmax = float(g.abs().max())
            assert float((pg[k] - g).abs().max()) <= 1e-4 * gmax, k
            p, q = got["state"][k], want["state"][k]
            sure = g.abs() >= 1e-3 * gmax
            assert float((p - q).abs()[sure].max()) <= \
                1e-4 * float(q.abs().max()), k
            assert float((p - q).abs().max()) <= 2 * LR + 1e-6, k
        for k, v in want["state"].items():
            if "running" in k:
                np.testing.assert_allclose(got["state"][k].numpy(),
                                           v.numpy(), atol=1e-5, rtol=0,
                                           err_msg=k)
            elif k.startswith("backbone."):       # frozen
                assert torch.equal(got["state"][k], v), k


def test_finetune_step_matches_jax_sharded(ranks, mesh):
    data = ranks["data"]
    want = _jax_step("finetune", ranks["variables"]["flagship"],
                     {"clips": data["clips"], "labels": data["labels"],
                      "mask": data["mask"]}, mesh)
    jg = {**_jax_grads(want, "temporal"), **_jax_grads(want, "backbone")}
    jg = {k: v for k, v in jg.items() if not k.startswith("backbone.fc.")}
    for raw in ranks["raw"]:
        got = raw["finetune"]
        assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) <= 1e-4
        assert set(got["grads"]) == set(jg)
        cos, ratio = dryrun.grad_agreement(got["grads"], jg)
        assert cos >= 0.99 and abs(ratio - 1) <= 1e-2, (cos, ratio)
        for k, v in want["state"].items():
            if k.startswith("backbone.") and "running" in k:
                rel = float((got["state"][k] - v).abs().max()
                            / v.abs().max())
                assert rel <= 1e-3, k


def test_predict_batch_matches_jax_sharded(ranks, mesh):
    cfg = _jax_config(dryrun.config())
    want = np.asarray(JaxMimamo(cfg).predict_batch(
        ranks["variables"]["flagship"], jnp.asarray(ranks["data"]["predict"]),
        mesh))
    assert want.shape == (dryrun.PREDICT_B, dryrun.T, 2)
    for raw in ranks["raw"]:
        np.testing.assert_allclose(raw["predict_batch"].numpy(), want,
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", ["flagship", "gru2"])
def test_session_matches_jax_sharded(ranks, mesh, variant):
    cfg = _jax_config(dryrun.config(variant))
    sess = JaxSession(JaxMimamo(cfg), ranks["variables"][variant],
                      capacity=2 * WORLD, chunk=dryrun.T, mesh=mesh)
    videos = ranks["data"]["videos"]
    slots = [sess.add_stream() for _ in videos]
    want = {s: [] for s in slots}
    for start in (0, dryrun.T):
        out = sess.feed({s: v[start:start + dryrun.T]
                         for s, v in zip(slots, videos)})
        for s in slots:
            want[s].append(np.asarray(out[s]))
    for raw in ranks["raw"]:
        got = raw["sessions"][variant]
        assert sorted(got) == slots
        for s in slots:
            for g, w in zip(got[s], want[s]):
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_sharded_ccc_matches_jax(ranks, mesh):
    data = ranks["data"]
    want = np.asarray(jparallel.sharded_ccc(
        jparallel.shard_batch(jnp.asarray(data["ccc_preds"]), mesh),
        jparallel.shard_batch(jnp.asarray(data["ccc_golds"]), mesh), mesh,
        mask=jparallel.shard_batch(jnp.asarray(data["ccc_mask"]), mesh)))
    for raw in ranks["raw"]:
        np.testing.assert_allclose(raw["sharded_ccc"].numpy(), want,
                                   atol=1e-6, rtol=0)


def test_host_allgather_f64_is_bit_exact(ranks):
    want = ranks["data"]["f64"]
    for raw in ranks["raw"]:
        assert raw["allgather"].shape == want.shape
        assert np.array_equal(raw["allgather"].view(np.uint64),
                              want.view(np.uint64))


def test_ranks_hold_identical_parameters(ranks):
    assert dryrun.same_params(ranks["rows"])
    for step in dryrun.STEPS:
        a, b = (raw[step]["state"] for raw in ranks["raw"])
        assert all(torch.equal(a[k], b[k]) for k in a), step


def test_ranks_agree_with_a_world_of_one(ranks):
    """Each rank's own checks: each step against the same step at a world
    of one on the whole batch, ``predict_batch`` (also at stride 2,
    micro-only and in bf16) against ``predict_clips``, the split session
    against an unsplit one, all within the dry run's bounds, on gloo CPU
    ranks; the launch counts are there (0 on the CPU)."""
    for r, row in enumerate(ranks["rows"]):
        assert (row["rank"], row["world"], row["backend"], row["device"]) \
            == (r, WORLD, "gloo", "cpu")
        assert row["ok"], row
        assert set(row["launches_train"]) == set(dryrun.KERNELS)
        assert sorted(row["launches_predict_batch"]) == ["bfloat16",
                                                         "float32"]


# -- the helpers and the group ---------------------------------------------

@pytest.mark.parametrize("b", [1, 3, 4, 7])
def test_pad_to_multiple_matches_jax(b):
    rng = np.random.default_rng(b)
    batch = {"x": rng.standard_normal((b, 2, 3)).astype(np.float32),
             "m": np.ones(b, np.float32)}
    want = jparallel.pad_to_multiple(batch, 4)
    got = parallel.pad_to_multiple(batch, 4)
    tgot = parallel.pad_to_multiple(torch.from_numpy(batch["x"]), 4)
    for k in batch:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    np.testing.assert_array_equal(tgot.numpy(), np.asarray(want["x"]))


def test_shard_paths_matches_jax():
    paths = [f"v{i}.mp4" for i in range(7)]
    for n in (1, 2, 3):
        for pid in range(n):
            assert (parallel.shard_paths(paths, pid, n)
                    == jparallel.shard_paths(paths, pid, n))
    with pytest.raises(ValueError, match="out of range"):
        parallel.shard_paths(paths, 2, 2)


def test_augmentation_of_a_rank_is_its_rows_of_the_global_batch():
    """A rank augments its rows as one process augments the global batch
    (the same flips and brightness draws)."""
    spec = tc.TrainSpec(augment=True, brightness_jitter=0.3)
    clips = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 255, (4, 2, 8, 8, 3)).astype(np.float32))
    whole = train.augment_clips(clips, spec, step=5)
    for r in range(WORLD):
        rows = slice(2 * r, 2 * r + 2)
        assert torch.equal(train.augment_clips(clips[rows], spec, 5,
                                               first=2 * r, total=4),
                           whole[rows])


def test_group_that_does_not_form_raises():
    """Rank 1 of 2 whose rank 0 never joins the coordinator's store raises;
    it does not run on alone. (The store is this test's own, on a port the
    system picks, so no other run can answer there.)"""
    store = torch.distributed.TCPStore("127.0.0.1", 0, None, is_master=True,
                                       wait_for_workers=False)
    with pytest.raises(RuntimeError, match="did not form"):
        parallel.initialize_distributed(
            f"127.0.0.1:{store.port}", 2, 1, device="cpu", timeout=2.0)


def test_rank_without_a_card_raises(monkeypatch):
    """A rank never moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.initialize_distributed("127.0.0.1:1", 2, 0)
    one = parallel.initialize_distributed(device="cpu")
    assert (one.world, one.rank, one.backend) == (1, 0, None)


# -- the command line --------------------------------------------------------

SMALL = ["--crop-size", "16", "--backbone-size", "32", "--pyramid-height",
         "2", "--orientations", "2", "--phase-size", "16", "--clip-len", "4",
         "--stride", "2", "--cpu"]


@pytest.mark.parametrize("argv, text", [
    (["train", "--dataset", "affwild2", "--root", ".", "--coordinator",
      "h:1"], "requires --data-parallel"),
    (["predict-corpus", "--videos", "x", "--out-dir", "o",
      "--num-processes", "2"], "require --coordinator"),
    (["eval", "--dataset", "affwild2", "--root", ".", "--process-id", "0"],
     "require --coordinator"),
    (["train", "--dataset", "affwild2", "--root", ".", "--num-processes",
      "2"], "require --coordinator"),
    (["train", "--dataset", "affwild2", "--root", ".", "--data-parallel",
      "--coordinator", "h:1", "--num-processes", "2", "--process-id", "0",
      "--batch", "3"], "divisible by the process count 2")],
    ids=["coordinator-without-data-parallel", "processes-without-coordinator",
         "process-id-without-coordinator",
         "train-processes-without-coordinator", "batch-not-divisible"])
def test_multiprocess_exits(argv, text):
    """The JAX CLI's exits and texts (``train --num-processes`` without
    ``--coordinator`` exits too, where JAX ``train`` runs one process
    over the whole data set: ROADMAP Queue C 7)."""
    with pytest.raises(SystemExit) as e:
        cli.main(argv + SMALL)
    assert text in str(e.value.code)


def _two_ranks(argv):
    """``cli`` ``argv`` in two processes of one group: each one's JSON
    lines."""
    results = dryrun.cli_ranks(argv + SMALL, WORLD, env=ENV,
                               timeout=TIMEOUT_S).wait()
    for res in results:
        assert res.rc == 0, res.err
    return [res.lines for res in results]


@pytest.fixture(scope="module")
def aff(tmp_path_factory):
    """A synthetic Aff-Wild2 corpus of 3 videos (8 clips each) and a port
    checkpoint of JAX weights at the CLI's small config."""
    root = tmp_path_factory.mktemp("aff")
    datasets.make_synthetic_affwild2(str(root / "aff"), n_videos=3,
                                     frames=17, size=16, seed=6)
    cfg = tc.MimamoConfig(                      # the config of SMALL
        pyramid=tc.PyramidSpec(height=2, orientations=2, input_size=(16, 16)),
        phase=tc.PhaseSpec(phase_size=16),
        backbone=tc.BackboneSpec(input_size=32),
        clip=tc.ClipSpec(clip_len=4, stride=2, crop_size=16))
    variables = _jax_variables(_jax_config(cfg), 3)
    model = Mimamo(cfg, device="cpu")
    model.load_state_dict(weights.from_jax_variables(variables))
    ckpt = str(root / "ckpt")
    checkpoints.save(ckpt, train.create_train_state(model))
    return {"root": str(root / "aff"), "ckpt": ckpt, "cfg": cfg,
            "variables": variables, "model": model}


def test_two_process_eval_matches_one_and_jax(aff, tmp_path, capsys):
    """Both processes print the metrics of one process (each video alone
    in its stream, so the same forwards; moment sums against the host
    CCC) and of JAX ``evaluate_affwild2``."""
    argv = ["eval", "--dataset", "affwild2", "--root", aff["root"],
            "--ckpt", aff["ckpt"], "--batch-streams", "1"]
    rows = [lines[-1] for lines in _two_ranks(argv)]
    assert cli.main(argv + SMALL) == 0
    one = json.loads(capsys.readouterr().out.splitlines()[-1])
    want = jeval.evaluate_affwild2(
        JaxMimamo(_jax_config(aff["cfg"])), aff["variables"],
        jds.AffWild2Dataset(aff["root"], clip=_jax_config(aff["cfg"]).clip),
        chunk=4, batch_streams=1)
    for row in rows:
        assert row["n_frames"] == one["n_frames"] == want["n_frames"]
        for k in ("valence_ccc", "arousal_ccc", "mean_ccc"):
            assert abs(row[k] - one[k]) <= 1e-6, k
            assert abs(row[k] - want[k]) <= 1e-5, k


def test_two_process_train_matches_one_process(aff, tmp_path):
    """``train --batch 24`` on 2 processes (12 clips each from its own
    slice, one step, eval of the same corpus on both) prints one row on
    both, and its checkpoint is the step of one process over the union of
    the two slices; its validation metrics are those of the saved weights. A
    second run with ``--resume`` steps on from that checkpoint."""
    ckpt = str(tmp_path / "ckpt")
    argv = ["train", "--dataset", "affwild2", "--root", aff["root"],
            "--batch", "24", "--epochs", "1", "--lr", "1e-3", "--ckpt", ckpt,
            "--eval-root", aff["root"]]
    rows = [lines[-1] for lines in _two_ranks(argv)]
    rows[1]["sec"] = rows[0]["sec"]             # each process's own clock
    assert rows[0] == rows[1] and rows[0]["steps"] == 1
    cfg = dataclasses.replace(aff["cfg"], train=dataclasses.replace(
        aff["cfg"].train, learning_rate=1e-3, batch_size=24))
    ds = datasets.AffWild2Dataset(aff["root"], clip=cfg.clip)
    slices = [next(ds.batches(12, shuffle=True, seed=0, drop_remainder=True,
                              process_id=p, process_count=WORLD))
              for p in range(WORLD)]
    batch = {k: np.concatenate([b[k] for b in slices]) for k in slices[0]}
    model = Mimamo(cfg, device="cpu")
    model.load_state_dict(weights.init_variables(cfg, 0))
    _, metrics = train.make_train_step(model)(
        train.create_train_state(model), batch)
    assert abs(rows[0]["loss"] - float(metrics["loss"])) <= 1e-4
    saved = checkpoints.load(ckpt)["model"]
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(saved[k].numpy(), v.numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
        elif k.startswith("temporal.") and "num_batches" not in k:
            g = dict(model.named_parameters())[k].grad
            d = (saved[k] - v).abs()
            assert float(d.max()) <= 2e-3 + 1e-6, k
            assert float(d[g.abs() >= 1e-3 * g.abs().max()].max()) <= 1e-6, k
    restored = Mimamo(aff["cfg"], device="cpu")
    restored.load_state_dict(saved)
    ev = evaluate_affwild2(restored, ds, chunk=4)
    assert abs(rows[0]["val_mean_ccc"] - ev["mean_ccc"]) <= 1e-4
    # every rank resumes from rank 0's checkpoint and steps on from it
    again = [lines[-1] for lines in _two_ranks(
        argv[:-2] + ["--resume"])]
    again[1]["sec"] = again[0]["sec"]
    assert again[0] == again[1] and np.isfinite(again[0]["loss"])
    assert checkpoints.latest_step(ckpt) == 2


def test_two_process_corpus_matches_one_process(aff, tmp_path):
    """``predict-corpus`` on 2 processes: disjoint videos, a manifest each,
    and together the CSVs and manifest rows of one process."""
    pytest.importorskip("cv2")
    from mimamo_tpu_torch.io import decode
    videos = tmp_path / "videos"
    videos.mkdir()
    rng = np.random.default_rng(5)
    for i, t in enumerate((12, 5, 9)):
        decode.write_video(str(videos / f"w{i}.mp4"), rng.uniform(
            0, 255, (t, 48, 64, 3)).astype(np.uint8))
    out = tmp_path / "two"
    sums = [lines[-1] for lines in _two_ranks(
        ["predict-corpus", "--videos", str(videos / "*.mp4"), "--out-dir",
         str(out), "--batch", "2", "--no-native", "--ckpt", aff["ckpt"]])]
    assert [s["videos"] for s in sums] == [2, 1]
    one = str(tmp_path / "one")
    paths = sorted(glob.glob(str(videos / "*.mp4")))
    assert CorpusRunner(aff["model"], one, batch_clips=2,
                        use_native=False).run(paths)["videos"] == 3

    def rows(d, pattern):
        out = []
        for p in glob.glob(os.path.join(d, pattern)):
            with open(p) as f:
                out += [(r["video"], r["status"], r.get("frames"))
                        for r in map(json.loads, f)]
        return sorted(out)

    assert rows(str(out), "manifest.p*.jsonl") == rows(one, "manifest.jsonl")
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0] + ".csv"
        np.testing.assert_allclose(
            np.loadtxt(out / name, delimiter=",", skiprows=1, ndmin=2),
            np.loadtxt(os.path.join(one, name), delimiter=",", skiprows=1,
                       ndmin=2), atol=1e-5, rtol=0)
