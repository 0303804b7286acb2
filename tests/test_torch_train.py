"""The training slice: port ``losses``, ``train`` (schedule, optimizer, the
train step frozen and fine-tuning, augmentation, ``fit``) vs
``mimamo_tpu.losses`` / ``mimamo_tpu.train``, with the same weights
(``weights.from_jax_variables``) and batches, at the small config of
``test_torch_runner`` (crops of 32, backbone input 64, 2 x 2 pyramid,
clips of 4). The JAX steps run once per module, in one fixture.

Tolerances, measured on these inputs (lr 1e-4):
  * loss and CCCs atol 1e-5 at the first step (measured 1.8e-6), 2e-4
    at the later ones (5.2e-5); each temporal gradient of the first step
    max |d| <= 1e-4 x its tensor's max |g| (3e-5: the GRU's backward sums
    in another order); temporal BN running stats atol 1e-5 after every
    step (1.4e-6).
  * parameters: Adam's first update is lr * g / (|g| + 1e-8), so an
    element whose gradient is rounding noise (|g| ~ 1e-7 of its tensor's
    largest) moves by up to lr either way in either package, with signs
    that differ. Elements with |g| >= 1e-3 max|g| agree to 5e-7 after the
    first step (one ulp of the largest parameters); every element stays
    within 2 lr per step. That spread is why the trajectories are held at
    lr 1e-4: at 1e-3 the CCCs part by 2e-2 after 3 steps.
  * fine-tuning: the train-mode backbone at this size is ill-conditioned
    in JAX itself (a 1e-6 relative change of its input moves a layer's
    gradient by up to 25% of its max), so the backbone gradient is held
    as a whole: cosine >= 0.99 and norms within 1% (measured 0.998,
    1.001); loss atol 1e-4 (1.2e-5), backbone BN stats max-rel 1e-3
    (1.2e-4).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mimamo_tpu import config as jc
from mimamo_tpu import losses as jlosses
from mimamo_tpu import train as jtrain
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import checkpoints, losses, train, weights
from mimamo_tpu_torch import config as tc
from mimamo_tpu_torch.data import datasets
from mimamo_tpu_torch.runner import Mimamo

from test_torch_decode import drop_passed_tmp_path  # noqa: F401
from test_torch_runner import S, T, _configs

B, LR, STEPS = 3, 1e-4, 3


def _batch():
    """3 clips of 4 frames: clip 0 with one masked frame, clip 2 all
    padding."""
    rng = np.random.default_rng(1)
    mask = np.ones((B, T), np.float32)
    mask[0, 1] = 0
    mask[2] = 0
    return {"clips": rng.integers(0, 256, (B, T, S, S, 3)).astype(np.float32),
            "labels": np.tanh(rng.normal(size=(B, T, 2))).astype(np.float32),
            "mask": mask}


def _capture():
    """An optax transformation that passes the gradients on and keeps
    them in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda u, s, p=None: (u, {"g": u}))


def _jax_steps(jcfg, variables, batch, steps):
    model = JaxMimamo(jcfg)
    tx = optax.chain(_capture(), jtrain.make_optimizer(jcfg))
    state, tx = jtrain.create_train_state(model, jax.random.PRNGKey(0),
                                          tx=tx, variables=variables)
    step = jtrain.make_train_step(model, tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(steps):
        state, metrics = step(state, jb)
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": np_tree(state.opt_state[0]["g"]),
                    "state": weights.from_jax_variables(
                        np_tree(jtrain.variables_from_state(state)))})
    return out


def _train_specs(**kw):
    return (jc.TrainSpec(learning_rate=LR, **kw),
            tc.TrainSpec(learning_rate=LR, **kw))


@pytest.fixture(scope="module")
def ref():
    """JAX steps, once: 3 frozen steps per loss axis, 1 fine-tune step."""
    jcfg, _ = _configs("float32")
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(functools.partial(
            JaxMimamo(jcfg).init_variables, clip_len=T))(
            jax.random.PRNGKey(0)))
    batch = _batch()
    out = {"variables": variables, "data": batch}
    for axis in ("time", "batch"):
        js, _ = _train_specs(loss_axis=axis)
        out[axis] = _jax_steps(dataclasses.replace(jcfg, train=js),
                               variables, batch, STEPS)
    js, _ = _train_specs(freeze_backbone=False)
    out["finetune"] = _jax_steps(dataclasses.replace(jcfg, train=js),
                                 variables, batch, 1)
    return out


def _port(ref, **train_kw):
    _, tcfg = _configs("float32")
    model = Mimamo(dataclasses.replace(
        tcfg, train=tc.TrainSpec(learning_rate=LR, **train_kw)),
        device="cpu")
    model.load_state_dict(weights.from_jax_variables(ref["variables"]))
    return model, train.create_train_state(model), train.make_train_step(model)


def _grads(model, prefix):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None and n.startswith(prefix)}


def _jax_grads(step, part):
    """JAX gradients of ``part`` ("temporal" / "backbone") under the port's
    names (the converters read BN stats too: zeros of the right
    structure)."""
    params = step["grads"][part]
    conv = (weights.temporal_from_jax if part == "temporal"
            else weights.backbone_from_jax)
    tree = {"params": params, "batch_stats": _stats_like(params)}
    return {f"{part}.{k}": v for k, v in conv(tree).items()
            if "running" not in k and "num_batches" not in k}


def _stats_like(params):
    """A batch_stats tree of zeros with the BN layers of a backbone params
    tree (only its structure is read)."""
    out = {}
    for name, node in params.items():
        if isinstance(node, dict) and ("scale" in node):
            out[name] = {"mean": 0, "var": 0}
        elif isinstance(node, dict):
            sub = _stats_like(node)
            if sub:
                out[name] = sub
    return out


# -- losses -------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (7, 2)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mse", [0.0, 0.5])
def test_ccc_and_loss_match_jax(shape, masked, mse):
    """``ccc`` and ``ccc_loss`` with and without a mask and the MSE term:
    atol 1e-6."""
    rng = np.random.default_rng(3)
    p = rng.normal(size=shape).astype(np.float32)
    y = rng.normal(size=shape).astype(np.float32)
    m = (rng.uniform(size=shape[0]) > 0.3).astype(np.float32) if masked \
        else None
    tm = None if m is None else torch.from_numpy(m)
    jm = None if m is None else jnp.asarray(m)
    np.testing.assert_allclose(
        losses.ccc(torch.from_numpy(p), torch.from_numpy(y), tm).numpy(),
        np.asarray(jlosses.ccc(jnp.asarray(p), jnp.asarray(y), jm)),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        float(losses.ccc_loss(torch.from_numpy(p), torch.from_numpy(y), tm,
                              mse_weight=mse)),
        float(jlosses.ccc_loss(jnp.asarray(p), jnp.asarray(y), jm,
                               mse_weight=mse)), atol=1e-6, rtol=0)


# -- schedule -----------------------------------------------------------------

@pytest.mark.parametrize("kw,total", [
    ({}, None),
    ({"warmup_steps": 5}, None),
    ({"lr_schedule": "cosine"}, 20),
    ({"lr_schedule": "cosine", "warmup_steps": 4}, 20),
    ({"lr_schedule": "cosine", "warmup_steps": 30}, 12),
])
def test_lr_schedule_matches_optax(kw, total):
    """The rate at update counts 0..25 equals the optax schedule that
    ``mimamo_tpu.train.make_optimizer`` builds, to 1e-9 (the first warmup
    step has rate 0)."""
    js, ts = (jc.TrainSpec(learning_rate=3e-4, **kw),
              tc.TrainSpec(learning_rate=3e-4, **kw))
    t = js
    if t.lr_schedule == "cosine":
        sched = optax.warmup_cosine_decay_schedule(
            0.0, t.learning_rate, min(t.warmup_steps, max(total - 1, 1)),
            total)
    elif t.warmup_steps:
        sched = optax.linear_schedule(0.0, t.learning_rate, t.warmup_steps)
    else:
        sched = optax.constant_schedule(t.learning_rate)
    ours = train.lr_schedule(ts, total)
    for c in range(26):
        assert abs(ours(c) - float(sched(c))) <= 1e-9, c
    if kw.get("warmup_steps"):
        assert ours(0) == 0.0


def test_lr_schedule_requires_total_steps_and_known_kind():
    with pytest.raises(ValueError, match="total_steps"):
        train.lr_schedule(tc.TrainSpec(lr_schedule="cosine"))
    with pytest.raises(ValueError, match="unknown"):
        train.lr_schedule(tc.TrainSpec(lr_schedule="step"))


def test_train_spec_validation_matches_jax():
    for kw in ({"loss": "mse"}, {"loss": "ccc+mse"}, {"mse_weight": 0.5},
               {"weight_decay": -1.0}):
        with pytest.raises(ValueError):
            jc.TrainSpec(**kw)
        with pytest.raises(ValueError):
            tc.TrainSpec(**kw)
    assert dataclasses.asdict(tc.TrainSpec()) == dataclasses.asdict(
        jc.TrainSpec())


# -- the train step -------------------------------------------------------------

@pytest.mark.parametrize("axis", ["time", "batch"])
def test_train_step_matches_jax(ref, axis):
    """Frozen backbone, a masked frame and an all-padding clip: loss,
    gradients, parameters and BN running stats after 1 and 3 steps (see
    the module docstring for the tolerances)."""
    model, state, step = _port(ref, loss_axis=axis)
    first = dict(model.state_dict())
    first = {k: v.clone() for k, v in first.items()}
    for i, want in enumerate(ref[axis]):
        state, metrics = step(state, ref["data"])
        got = model.state_dict()
        for k in ("loss", "ccc_v", "ccc_a"):
            tol = 1e-5 if i == 0 else 2e-4
            assert abs(float(metrics[k]) - want["metrics"][k]) <= tol, (i, k)
        stats = [k for k in got if "running" in k]
        for k in stats:
            np.testing.assert_allclose(got[k].numpy(), want["state"][k].numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
        for k, v in want["state"].items():
            if k.startswith("temporal.") and "running" not in k \
                    and "num_batches" not in k:
                d = (got[k] - v).abs()
                assert float(d.max()) <= 2 * LR * (i + 1) + 1e-6, k
        if i == 0:
            jg = _jax_grads(want, "temporal")
            pg = _grads(model, "temporal.")
            assert set(pg) == set(jg)
            for k, g in jg.items():
                gmax = float(g.abs().max())
                assert float((pg[k] - g).abs().max()) <= 1e-4 * gmax, k
                sure = g.abs() >= 1e-3 * gmax
                d = (got[k] - want["state"][k]).abs()[sure]
                assert float(d.max()) <= 5e-7, k
                moved = (got[k] - first[k]).abs()[sure]
                assert float(moved.min()) > 0.5 * LR, k
    assert state.step == STEPS


def test_frozen_backbone_is_bit_equal(ref):
    """Under ``freeze_backbone`` the optimizer holds only the temporal
    parameters and the backbone, BN stats included, does not move."""
    model, state, step = _port(ref)
    before = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert held == {id(p) for p in model.temporal.parameters()}
    for _ in range(2):
        state, _ = step(state, ref["data"])
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not any(p.grad is not None for p in model.backbone.parameters())


def test_cached_features_step_equals_online_step(ref):
    """A batch carrying ``features`` (``embed_frames`` of its clips) gives
    the online frozen step's loss and updates; with augmentation, or when
    fine-tuning, cached features raise."""
    model_a, state_a, step_a = _port(ref)
    model_b, state_b, step_b = _port(ref)
    batch = dict(ref["data"])
    with torch.no_grad():
        batch["features"] = model_b.embed_frames(
            torch.from_numpy(batch["clips"])).numpy()
    for _ in range(2):
        state_a, ma = step_a(state_a, ref["data"])
        state_b, mb = step_b(state_b, batch)
        assert float(ma["loss"]) == float(mb["loss"])
    for k, v in model_a.temporal.state_dict().items():
        assert torch.equal(v, model_b.temporal.state_dict()[k]), k
    for kw, match in (({"augment": True}, "augmentation"),
                      ({"freeze_backbone": False}, "cached features")):
        _m, state, step = _port(ref, **kw)
        with pytest.raises(ValueError, match=match):
            step(state, batch)


@pytest.fixture(scope="module")
def finetuned(ref):
    """One fine-tune step with ``remat_backbone`` on and off, from the
    JAX weights: per setting the model, its metrics and gradients, its
    backbone stats before the step and, without remat, ``predict_clips``
    of clip 0 before the step."""
    out = {}
    for remat in (True, False):
        model, state, step = _port(ref, freeze_backbone=False,
                                   remat_backbone=remat)
        run = {"before": {k: v.clone()
                          for k, v in model.backbone.state_dict().items()}}
        if not remat:
            run["pred_before"] = model.predict_clips(ref["data"]["clips"][:1])
        _, run["metrics"] = step(state, ref["data"])
        run["grads"] = _grads(model, "backbone.")
        run["model"] = model
        out[remat] = run
    return out


@pytest.mark.parametrize("remat", [True, False])
def test_finetune_step_matches_jax(ref, finetuned, remat):
    """One fine-tune step (fp32, ``remat_backbone`` on and off) against
    JAX's (remat on): loss, backbone BN running stats, the backbone
    gradient as a whole (see the module docstring); backbone parameters
    and stats move."""
    run = finetuned[remat]
    want = ref["finetune"][0]
    assert abs(float(run["metrics"]["loss"]) - want["metrics"]["loss"]) \
        <= 1e-4
    got = run["model"].state_dict()
    for k, v in want["state"].items():
        if k.startswith("backbone.") and "running" in k:
            rel = float((got[k] - v).abs().max() / v.abs().max())
            assert rel <= 1e-3, k
            assert not torch.equal(got[k], run["before"][k[9:]]), k
    jg = _jax_grads(want, "backbone")
    pg = run["grads"]
    assert set(pg) == set(jg) - {"backbone.fc.weight", "backbone.fc.bias"}
    dot = sum(float((pg[k] * jg[k]).sum()) for k in pg)
    n_p = sum(float((pg[k] ** 2).sum()) for k in pg) ** 0.5
    n_j = sum(float((jg[k] ** 2).sum()) for k in pg) ** 0.5
    assert dot / (n_p * n_j) >= 0.99 and abs(n_p / n_j - 1) <= 1e-2
    assert not torch.equal(got["backbone.conv1.weight"],
                           run["before"]["conv1.weight"])


def test_remat_changes_nothing(finetuned):
    """With and without ``remat_backbone`` a fine-tune step gives the same
    weights and the same BN stats (updated once: the recomputation leaves
    them alone)."""
    sds = [finetuned[remat]["model"].state_dict() for remat in (True, False)]
    for remat in (True, False):
        bn1 = finetuned[remat]["model"].backbone.bn1
        assert int(bn1.num_batches_tracked) == 1
    for k, v in sds[0].items():
        torch.testing.assert_close(v, sds[1][k], atol=1e-6, rtol=0, msg=k)


def test_finetune_step_drops_the_folded_backbone(ref, finetuned):
    """``predict_clips`` after a fine-tune step runs the updated weights:
    it differs from before and equals a fresh model loaded with them."""
    run = finetuned[False]
    clips = ref["data"]["clips"][:1]
    after = run["model"].predict_clips(clips)
    fresh, _s, _f = _port(ref)
    fresh.load_state_dict(run["model"].state_dict())
    assert not torch.allclose(run["pred_before"], after)
    torch.testing.assert_close(after, fresh.predict_clips(clips), atol=0,
                               rtol=0)


def test_augmentation_is_deterministic_and_per_clip():
    """Flip and brightness depend on (seed, step) only, flip the width axis
    of whole clips, and stay in 0..255."""
    rng = np.random.default_rng(5)
    clips = torch.from_numpy(rng.uniform(0, 255, (16, 3, 8, 6, 3))
                             .astype(np.float32))
    flip = tc.TrainSpec(augment=True, seed=3)
    a = train.augment_clips(clips, flip, 7)
    assert torch.equal(a, train.augment_clips(clips, flip, 7))
    assert not torch.equal(a, train.augment_clips(clips, flip, 8))
    flipped = [torch.equal(a[i], clips[i].flip(2)) for i in range(16)]
    kept = [torch.equal(a[i], clips[i]) for i in range(16)]
    assert all(f or k for f, k in zip(flipped, kept))
    assert 0 < sum(flipped) < 16
    bright = tc.TrainSpec(brightness_jitter=0.5, seed=3)
    b = train.augment_clips(clips, bright, 7)
    assert float(b.min()) >= 0 and float(b.max()) <= 255
    ratio = b / clips
    for i in range(16):
        inner = clips[i] * 1.5 < 255
        r = ratio[i][inner]
        assert float(r.max() - r.min()) < 1e-5
        assert 0.5 - 1e-6 <= float(r.mean()) <= 1.5 + 1e-6
    assert (b == 255).any()


def test_eval_step_and_variables_from_state(ref):
    model, state, _step = _port(ref)
    ev = train.make_eval_step(model)
    torch.testing.assert_close(ev(state, ref["data"]),
                               model.predict_clips(ref["data"]["clips"]))
    assert train.variables_from_state(state).keys() == \
        model.state_dict().keys()


# -- fit ------------------------------------------------------------------------

def _fit_config(**kw):
    _, tcfg = _configs("float32")
    return dataclasses.replace(
        tcfg, train=tc.TrainSpec(batch_size=2, learning_rate=1e-3, **kw))


def test_fit_on_synthetic_affwild2(tmp_path):
    """``fit`` for an epoch with eval: metrics rows (file and return), a
    checkpoint with its backbone meta, the best-val directory, the cosine
    horizon in ``<ckpt>.plan.json``; a resume continues the step count and
    keeps that horizon while the step is inside it, and extends it once
    the step has passed it."""
    root = str(tmp_path / "aff")
    datasets.make_synthetic_affwild2(root, n_videos=2, frames=6, size=S)
    cfg = _fit_config(lr_schedule="cosine", warmup_steps=1)
    ds = datasets.AffWild2Dataset(root, clip=cfg.clip)
    assert len(ds) == 4                 # windows 0 and 2 per 6-frame video
    ckpt = str(tmp_path / "ckpt")
    plan = ckpt + ".plan.json"
    state, rows = train.fit(cfg, ds, ckpt=ckpt, eval_dataset=ds, epochs=1,
                            device="cpu")
    assert state.step == 2 and rows[0]["steps"] == 2 and rows[0]["best"]
    assert np.isfinite(rows[0]["loss"]) and "val_mean_ccc" in rows[0]
    with open(ckpt + ".metrics.jsonl") as f:
        assert [json.loads(line) for line in f] == rows
    assert checkpoints.latest_step(ckpt) == 2
    assert checkpoints.latest_step(ckpt + "_best") == 2
    for d in (ckpt, ckpt + "_best"):
        assert checkpoints.load_backbone_meta(d) == {
            "mean_rgb": list(cfg.backbone.mean_rgb), "channel_order": "rgb"}
    with open(plan) as f:
        assert json.load(f) == {"total_steps": 2}
    for saved, horizon, step in ((10, 10, 4), (3, 6, 6)):
        with open(plan, "w") as f:
            json.dump({"total_steps": saved}, f)
        state, _ = train.fit(cfg, ds, ckpt=ckpt, resume=True, epochs=1,
                             device="cpu")
        with open(plan) as f:
            assert json.load(f) == {"total_steps": horizon}
        assert state.step == step and checkpoints.latest_step(ckpt) == step
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
            train.lr_schedule(cfg.train, horizon)(step), abs=1e-12)


def test_fit_rejects_too_few_clips_and_bad_eval_every(tmp_path):
    root = str(tmp_path / "aff")
    datasets.make_synthetic_affwild2(root, n_videos=1, frames=6, size=S)
    cfg = dataclasses.replace(_fit_config(), train=tc.TrainSpec(batch_size=4))
    ds = datasets.AffWild2Dataset(root, clip=cfg.clip)
    with pytest.raises(ValueError, match="fewer than one batch"):
        train.fit(cfg, ds, device="cpu")
    with pytest.raises(ValueError, match="eval_every"):
        train.fit(_fit_config(), ds, eval_every=0, device="cpu")
