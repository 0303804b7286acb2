"""bf16 fine-tuning: the train-mode BatchNorm on bf16 activations against
Flax's ``nn.BatchNorm(dtype=bfloat16)``, the bf16 fine-tune step against
the JAX package's bf16 step, one train-mode bottleneck's gradient against
JAX's, and ``cli train --dtype bfloat16 --finetune-backbone`` on the CPU.

Tolerances, measured on these inputs:
  * BatchNorm: outputs within one bf16 ulp (rtol 2^-7; one element of 3136
    differed, by 9.5e-7: the fp32 sums run in another order), running
    stats atol 1e-6 (4.8e-7); in inference mode equal.
  * The step at ``tests/test_torch_train.py``'s fixture (crops of 32,
    backbone input 64, one step with remat, lr 1e-4): the train-mode
    backbone there is ill-conditioned (the JAX package's own bf16 step
    moves the loss by 1.0e-2 and the BN running stats by up to 0.13
    max-rel from its fp32 step), so the port's bf16 step is held to JAX's
    where rounding has not been amplified yet: the running stats of the
    stem's BN and of layer1 max-rel <= 1e-3 (measured 3.9e-4; the stem
    BN's batch mean of JAX's fp32 backbone is 3.2e-3 from its bf16 one's),
    every backbone BN stat max-rel <= 0.25 (0.13), the loss atol 2e-2
    (6.0e-5; 1.1e-2 with a BatchNorm written out in elementwise ops, of
    the same arithmetic: the loss at this size moves that much with
    rounding).
  * One train-mode layer2 block 0 on 8 x 28^2 x 256 (well conditioned:
    JAX's bf16 block agrees with its fp32 block at cosine 0.997): the
    gradient of a fixed linear functional of its output, in both stride
    placements, cosine >= 0.99 and norms within 1% of JAX's bf16 block
    (measured 0.99992 / 0.99979 and 1.00002 / 0.99999).
"""

import dataclasses
import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimamo_tpu import backbone as jbackbone
from mimamo_tpu import preprocess as jpre
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import backbone as tbackbone
from mimamo_tpu_torch import (api, checkpoints, cli, preprocess, train,
                              weights)
from mimamo_tpu_torch import config as tc
from mimamo_tpu_torch.batchnorm import BatchNorm2d
from mimamo_tpu_torch.data import datasets
from mimamo_tpu_torch.runner import Mimamo

from test_torch_runner import T, _configs
from test_torch_serve import CLIP, S, SMALL_FLAGS, small_configs
from test_torch_train import LR, _batch, _jax_steps, _train_specs


@pytest.fixture(scope="module", autouse=True)
def two_intra_op_threads():
    """Two intra-op threads for this module and the modules that import
    this fixture: beside other test processes the default (one per core,
    in every process) spends its time waiting on the others' threads
    (measured here: a one-step bf16 ``cli train`` 2 s alone, 83 s among 6
    test processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bn_case(rng, c=16):
    return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.normal(size=c).astype(np.float32),
            "mean": rng.normal(size=c).astype(np.float32),
            "var": rng.uniform(0.5, 2, c).astype(np.float32)}


def test_batchnorm_bf16_matches_flax():
    """Training mode (batch statistics, running-stat update) and inference
    mode on bf16 activations: bf16 out, fp32 running stats."""
    rng = np.random.default_rng(0)
    p = _bn_case(rng)
    x = (rng.normal(size=(4, 7, 7, 16)) * 3 + 1).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    v = {"params": {"scale": p["scale"], "bias": p["bias"]},
         "batch_stats": {"mean": p["mean"], "var": p["var"]}}
    want, mut = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                              epsilon=1e-5, dtype=jnp.bfloat16).apply(
        v, xj, mutable=["batch_stats"])
    bn = BatchNorm2d(16)
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(p[key]))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).permute(
        0, 3, 1, 2).to(torch.bfloat16)
    got = bn.train()(xt).detach()
    assert got.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    np.testing.assert_allclose(
        got.float().permute(0, 2, 3, 1).numpy(),
        np.asarray(want.astype(jnp.float32)), rtol=2 ** -7, atol=1e-6)
    for ours, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(ours.numpy(),
                                   np.asarray(mut["batch_stats"][key]),
                                   atol=1e-6, rtol=0)
    want_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                              epsilon=1e-5, dtype=jnp.bfloat16).apply(
        {"params": v["params"], "batch_stats": mut["batch_stats"]}, xj)
    with torch.no_grad():
        got_eval = bn.eval()(xt)
    np.testing.assert_allclose(
        got_eval.float().permute(0, 2, 3, 1).numpy(),
        np.asarray(want_eval.astype(jnp.float32)), rtol=2 ** -7, atol=1e-6)


def test_for_backbone_bf16_is_the_jax_chain():
    """At the exact 2x, a bf16 spec's backbone input is the JAX package's
    bf16 cast, upscale and mean subtraction, bit for bit."""
    crops = np.random.default_rng(2).uniform(0, 255, (3, 16, 16, 3)).astype(
        np.float32)
    for order in ("rgb", "bgr"):
        _, tcfg = _configs("bfloat16")
        spec = dataclasses.replace(tcfg.backbone, channel_order=order)
        jspec = dataclasses.replace(_configs("bfloat16")[0].backbone,
                                    channel_order=order)
        got = preprocess.for_backbone(torch.from_numpy(crops), spec)
        want = jpre.for_backbone(jnp.asarray(crops), jspec)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.fixture(scope="module")
def steps():
    """The JAX package's bf16 fine-tune step (remat) from its fp32 init,
    and the port's from the same weights and batch."""
    jcfg, _ = _configs("float32")
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(functools.partial(
            JaxMimamo(jcfg).init_variables, clip_len=T))(
            jax.random.PRNGKey(0)))
    batch = _batch()
    js, _ = _train_specs(freeze_backbone=False)
    jbf, tbf = _configs("bfloat16")
    want = _jax_steps(dataclasses.replace(jbf, train=js), variables, batch,
                      1)[0]
    model = Mimamo(dataclasses.replace(tbf, train=tc.TrainSpec(
        learning_rate=LR, freeze_backbone=False, remat_backbone=True)),
        device="cpu")
    model.load_state_dict(weights.from_jax_variables(variables))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pred_before = model.predict_clips(batch["clips"][:1])
    state = train.create_train_state(model)
    _, metrics = train.make_train_step(model)(state, batch)
    return {"want": want, "model": model, "before": before,
            "pred_before": pred_before, "metrics": metrics, "batch": batch}


def test_bf16_finetune_step_matches_jax(steps):
    """Loss, and the backbone BN running stats (module docstring)."""
    model, want = steps["model"], steps["want"]
    assert abs(float(steps["metrics"]["loss"])
               - want["metrics"]["loss"]) <= 2e-2
    got = model.state_dict()
    early = 0.0
    for k, v in want["state"].items():
        if not (k.startswith("backbone.") and "running" in k):
            continue
        rel = float((got[k] - v).abs().max() / v.abs().max())
        assert got[k].dtype == torch.float32 and rel <= 0.25, k
        if k.startswith(("backbone.bn1.", "backbone.layer1.")):
            early = max(early, rel)
    assert early <= 1e-3


def test_bf16_finetune_step_moves_fp32_weights_and_refolds(steps):
    """The parameters and their gradients stay fp32 and move; the step
    drops the folded copy, so ``predict_clips`` runs the new weights."""
    model, before = steps["model"], steps["before"]
    for name, p in model.backbone.named_parameters():
        if not name.startswith("fc."):          # the logits feed no loss
            assert p.dtype == p.grad.dtype == torch.float32, name
    for k in ("backbone.conv1.weight", "backbone.layer2.0.conv2.weight",
              "backbone.layer4.2.bn3.running_var"):
        assert not torch.equal(model.state_dict()[k], before[k]), k
    after = model.predict_clips(steps["batch"]["clips"][:1])
    assert torch.isfinite(after).all()
    assert not torch.equal(after, steps["pred_before"])


def _block_sd(params, stats):
    """A JAX ``Bottleneck``'s variables -> the port block's state_dict."""
    def conv(k):
        return torch.from_numpy(np.asarray(k).transpose(3, 2, 0, 1).copy())
    sd = {f"conv{i}.weight": conv(params[f"conv{i}"]["kernel"])
          for i in (1, 2, 3)}
    sd["downsample.0.weight"] = conv(params["downsample_conv"]["kernel"])
    for ours, theirs in (("bn1", "bn1"), ("bn2", "bn2"), ("bn3", "bn3"),
                         ("downsample.1", "downsample_bn")):
        for a, b, tree in (("weight", "scale", params),
                           ("bias", "bias", params),
                           ("running_mean", "mean", stats),
                           ("running_var", "var", stats)):
            sd[f"{ours}.{a}"] = torch.from_numpy(np.array(tree[theirs][b]))
    return sd


@pytest.mark.parametrize("stride_in_1x1", [True, False],
                         ids=["caffe", "torchvision"])
def test_bf16_bottleneck_gradient_matches_jax(stride_in_1x1):
    """One train-mode bf16 layer2 block 0 (8 x 28^2 x 256 -> 14^2 x 512):
    the gradient of sum(out * g) over its convs, BN scales and biases."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 28, 28, 256)).astype(np.float32)
    g = rng.normal(size=(8, 14, 14, 512)).astype(np.float32)
    block = jbackbone.Bottleneck(128, 2, stride_in_1x1, jnp.bfloat16)
    v = jax.tree_util.tree_map(np.asarray, block.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 256))))

    def loss(params):
        y, _ = block.apply({"params": params,
                            "batch_stats": v["batch_stats"]},
                           jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * g)

    jg = jax.jit(jax.grad(loss))(v["params"])
    ours = tbackbone.Bottleneck(256, 128, 2, stride_in_1x1)
    ours.load_state_dict(_block_sd(v["params"], v["batch_stats"]),
                         strict=False)
    y = ours.train()(torch.from_numpy(x).permute(0, 3, 1, 2).to(
        torch.bfloat16))
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    pairs = [(f"conv{i}.weight", (f"conv{i}", "kernel"))
             for i in (1, 2, 3)] + [
        ("downsample.0.weight", ("downsample_conv", "kernel"))] + [
        (f"{o}.{a}", (t, b)) for o, t in (("bn1", "bn1"), ("bn2", "bn2"),
                                          ("bn3", "bn3"),
                                          ("downsample.1", "downsample_bn"))
        for a, b in (("weight", "scale"), ("bias", "bias"))]
    params = dict(ours.named_parameters())
    a = np.concatenate([params[k].grad.numpy().ravel() for k, _ in pairs])
    b = np.concatenate([
        (np.asarray(jg[m][n]).transpose(3, 2, 0, 1) if n == "kernel"
         else np.asarray(jg[m][n])).ravel() for _, (m, n) in pairs])
    cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
    assert cos >= 0.99 and abs(np.linalg.norm(a) / np.linalg.norm(b) - 1) \
        <= 1e-2


@pytest.mark.parametrize("extra", [[], ["--data-parallel"]],
                         ids=["one-process", "data-parallel"])
def test_cli_train_bf16_finetune(extra, tmp_path, capsys):
    """``cli train --dtype bfloat16 --finetune-backbone --cpu`` takes its
    step (alone and as a world of one: 2 clips, one batch) and writes a
    checkpoint whose backbone moved from the initial weights."""
    root = str(tmp_path / "aff")
    datasets.make_synthetic_affwild2(root, n_videos=2, frames=CLIP, size=S,
                                     seed=6)
    ckpt = str(tmp_path / "ckpt")
    cli.main(["train", "--dataset", "affwild2", "--root", root, "--ckpt",
              ckpt, "--batch", "2", "--finetune-backbone", "--dtype",
              "bfloat16"] + extra + SMALL_FLAGS + ["--cpu"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["steps"] == 1 and np.isfinite(row["loss"])
    assert checkpoints.latest_step(ckpt) == row["steps"]
    cfg = small_configs()[1]
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype="bfloat16"))
    trained = api.MimamoAPI(config=cfg, checkpoint_dir=ckpt,
                            device="cpu").model.state_dict()
    init = weights.init_variables(cfg, 0)
    for k in ("backbone.conv1.weight", "backbone.layer3.0.conv2.weight"):
        assert trained[k].dtype == torch.float32
        assert not torch.equal(trained[k], init[k]), k
