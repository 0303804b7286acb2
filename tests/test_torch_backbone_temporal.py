"""Port backbone (BN-folded ResNet-50) and temporal model vs the JAX
package in f32 on the CPU, with weights carried over by
``weights.from_jax_variables``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimamo_tpu import backbone as jbackbone
from mimamo_tpu import preprocess as jpre
from mimamo_tpu import temporal as jtemporal
from mimamo_tpu.config import BackboneSpec as JBackboneSpec
from mimamo_tpu.config import TemporalSpec as JTemporalSpec
from mimamo_tpu_torch import backbone as tbackbone
from mimamo_tpu_torch import temporal as ttemporal
from mimamo_tpu_torch import weights
from mimamo_tpu_torch.config import BackboneSpec, MimamoConfig, TemporalSpec


def _randomize_bn(variables, seed):
    """Replace the BN affine params and running stats (identity at flax
    init) with random ones, so folding has something to fold."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        names = [getattr(p, "key", "") for p in path]
        if not any(n.startswith(("bn", "downsample_bn")) for n in names):
            return np.asarray(x)
        shape = np.shape(x)
        if names[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def resnet_pair():
    spec = JBackboneSpec(dtype="float32", input_size=64)
    variables = jbackbone.ResNet50(spec).init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 64, 64, 3)))
    variables = _randomize_bn(jax.tree_util.tree_map(np.asarray, variables),
                              seed=0)
    model = tbackbone.ResNet50(BackboneSpec(input_size=64))
    model.load_state_dict(weights.backbone_from_jax(variables))
    return spec, variables, model


def test_fold_batchnorm_matches_jax(resnet_pair):
    _spec, variables, model = resnet_pair
    want = jbackbone.fold_batchnorm(variables)["params"]
    got = tbackbone.fold_batchnorm(model)
    for tkey, jpath in (("conv1", ("conv1",)),
                        ("layer2.0.downsample", ("layer2_0",
                                                 "downsample_conv")),
                        ("layer4.2.conv2", ("layer4_2", "conv2"))):
        node = want
        for p in jpath:
            node = node[p]
        w, b = got[tkey]
        np.testing.assert_allclose(w.permute(2, 3, 1, 0).numpy(),
                                   np.asarray(node["kernel"]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(b.numpy(), np.asarray(node["bias"]),
                                   rtol=1e-6, atol=1e-6)
    assert len(got) == 1 + 1 + 3 * 16 + 4        # conv1, fc, convs, proj


@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_folded_resnet_matches_jax_f32(resnet_pair, order):
    """Embedding and logits of the folded ResNet-50 on 32^2 crops (the
    backbone sees the 64^2 upscale) vs JAX ``ResNet50(fused_bn=True)`` on
    ``for_backbone`` of the same crops: atol 2e-4, rtol 1e-3
    (tests/test_backbone.py)."""
    spec, variables, model = resnet_pair
    jspec = JBackboneSpec(dtype="float32", input_size=64,
                          channel_order=order)
    rng = np.random.default_rng(1)
    crops = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    fused = jbackbone.ResNet50(jspec, fused_bn=True)
    want_emb, want_logits = fused.apply(
        jbackbone.fold_batchnorm(variables),
        jpre.for_backbone(jnp.asarray(crops), jspec))
    folded = tbackbone.FoldedResNet50(
        tbackbone.fold_batchnorm(model),
        BackboneSpec(input_size=64, channel_order=order))
    with torch.no_grad():
        got_emb, got_logits = folded(torch.from_numpy(crops))
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=2e-4, rtol=1e-3)


def test_folded_resnet_rejects_non_2x_crops(resnet_pair):
    _spec, _variables, model = resnet_pair
    folded = tbackbone.FoldedResNet50(tbackbone.fold_batchnorm(model),
                                      BackboneSpec(input_size=64))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        folded(torch.zeros((1, 64, 64, 3)))


SMALL_TEMPORAL = dict(micro_cnn_features=(8, 16), micro_embed_dim=16,
                      macro_embed_dim=16, gru_hidden=16, fusion_hidden=16)


@pytest.mark.parametrize("activation", ["linear", "tanh"])
def test_two_stream_rnn_matches_jax_f32(activation):
    """TwoStreamRNN in f32 vs JAX ``TwoStreamRNN.apply``: atol 1e-5."""
    b, t, c, p, f = 2, 5, 4, 16, 32
    jspec = JTemporalSpec(output_activation=activation, **SMALL_TEMPORAL)
    rng = np.random.default_rng(2)
    phases = rng.uniform(-np.pi, np.pi, (b, t - 1, c, p, p)).astype(
        np.float32)
    feats = rng.standard_normal((b, t, f)).astype(np.float32)
    jmodel = jtemporal.TwoStreamRNN(jspec)
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(phases),
                            jnp.asarray(feats))
    variables = _randomize_bn(jax.tree_util.tree_map(np.asarray, variables),
                              seed=3)
    want, _carries = jmodel.apply(variables, jnp.asarray(phases),
                                  jnp.asarray(feats))
    tmodel = ttemporal.TwoStreamRNN(
        TemporalSpec(output_activation=activation, **SMALL_TEMPORAL), c, p,
        f).eval()
    tmodel.load_state_dict(weights.temporal_from_jax(variables))
    with torch.no_grad():
        got, _carries = tmodel(torch.from_numpy(phases),
                               torch.from_numpy(feats))
    assert got.shape == (b, t, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_unported_temporal_options_raise():
    for kw in ({"streams": "micro"}, {"gru_layers": 2}, {"snippet_len": 4}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TemporalSpec(**kw)


def test_init_variables_is_seeded():
    cfg = MimamoConfig(temporal=TemporalSpec(**SMALL_TEMPORAL))
    a, b = weights.init_variables(cfg, 0), weights.init_variables(cfg, 0)
    c = weights.init_variables(cfg, 1)
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.conv1.weight"],
                           c["backbone.conv1.weight"])
    assert (a["backbone.layer1.0.bn1.running_var"] > 0).all()
