"""Each kernel's plain version (what the wrapper runs for CPU tensors) vs
the JAX package's Pallas kernel, run as the JAX tests run it on the CPU
(``interpret=True``). The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimamo_tpu import backbone as jbackbone
from mimamo_tpu.config import BackboneSpec as JBackboneSpec
from mimamo_tpu.config import PhaseSpec as JPhaseSpec
from mimamo_tpu.config import PyramidSpec as JPyramidSpec
from mimamo_tpu.pallas import layer2_kernel as jl2
from mimamo_tpu.pallas import phase_kernel as jphk
from mimamo_tpu.pallas import stem_kernel as jstem
from mimamo_tpu_torch import backbone as tbackbone
from mimamo_tpu_torch import weights
from mimamo_tpu_torch.config import BackboneSpec, PhaseSpec, PyramidSpec
from mimamo_tpu_torch.kernels import layer2_kernel as tl2
from mimamo_tpu_torch.kernels import phase_kernel as tphk
from mimamo_tpu_torch.kernels import stem_kernel as tstem


def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# -- phase difference + resize ---------------------------------------------

@pytest.mark.parametrize("weighting", [False, True])
def test_phase_diff_resize_matches_pallas(weighting):
    """atol 1e-4, at the shapes of tests/test_pallas.py (leading dims not a
    multiple of the Pallas block). The port takes the whole band and forms
    the (t, t-1) pairs itself."""
    rng = np.random.default_rng(2)
    band = _complex(rng, (3, 6, 2, 32, 32))
    want = np.asarray(jphk.phase_diff_resize_blocked(
        jnp.asarray(band[:, 1:]), jnp.asarray(band[:, :-1]), phase_size=48,
        block=8, interpret=True, amplitude_weighting=weighting))
    out = torch.zeros((3, 5, 4, 48, 48))
    tphk.phase_diff_resize(torch.from_numpy(band), out, 1, weighting)
    np.testing.assert_allclose(out[:, :, 1:3].numpy(), want, atol=1e-4,
                               rtol=0)
    assert not out[:, :, 0].any() and not out[:, :, 3].any()


@pytest.mark.parametrize("weighting", [False, True])
def test_micro_motion_fused_matches_pallas(weighting):
    """The whole fused micro path, atol 1e-3 (tests/test_pallas.py)."""
    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 255, (1, 5, 64, 64)).astype(np.float32)
    want = np.asarray(jphk.micro_motion_features_fused(
        jnp.asarray(frames),
        JPyramidSpec(height=3, orientations=4, input_size=(64, 64),
                     fft_mode="fft"),
        JPhaseSpec(phase_size=48, amplitude_weighting=weighting),
        interpret=True))
    got = tphk.micro_motion_features_fused(
        torch.from_numpy(frames),
        PyramidSpec(height=3, orientations=4, input_size=(64, 64)),
        PhaseSpec(phase_size=48, amplitude_weighting=weighting)).numpy()
    assert got.shape == want.shape == (1, 4, 12, 48, 48)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_phase_wrapper_rejects_bad_shapes():
    band = torch.zeros((1, 3, 2, 8, 8), dtype=torch.complex64)
    with pytest.raises(ValueError):
        tphk.phase_diff_resize(band.real.contiguous(),
                               torch.zeros((1, 2, 2, 4, 4)), 0, False)
    with pytest.raises(ValueError):          # channel range past C
        tphk.phase_diff_resize(band, torch.zeros((1, 2, 2, 4, 4)), 1, False)
    with pytest.raises(ValueError):          # T-1 mismatch
        tphk.phase_diff_resize(band, torch.zeros((1, 3, 2, 4, 4)), 0, False)
    with pytest.raises(ValueError):          # a single frame has no pair
        tphk.phase_diff_resize(band[:, :1], torch.zeros((1, 0, 2, 4, 4)), 0,
                               False)


# -- stem ------------------------------------------------------------------

def _stem_inputs():
    rng = np.random.default_rng(0)
    crops = rng.uniform(0, 255, (2, 112, 112, 3)).astype(np.float32)
    k7 = rng.normal(0, 0.05, (7, 7, 3, 64)).astype(np.float32)    # HWIO
    b = rng.normal(0, 0.1, (64,)).astype(np.float32)
    return crops, k7, b


def _port_stem(crops, k7, b, order, dtype):
    w2, bias = tstem.prepare_stem_weights(
        torch.from_numpy(k7.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(b), order, dtype)
    return tstem.stem_fused(torch.from_numpy(crops), w2, bias,
                            JBackboneSpec().mean_rgb)


@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_stem_matches_pallas_f32(order):
    """atol 1e-3 in f32 (tests/test_pallas.py)."""
    crops, k7, b = _stem_inputs()
    w2, b2 = jstem.prepare_stem_weights(jnp.asarray(k7), jnp.asarray(b),
                                        channel_order=order,
                                        dtype=jnp.float32)
    want = np.asarray(jstem.stem_fused(
        jstem.prepare_stem_input(jnp.asarray(crops),
                                 JBackboneSpec().mean_rgb),
        w2, b2, dtype=jnp.float32, interpret=True))
    got = _port_stem(crops, k7, b, order, torch.float32).numpy()
    assert got.shape == want.shape == (2, 56, 56, 64)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_stem_matches_pallas_bf16():
    """bf16 operands, f32 accumulation: max-rel < 2e-2."""
    crops, k7, b = _stem_inputs()
    w2, b2 = jstem.prepare_stem_weights(jnp.asarray(k7), jnp.asarray(b),
                                        dtype=jnp.bfloat16)
    want = np.asarray(jstem.stem_fused(
        jstem.prepare_stem_input(jnp.asarray(crops),
                                 JBackboneSpec().mean_rgb),
        w2, b2, dtype=jnp.bfloat16, interpret=True), np.float32)
    got = _port_stem(crops, k7, b, "rgb", torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-2


@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_stem_general_crop_size_matches_xla_chain(order):
    """Even crops other than 112 (the CPU end-to-end test runs S = 32): the
    port's stem == the JAX reference chain for_backbone -> conv1 -> relu ->
    max_pool in f32 (the chain of tests/test_pallas.py), atol 1e-3."""
    import flax.linen as nn
    from mimamo_tpu import preprocess as jpre
    rng = np.random.default_rng(5)
    crops = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    k7 = rng.normal(0, 0.05, (7, 7, 3, 64)).astype(np.float32)
    b = rng.normal(0, 0.1, (64,)).astype(np.float32)
    spec = JBackboneSpec(dtype="float32", input_size=64, channel_order=order)
    y = jax.lax.conv_general_dilated(
        jpre.for_backbone(jnp.asarray(crops), spec), jnp.asarray(k7),
        (2, 2), [(3, 3), (3, 3)], dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = np.asarray(nn.max_pool(nn.relu(y + b), (3, 3), strides=(2, 2),
                                  padding=((1, 1), (1, 1))))
    got = _port_stem(crops, k7, b, order, torch.float32).numpy()
    assert got.shape == want.shape == (2, 16, 16, 64)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_stem_wrapper_rejects_bad_shapes():
    w2, bias = torch.zeros((147, 64)), torch.zeros(64)
    mean = (0.0, 0.0, 0.0)
    for shape in [(1, 31, 31, 3), (1, 6, 6, 3), (1, 32, 16, 3),
                  (1, 32, 32, 4)]:
        with pytest.raises(ValueError):
            tstem.stem_fused(torch.zeros(shape), w2, bias, mean)
    with pytest.raises(ValueError):
        tstem.stem_fused(torch.zeros((1, 32, 32, 3)), torch.zeros((64, 147)),
                         bias, mean)


# -- layer2 ----------------------------------------------------------------

@pytest.fixture(scope="module")
def layer2_params():
    """Random JAX backbone variables, folded by each package."""
    full = jbackbone.ResNet50(JBackboneSpec(dtype="bfloat16"))
    variables = full.init(jax.random.PRNGKey(4), jnp.zeros((1, 64, 64, 3)))
    jfolded = jbackbone.fold_batchnorm(variables)
    sd = weights.backbone_from_jax(
        jax.tree_util.tree_map(np.asarray, variables))
    model = tbackbone.ResNet50(BackboneSpec())
    model.load_state_dict(sd)
    return jfolded, tbackbone.fold_batchnorm(model)


def test_layer2_matches_pallas(layer2_params):
    """max-rel < 2e-2 at N = 2 (tests/test_backbone.py): bf16 operands,
    f32 accumulation, the same rounding points."""
    jfolded, tfolded = layer2_params
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 56, 56, 256)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jl2.layer2_fused(
        xb, jl2.pack_layer2_params(jfolded["params"]), interpret=True),
        np.float32)
    got = tl2.layer2_fused(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16),
        tl2.pack_layer2_params(tfolded, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == want.shape == (2, 28, 28, 512)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-2


def test_layer2_general_spatial_size(layer2_params):
    """[N, 2H, 2W, 256] -> [N, H, W, 512] at a size the Pallas kernel
    does not take, vs the JAX XLA layer2 segment in f32 (atol 2e-4, rtol
    1e-3: f32 throughout, so the bf16 rounding points are identities)."""
    jfolded, tfolded = layer2_params
    seg = jbackbone.ResNet50(JBackboneSpec(), fused_bn=True, skip_stem=True,
                             stages=(1,), features_only=True)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 16, 12, 256)).astype(np.float32)
    want = np.asarray(seg.apply(jfolded, jnp.asarray(x)))
    got = tl2.layer2_fused(torch.from_numpy(x),
                           tl2.pack_layer2_params(tfolded, torch.float32))
    assert got.shape == want.shape == (1, 8, 6, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)


def test_layer2_wrapper_rejects_bad_shapes(layer2_params):
    _j, tfolded = layer2_params
    blocks = tl2.pack_layer2_params(tfolded, torch.float32)
    for shape in [(1, 16, 16, 128), (1, 15, 16, 256), (1, 16, 16)]:
        with pytest.raises(ValueError):
            tl2.layer2_fused(torch.zeros(shape), blocks)
    with pytest.raises(ValueError):          # blocks in the wrong order
        tl2.layer2_fused(torch.zeros((1, 16, 16, 256)), blocks[::-1])
    with pytest.raises(ValueError):          # dtype mismatch
        tl2.layer2_fused(torch.zeros((1, 16, 16, 256), dtype=torch.bfloat16),
                         blocks)
