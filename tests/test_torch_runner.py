"""The slice as a whole: port ``Mimamo(cfg, device="cpu").predict_clips``
and ``predict_from_crops`` vs the JAX ``Mimamo(cfg)`` with the same
weights (``weights.from_jax_variables``) and the same uint8 clips."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimamo_tpu import config as jc
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import config as tc
from mimamo_tpu_torch import weights
from mimamo_tpu_torch.runner import Mimamo

# crop 32 -> backbone input 64; 2 scales x 2 orientations; B = 1, T = 4
B, T, S = 1, 4, 32


def _configs(dtype):
    jcfg = jc.MimamoConfig(
        pyramid=jc.PyramidSpec(height=2, orientations=2, input_size=(S, S)),
        phase=jc.PhaseSpec(phase_size=16),
        backbone=jc.BackboneSpec(input_size=2 * S, dtype=dtype),
        clip=jc.ClipSpec(clip_len=T, stride=2, crop_size=S))
    tcfg = tc.MimamoConfig(
        pyramid=tc.PyramidSpec(height=2, orientations=2, input_size=(S, S)),
        phase=tc.PhaseSpec(phase_size=16),
        backbone=tc.BackboneSpec(input_size=2 * S, dtype=dtype),
        clip=tc.ClipSpec(clip_len=T, stride=2, crop_size=S))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def case():
    """JAX references, computed once: the same weights and clips through
    the JAX package in f32 and in bf16."""
    clips = np.random.default_rng(0).integers(0, 256, (B, T, S, S, 3),
                                              dtype=np.uint8)
    jcfg, _ = _configs("float32")
    variables = jax.tree_util.tree_map(
        np.asarray, JaxMimamo(jcfg).init_variables(jax.random.PRNGKey(0),
                                                   clip_len=T))
    ref = {}
    for dtype in ("float32", "bfloat16"):
        jm = JaxMimamo(_configs(dtype)[0])
        ref[dtype] = np.asarray(jm.predict_clips(variables,
                                                 jnp.asarray(clips)))
        ref[dtype + "_emb"] = np.asarray(jm.embed_frames(
            variables, jnp.asarray(clips, jnp.float32)))
    ref["variables"] = variables
    return clips, weights.from_jax_variables(variables), ref


def _port(dtype, state):
    model = Mimamo(_configs(dtype)[1], device="cpu")
    model.load_state_dict(state)
    return model


def _max_rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_predict_clips_matches_jax_f32(case):
    """f32: atol 1e-3 (measured max |d| 1.4e-6)."""
    clips, state, ref = case
    got = _port("float32", state).predict_clips(clips)
    assert got.shape == (B, T, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref["float32"], atol=1e-3,
                               rtol=0)


def test_predict_clips_matches_jax_bf16(case):
    """bf16 backbone: max|d| / max|ref| < 5e-2 (measured 2.9e-2).

    The two packages round the bf16 ResNet at different points (the JAX
    path runs its composite stem with a bf16 mean subtraction and bf16
    XLA convs; the port follows the stem and layer2 kernels' fp32 points),
    and with random weights the temporal model amplifies the <1%
    embedding differences; the JAX package's own bf16 output is 1.3e-2
    from its f32 output on these inputs."""
    clips, state, ref = case
    got = _port("bfloat16", state).predict_clips(clips).numpy()
    assert _max_rel(got, ref["bfloat16"]) < 5e-2


def test_embed_frames_matches_jax_bf16(case):
    """The bf16 pool5 embeddings themselves: max-rel < 2e-2 (measured
    8.7e-3; one bf16 rounding is up to 2^-9 = 2e-3 relative)."""
    clips, state, ref = case
    with torch.no_grad():
        got = _port("bfloat16", state).embed_frames(
            torch.from_numpy(clips).float()).numpy()
    assert got.shape == (B, T, 2048)
    assert _max_rel(got, ref["bfloat16_emb"]) < 2e-2


def test_uint8_and_float_feeds_agree(case):
    """The uint8 feed is cast to float32 inside the forward: integral
    float input gives the identical result."""
    clips, state, _ref = case
    model = _port("float32", state)
    a = model.predict_clips(clips)
    b = model.predict_clips(torch.from_numpy(clips.astype(np.float32)))
    assert torch.equal(a, b)


def test_predict_clips_rejects_bad_shapes(case):
    _clips, state, _ref = case
    model = _port("float32", state)
    for shape in [(B, T, S, S), (B, T, S + 2, S + 2, 3), (B, 1, S, S, 3)]:
        with pytest.raises(ValueError):
            model.predict_clips(np.zeros(shape, np.uint8))


@pytest.mark.parametrize("frames", [9, 3, 4])
def test_predict_from_crops_matches_jax(case, frames):
    """Windows of 4 at stride 2 in batches of 3, f32, atol 1e-5 vs the JAX
    ``predict_from_crops``: 9 frames (4 windows, the last right-aligned, the
    second batch padded by repeats), 3 frames (padded to one clip and
    trimmed back) and exactly one clip."""
    _clips, state, ref = case
    crops = np.random.default_rng(frames).integers(
        0, 256, (frames, S, S, 3), dtype=np.uint8)
    want = JaxMimamo(_configs("float32")[0]).predict_from_crops(
        ref["variables"], crops, batch_clips=3)
    model = _port("float32", state)
    got = model.predict_from_crops(crops, batch_clips=3)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (frames, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    same = model.predict_from_crops(torch.from_numpy(crops), batch_clips=3)
    np.testing.assert_array_equal(same, got)


def test_predict_from_crops_t_real_trims(case):
    """``t_real`` below one clip trims the series: the caller padded the
    short video to ``clip_len`` itself."""
    _clips, state, _ref = case
    model = _port("float32", state)
    crops = np.random.default_rng(1).integers(0, 256, (T, S, S, 3),
                                              dtype=np.uint8)
    full = model.predict_from_crops(crops, batch_clips=2)
    np.testing.assert_array_equal(
        model.predict_from_crops(crops, t_real=3, batch_clips=2), full[:3])
