"""Port pyramid / phase / preprocessing vs the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimamo_tpu import phase as jphase
from mimamo_tpu import preprocess as jpre
from mimamo_tpu import pyramid as jpyr
from mimamo_tpu.config import PhaseSpec as JPhaseSpec
from mimamo_tpu.config import PyramidSpec as JPyramidSpec
from mimamo_tpu_torch import phase as tphase
from mimamo_tpu_torch import preprocess as tpre
from mimamo_tpu_torch import pyramid as tpyr
from mimamo_tpu_torch.config import PhaseSpec, PyramidSpec

SPECS = [(3, 4, (64, 64)), (2, 2, (32, 32)), (3, 4, (112, 112)),
         (2, 3, (48, 64))]


def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("height,orient,size", SPECS)
def test_masks_equal_jax(height, orient, size):
    want = jpyr.make_masks(JPyramidSpec(height=height, orientations=orient,
                                        input_size=size))
    got = tpyr.make_masks(PyramidSpec(height=height, orientations=orient,
                                      input_size=size))
    assert got.keys() == want.keys()
    for key in want:
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (1, 2, 48, 64)])
def test_fft2_ifft2_shifted_match_jax(shape):
    """Both directions within max|d|/max|ref| <= 1e-5 (two FFT libraries
    in complex64)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, shape).astype(np.float32)
    spec = JPyramidSpec(input_size=shape[-2:], height=1, fft_mode="fft")
    want = np.asarray(jpyr.fft2_shifted(jnp.asarray(x), spec))
    got = tpyr.fft2_shifted(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5
    y = _complex(rng, shape)
    want = np.asarray(jpyr.ifft2_shifted(jnp.asarray(y), spec))
    got = tpyr.ifft2_shifted(torch.from_numpy(y)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_phase_diff_matches_jax_wrapped():
    """atan2 of the same products; a product whose angle sits at +-pi may
    flip by 2 pi between libraries, so compare the wrapped difference."""
    rng = np.random.default_rng(1)
    a, b = _complex(rng, (4, 16, 16)), _complex(rng, (4, 16, 16))
    want = np.asarray(jphase.phase_diff(jnp.asarray(a), jnp.asarray(b)))
    got = tphase.phase_diff(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    d = np.angle(np.exp(1j * (got.astype(np.float64) - want)))
    assert np.abs(d).max() <= 1e-5
    assert got.min() >= -np.pi and got.max() <= np.pi


@pytest.mark.parametrize("src,dst", [(112, 48), (28, 48), (7, 16), (48, 48)])
def test_resize_matrix_and_taps(src, dst):
    want = jphase._resize_matrix(src, dst)
    np.testing.assert_array_equal(tphase._resize_matrix(src, dst), want)
    idx, wts = tphase.resize_taps(src, dst)
    dense = np.zeros((dst, src), np.float64)
    for a in range(2):
        np.add.at(dense, (np.arange(dst), idx[:, a]), wts[:, a])
    np.testing.assert_allclose(dense, want, atol=1e-7, rtol=0)


def test_resize_bilinear_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 2, 28, 56)).astype(np.float32)
    want = np.asarray(jphase.resize_bilinear(jnp.asarray(x), (48, 40)))
    got = tphase.resize_bilinear(torch.from_numpy(x), (48, 40)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("weighting", [False, True])
def test_micro_motion_features_matches_jax(weighting):
    """Plain micro path, atol 1e-3 (the budget of tests/test_phase.py)."""
    pyr = (3, 4, (64, 64))
    rng = np.random.default_rng(3)
    frames = rng.uniform(0, 255, (1, 5, 64, 64)).astype(np.float32)
    want = np.asarray(jphase.micro_motion_features(
        jnp.asarray(frames),
        JPyramidSpec(*pyr, fft_mode="fft"),
        JPhaseSpec(phase_size=48, amplitude_weighting=weighting)))
    got = tphase.micro_motion_features(
        torch.from_numpy(frames), PyramidSpec(*pyr),
        PhaseSpec(phase_size=48, amplitude_weighting=weighting)).numpy()
    assert got.shape == want.shape == (1, 4, 12, 48, 48)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_grayscale_and_upscale_match_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 255, (2, 16, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tpre.to_grayscale(torch.from_numpy(x)).numpy(),
        np.asarray(jpre.to_grayscale(jnp.asarray(x))), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        tpre.upscale2x(torch.from_numpy(x)).numpy(),
        np.asarray(jpre.upscale2x(jnp.asarray(x))), atol=1e-4, rtol=0)


# -- sliding-window helpers ---------------------------------------------------

@pytest.mark.parametrize("t,clip_len,stride", [
    (120, 48, 24), (48, 48, 24), (49, 48, 24), (9, 4, 2), (10, 4, 3),
    (7, 7, 1)])
def test_window_helpers_equal_jax(t, clip_len, stride):
    """Integer starts, gathered windows and the float64 overlap average
    are exactly the JAX package's."""
    starts = tpre.window_starts(t, clip_len, stride)
    want_starts = jpre.window_starts(t, clip_len, stride)
    assert starts.dtype == want_starts.dtype
    np.testing.assert_array_equal(starts, want_starts)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((t, 3, 2)).astype(np.float32)
    want_win, _ = jpre.sliding_windows(jnp.asarray(x), clip_len, stride)
    for arr in (x, torch.from_numpy(x)):
        win, st = tpre.sliding_windows(arr, clip_len, stride)
        np.testing.assert_array_equal(st, want_starts)
        np.testing.assert_array_equal(np.asarray(win), np.asarray(want_win))
    preds = rng.standard_normal((len(starts), clip_len, 2)).astype(
        np.float32)
    got = tpre.merge_window_predictions(preds, starts, t)
    want = jpre.merge_window_predictions(preds, want_starts, t)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_window_starts_rejects_short_sequence():
    with pytest.raises(ValueError, match="clip_len"):
        tpre.window_starts(3, 4, 2)


@pytest.mark.parametrize("t", [1, 3, 4, 6])
def test_pad_short_clip_equals_jax(t):
    x = np.random.default_rng(t).integers(0, 256, (t, 5, 5, 3),
                                          dtype=np.uint8)
    want = np.asarray(jpre.pad_short_clip(x, 4))
    np.testing.assert_array_equal(tpre.pad_short_clip(x, 4), want)
    got = tpre.pad_short_clip(torch.from_numpy(x), 4)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
