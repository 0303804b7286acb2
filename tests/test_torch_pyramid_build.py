"""Port ``pyramid.build`` / ``reconstruct`` / ``band_shapes`` and
``phase.num_phase_channels`` against the JAX package's (FFT mode "fft",
the lowering the port's cuFFT path matches).

Tolerances: high, bands and low max |d| <= 1e-5 x the JAX array's max
|value| (measured 2.6e-7 .. 1.1e-6: the same fp32 FFTs, summed in another
order); reconstruction rel-err < 1e-3 as in tests/test_pyramid.py (the
perfect-reconstruction property; measured 4.8e-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimamo_tpu import config as jc
from mimamo_tpu import phase as jphase
from mimamo_tpu import pyramid as jpyramid
from mimamo_tpu_torch import config as tc
from mimamo_tpu_torch import phase as tphase
from mimamo_tpu_torch import pyramid as tpyramid

GEOMETRIES = [(2, 2, 32), (3, 4, 112), (2, 6, 64)]   # height, K, size


def _specs(height, k, size):
    return (jc.PyramidSpec(height=height, orientations=k,
                           input_size=(size, size), fft_mode="fft"),
            tc.PyramidSpec(height=height, orientations=k,
                           input_size=(size, size)))


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("height, k, size", GEOMETRIES)
def test_build_and_reconstruct_match_jax(height, k, size):
    """``build`` of 2 x 3 frames against JAX's (high, every band, low) and
    ``reconstruct`` of it back to the frames; ``band_shapes`` and
    ``num_phase_channels`` equal JAX's."""
    jspec, tspec = _specs(height, k, size)
    frames = np.random.default_rng(size).uniform(
        0, 255, (2, 3, size, size)).astype(np.float32)
    want = jpyramid.build(jnp.asarray(frames), jspec)
    got = tpyramid.build(torch.from_numpy(frames), tspec)
    assert got["high"].dtype == got["low"].dtype == torch.float32
    assert _rel(got["high"], want["high"]) <= 1e-5
    assert _rel(got["low"], want["low"]) <= 1e-5
    assert len(got["bands"]) == len(want["bands"]) == height
    for g, w in zip(got["bands"], want["bands"]):
        assert g.dtype == torch.complex64 and g.shape == w.shape
        assert _rel(g, w) <= 1e-5
    rec = tpyramid.reconstruct(got, tspec).numpy()
    assert rec.shape == frames.shape
    assert np.abs(rec - frames).max() / np.abs(frames).max() < 1e-3
    assert tpyramid.band_shapes(tspec) == tuple(jpyramid.band_shapes(jspec))
    assert tuple(b.shape[-3:] for b in got["bands"]) == \
        tpyramid.band_shapes(tspec)
    assert tphase.num_phase_channels(tspec) == \
        jphase.num_phase_channels(jspec)


def test_build_bands_are_the_micro_stream_bands():
    """``build``'s bands are exactly those ``pyramid.bands`` gives the
    micro stream (one crop-and-mask code path)."""
    _, tspec = _specs(3, 4, 112)
    frames = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (4, 112, 112)).astype(np.float32))
    streamed = tpyramid.bands(frames, tspec,
                              tpyramid.band_masks(tspec, frames.device))
    for a, b in zip(tpyramid.build(frames, tspec)["bands"], streamed):
        assert torch.equal(a, b)


def test_build_rejects_other_sizes():
    _, tspec = _specs(2, 2, 32)
    with pytest.raises(ValueError, match="input_size"):
        tpyramid.build(torch.zeros((1, 32, 40)), tspec)
