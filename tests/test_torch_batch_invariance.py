"""The phase stage gives a frame the same bits whatever batch it arrives
in, on the CPU, against the JAX package: the grey conversion
(``preprocess.to_grayscale``, elementwise) and the bands of
``pyramid.bands`` of 48 seeded 112^2 crops taken alone, in batches of 5,
17 and 48 and at every position of each; the phase stacks of a clip
against its streamed chunks (``bench/fft_invariance.py``, whose card run
``chip_smoke.py`` makes); the bands against JAX ``pyramid.build``. Also
the rule of the port tests' temporary-directory cleanup
(``test_torch_decode.drop_if_passed``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimamo_tpu import preprocess as jpre
from mimamo_tpu import pyramid as jpyr
from mimamo_tpu.config import PyramidSpec as JPyramidSpec
from mimamo_tpu_torch import pyramid
from mimamo_tpu_torch.bench import fft_invariance
from mimamo_tpu_torch.config import PhaseSpec, PyramidSpec
from mimamo_tpu_torch.preprocess import to_grayscale

from test_torch_decode import drop_if_passed, drop_passed_tmp_path  # noqa

N, S = 48, 112
SPEC = PyramidSpec(input_size=(S, S))          # 3 scales, 4 orientations
# two FFT libraries in complex64: tests/test_torch_pyramid_phase.py's bound
JAX_REL_TOL = 1e-5
# radians: a few float32 ulps of pi, the plain resize's rounding
STACKS_ATOL = 1e-5


@pytest.fixture(scope="module")
def crops():
    return np.random.default_rng(16).integers(0, 256, (N, S, S, 3),
                                              dtype=np.uint8)


def _bands(rgb: np.ndarray) -> list:
    gray = to_grayscale(torch.from_numpy(rgb).float())
    return list(pyramid.bands(gray, SPEC,
                              pyramid.band_masks(SPEC, torch.device("cpu"))))


@pytest.fixture(scope="module")
def whole(crops):
    """The bands of all N crops in one batch."""
    return _bands(crops)


@pytest.fixture(scope="module")
def jax_bands(crops):
    """JAX ``pyramid.build``'s bands of the JAX grey frames (the file's one
    JAX reference)."""
    gray = jpre.to_grayscale(jnp.asarray(crops, jnp.float32))
    pyr = jpyr.build(gray, JPyramidSpec(input_size=(S, S), fft_mode="fft"))
    return [np.asarray(b) for b in pyr["bands"]]


def test_grayscale_is_jax_bit_for_bit(crops):
    """The elementwise grey conversion is the JAX package's value on the
    CPU exactly, and a frame's value is the same alone and in the batch."""
    x = crops.astype(np.float32)
    got = to_grayscale(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jpre.to_grayscale(jnp.asarray(x))))
    for f in (0, 17, N - 1):
        np.testing.assert_array_equal(
            to_grayscale(torch.from_numpy(x[f:f + 1])).numpy()[0], got[f])


def test_bands_of_a_frame_alone_equal_the_batch(crops, whole):
    for f in range(N):
        for got, want in zip(_bands(crops[f:f + 1]), whole):
            assert torch.equal(got[0], want[f]), f


@pytest.mark.parametrize("n", [5, 17, 48])
def test_bands_equal_at_every_position_of_a_batch(crops, whole, n):
    """Windows of n frames (wrapping round the N) starting at every frame:
    each frame sits at every position of a batch of n once."""
    for start in range(N):
        idx = (np.arange(n) + start) % N
        for got, want in zip(_bands(crops[idx]), whole):
            assert got.shape[0] == n
            assert torch.equal(got, want[torch.from_numpy(idx)]), start


def test_bands_match_jax(whole, jax_bands):
    """Per scale, max |d| / max |JAX| within the FFT libraries' bound, of
    the expected shape [N, K, S/2^s, S/2^s]."""
    assert len(whole) == len(jax_bands) == SPEC.height
    for s, (got, want) in enumerate(zip(whole, jax_bands)):
        assert tuple(got.shape) == want.shape == (N, 4, S >> s, S >> s)
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel <= JAX_REL_TOL, (s, rel)


def test_a_frame_never_reaches_another(crops, whole):
    """A NaN frame in the batch stays in its own bands: the others' are
    finite and equal to the batch without it, and the shapes are the
    batch's."""
    idx = np.arange(8)
    gray = to_grayscale(torch.from_numpy(crops[idx]).float())
    gray[3] = float("nan")
    got = list(pyramid.bands(gray, SPEC, pyramid.band_masks(
        SPEC, torch.device("cpu"))))
    keep = torch.from_numpy(np.delete(idx, 3))
    for g, want in zip(got, whole):
        assert g.shape[0] == len(idx)
        assert torch.isnan(g[3]).all()
        assert torch.isfinite(g[keep]).all()
        assert torch.equal(g[keep], want[keep])


def test_phase_stacks_of_chunks_match_the_clip(crops):
    """``fft_invariance.check`` at a small size on the CPU: every step of
    the bands bit-equal at every size and position; the phase stacks of a
    1 x 48 clip against its chunks of 16 with their context frames, each
    made grey on its own: no jump, and within STACKS_ATOL. (On the card
    the phase kernel gives them bit for bit, and ``chip_smoke.py`` holds
    it to that; on the CPU the plain resize is a float32 matmul, whose
    rounding may follow the batch.)"""
    spec = PyramidSpec(input_size=(32, 32))
    rgb = torch.from_numpy(crops[:, :32, :32].copy())
    report = fft_invariance.check(rgb, spec, PhaseSpec(phase_size=16),
                                  sizes=(1, 5, 17, N), frames=(0, 23, 47),
                                  clip=(1, N))
    assert fft_invariance.all_equal(report["counts"]), report
    stacks = report["stacks_vs_chunks"]
    assert stacks["jumps"] == 0 and stacks["max_abs"] <= STACKS_ATOL, stacks


def test_drop_if_passed_keeps_only_failed_dirs(tmp_path):
    """A directory goes when no test failed between the two counts, and
    stays, with what it holds, when one did."""
    passed, failed = tmp_path / "passed", tmp_path / "failed"
    for d in (passed, failed):
        (d / "sub").mkdir(parents=True)
        (d / "sub" / "ckpt.pt").write_bytes(b"x" * 1024)
    assert drop_if_passed(passed, 3, 3)
    assert not passed.exists()
    assert not drop_if_passed(failed, 3, 4)
    assert (failed / "sub" / "ckpt.pt").read_bytes() == b"x" * 1024
