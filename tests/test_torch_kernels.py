"""Each kernel's plain version (what the wrapper runs for CPU tensors) vs
the JAX package's Pallas kernel, run as the JAX tests run it on the CPU
(``interpret=True``). The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
from mimamo_tpu_torch.preprocess import upscale2x


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


def _strip_formulation(band, p, weighting, strip_bytes):
    """The CUDA kernel's arithmetic in plain torch: per strip of
    ``strip_plan``, dphi (times |prod| with weighting) once per source
    pixel of the rows the strip holds, output rows from two row taps and
    two column taps of ``resize_taps`` relative to the strip's first row,
    the sum of |prod| over the rows the strip owns, and at the end the
    plane's un-normalised rows divided by mean|prod| + 1e-6."""
    from mimamo_tpu_torch import phase as tphase
    b, t, k, h, w = band.shape
    row_idx, row_wts = map(torch.from_numpy, tphase.resize_taps(h, p))
    col_idx, col_wts = map(torch.from_numpy, tphase.resize_taps(w, p))
    row_idx, col_idx = row_idx.long(), col_idx.long()
    plan = tphk.strip_plan(h, w, p, weighting, strip_bytes)
    out = torch.full((b, t - 1, k, p, p), float("nan"))
    total = torch.zeros((b, t - 1, k))
    owned = torch.zeros(h, dtype=torch.int32)
    for p0, p1, r0, nr, own0, own1 in plan.tolist():
        cur, prev = band[:, 1:, :, r0:r0 + nr], band[:, :-1, :, r0:r0 + nr]
        re = cur.real * prev.real + cur.imag * prev.imag
        im = cur.imag * prev.real - cur.real * prev.imag
        d = torch.atan2(im, re)
        if weighting:
            amp = torch.sqrt(re * re + im * im)
            d = d * amp
            assert r0 <= own0 and own1 <= r0 + nr
            total += amp[..., own0 - r0:own1 - r0, :].sum(dim=(-2, -1))
            owned[own0:own1] += 1
        rows = row_idx[p0:p1] - r0                       # [n, 2]
        assert rows.min() >= 0 and rows.max() < nr
        cols = (d[..., col_idx[:, 0]] * col_wts[:, 0]
                + d[..., col_idx[:, 1]] * col_wts[:, 1])  # [..., nr, P]
        out[..., p0:p1, :] = (
            cols[..., rows[:, 0], :] * row_wts[p0:p1, 0, None]
            + cols[..., rows[:, 1], :] * row_wts[p0:p1, 1, None])
    if weighting:
        assert (owned == 1).all()                # the owned rows partition
        out = out / (total / (h * w) + 1e-6)[..., None, None]
    return out


@pytest.mark.parametrize("weighting", [False, True])
@pytest.mark.parametrize("shape,strip_bytes", [
    ((2, 4, 2, 32, 32), 2048),      # 4+ strips a plane
    ((1, 2, 3, 20, 28), 1024),      # non-square, T = 2: one pair
    ((1, 3, 2, 112, 112), 8192),    # 112 -> 48: rows between taps unused
    ((1, 3, 1, 12, 12), 8192),      # 12 -> 48 upsampling, one strip
])
def test_phase_kernel_strip_formulation_matches_pallas(shape, strip_bytes,
                                                       weighting):
    """The strip formulation the CUDA kernel computes (dphi per source
    pixel, then 2-tap rows and columns within the strip's row span, the
    weighting mean from per-strip partial sums) vs the Pallas kernel in
    interpret mode, atol 1e-4 rad."""
    rng = np.random.default_rng(7)
    band = _complex(rng, shape)
    want = np.asarray(jphk.phase_diff_resize_blocked(
        jnp.asarray(band[:, 1:]), jnp.asarray(band[:, :-1]), phase_size=48,
        block=8, interpret=True, amplitude_weighting=weighting))
    got = _strip_formulation(torch.from_numpy(band), 48, weighting,
                             strip_bytes)
    assert len(tphk.strip_plan(*shape[-2:], 48, weighting, strip_bytes)) >= (
        1 if shape[-1] == 12 else 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("h,w", [(112, 112), (56, 56), (28, 28), (34, 34),
                                 (20, 28), (7, 5)])
@pytest.mark.parametrize("weighting", [False, True])
def test_phase_strip_plan_covers_rows_within_budget(h, w, weighting):
    """Every output row lies in exactly one strip, a strip holds both taps
    of each of its rows, and without weighting no strip of more than one
    row exceeds the byte budget."""
    from mimamo_tpu_torch import phase as tphase
    plan = tphk.strip_plan(h, w, 48, weighting)
    idx, _ = tphase.resize_taps(h, 48)
    assert plan[0, 0] == 0 and plan[-1, 1] == 48
    assert (plan[1:, 0] == plan[:-1, 1]).all()
    for p0, p1, r0, nr, own0, own1 in plan.tolist():
        assert r0 <= idx[p0:p1].min() and idx[p0:p1].max() < r0 + nr <= h
        assert weighting or p1 - p0 == 1 or nr * w * 8 <= tphk.STRIP_BYTES
    assert plan[0, 4] == 0 and plan[-1, 5] == h
    assert (plan[1:, 4] == plan[:-1, 5]).all()


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
    want = _pallas_stem_f32(order)
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


def _tf32(x):
    """``x`` rounded to TF32 (10 explicit mantissa bits, ties away from
    zero) on its fp32 bit pattern, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _stem_gemm_model(crops, w2, bias, mean, split="none"):
    """The stem kernel's implicit GEMM (csrc/stem.cu) in plain PyTorch: the
    upscaled image as rows of [col][ch] with 3 zero columns each side, conv
    pixel (r, c) taking, for each ky, the 24 elements from 6c of padded
    row 2r + ky, against weights whose 21 (kx, ch) rows per ky are padded
    with 3 zero rows.

    ``split`` models the fp32 kernel's operands: "none" (fp32 products),
    "tf32" (each operand rounded to TF32 once) or "3xtf32" (hi = tf32(x),
    lo = tf32(x - hi), products a_lo b_hi + a_hi b_lo + a_hi b_hi); the
    rounded products are summed in float64."""
    n, s = crops.shape[:2]
    u = upscale2x(crops - torch.tensor(mean)).to(w2.dtype).float()
    rows = F.pad(u, (0, 0, 3, 3, 3, 3)).reshape(n, 2 * s + 6, -1)
    r, c, j = torch.arange(s), torch.arange(s), torch.arange(24)
    ky = torch.arange(7)
    sel = rows[:, 2 * r[:, None] + ky[None, :]]       # [N, S, 7, 6S + 18]
    a = sel[..., 6 * c[:, None] + j[None, :]]          # [N, S, 7, S, 24]
    a = a.permute(0, 1, 3, 2, 4).reshape(n, s, s, 7 * 24)
    wpad = F.pad(w2.float().reshape(7, 21, 64), (0, 0, 0, 3)).reshape(168, 64)
    if split == "none":
        y = a @ wpad
    elif split == "tf32":
        y = (_tf32(a).double() @ _tf32(wpad).double()).float()
    elif split == "3xtf32":
        a_hi, w_hi = _tf32(a), _tf32(wpad)
        a_lo, w_lo = _tf32(a - a_hi), _tf32(wpad - w_hi)
        y = (a_lo.double() @ w_hi.double() + a_hi.double() @ w_lo.double()
             + a_hi.double() @ w_hi.double()).float()
    else:
        raise ValueError(split)
    y = F.relu(y + bias).permute(0, 3, 1, 2)
    y = F.max_pool2d(y, 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(w2.dtype)


@functools.lru_cache(maxsize=None)
def _pallas_stem_f32(order):
    """The Pallas f32 stem in interpret mode on :func:`_stem_inputs`."""
    crops, k7, b = _stem_inputs()
    jw, jb = jstem.prepare_stem_weights(jnp.asarray(k7), jnp.asarray(b),
                                        channel_order=order,
                                        dtype=jnp.float32)
    return np.asarray(jstem.stem_fused(
        jstem.prepare_stem_input(jnp.asarray(crops),
                                 JBackboneSpec().mean_rgb),
        jw, jb, dtype=jnp.float32, interpret=True))


def _split_model_stem(order, split):
    crops, k7, b = _stem_inputs()
    w2, bias = tstem.prepare_stem_weights(
        torch.from_numpy(k7.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(b), order, torch.float32)
    return _stem_gemm_model(torch.from_numpy(crops), w2, bias,
                            JBackboneSpec().mean_rgb, split).numpy()


@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_stem_kernel_gemm_layout_matches_pallas_f32(order):
    """The kernel's K layout (7 ky x 24, zero-padded taps) against the
    Pallas stem in interpret mode, f32, atol 1e-3 (tests/test_pallas.py)."""
    want = _pallas_stem_f32(order)
    got = _split_model_stem(order, "none")
    assert got.shape == want.shape == (2, 56, 56, 64)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_tf32_rounding_is_nearest_ties_away():
    """The model's TF32 rounding keeps 10 explicit mantissa bits and
    rounds a tie away from zero, for either sign; hi + lo is within 2^-22
    of x."""
    one = 1.0 + 2.0 ** -10                 # a TF32 value
    half = 2.0 ** -11                      # half its last place
    x = torch.tensor([one, one + half, one + half * 0.99, -(one + half),
                      1.0 + half], dtype=torch.float32)
    want = torch.tensor([one, one + 2 * half, one, -(one + 2 * half),
                         1.0 + 2 * half], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    hi = _tf32(x)
    lo = _tf32(x - hi)                     # the split keeps ~22 bits
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()


@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_stem_3xtf32_model_matches_pallas_f32(order):
    """The fp32 kernel's arithmetic (3xTF32 products, csrc/stem.cu) against
    the Pallas f32 stem in interpret mode: atol 1e-3 and max-rel <= 1e-5,
    the card's gate for the kernel against stem_plain (chip_smoke.py)."""
    want = _pallas_stem_f32(order)
    got = _split_model_stem(order, "3xtf32")
    assert got.shape == want.shape == (2, 56, 56, 64)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_stem_single_tf32_model_fails_the_card_gate():
    """One TF32 rounding of each operand (no lo parts) is off by more than
    the 1e-5 max-rel gate, so the gate tells plain TF32 from 3xTF32."""
    want = _pallas_stem_f32("rgb")
    got = _split_model_stem("rgb", "tf32")
    assert np.abs(got - want).max() / np.abs(want).max() > 1e-5


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


def _layer2_grid_model(x, blocks):
    """layer2 in the layer2 kernel's formulation (csrc/layer2.cu), in plain
    PyTorch: the H x W output on a grid of row stride 32 with one zero row
    above and below and zero columns 0 and W+1.. 31; y1 zeroed at the
    padding; conv2's taps as shifts of the flattened grid by 32 dy + dx;
    block 0's projection accumulated with conv3 by concatenating K. Operands
    are the rounded values, sums in fp32, the kernel's rounding points."""
    dt, g = x.dtype, 32
    n, h, w = x.shape[0], x.shape[1] // 2, x.shape[2] // 2

    def to_grid(v):
        out = v.new_zeros((n, h + 2, g, v.shape[-1]))
        out[:, 1:h + 1, 1:w + 1] = v
        return out.reshape(n, (h + 2) * g, -1)

    mask = to_grid(torch.ones((n, h, w, 1)))
    cur = x[:, ::2, ::2].float()                       # block 0's pixels
    for blk in blocks:
        xg = to_grid(cur)
        c1, c2, c3 = blk["conv1"], blk["conv2"], blk["conv3"]
        y1 = F.relu(xg @ c1.weight.float().reshape(128, -1).T + c1.bias)
        y1 = (y1 * mask).to(dt).float()
        yp = F.pad(y1, (0, 0, g + 1, g + 1))
        acc = sum(yp[:, g + 1 + g * dy + dx:][:, :(h + 2) * g]
                  @ c2.weight.float()[:, dy + 1, dx + 1].T
                  for dy in (-1, 0, 1) for dx in (-1, 0, 1))
        y2 = F.relu(acc + c2.bias).to(dt).float()
        a, w3, b3, res = y2, c3.weight.float().reshape(512, 128), c3.bias, xg
        if "downsample" in blk:
            ds = blk["downsample"]
            a = torch.cat([y2, xg], -1)
            w3 = torch.cat([w3, ds.weight.float().reshape(512, 256)], 1)
            b3, res = b3 + ds.bias, 0.0
        out = F.relu(a @ w3.T + b3 + res).to(dt)
        cur = out.reshape(n, h + 2, g, 512)[:, 1:h + 1, 1:w + 1].float()
    return cur.to(dt)


def test_layer2_kernel_grid_matches_pallas(layer2_params):
    """The kernel's padded-grid formulation against the Pallas kernel in
    interpret mode at N = 2, bf16: max-rel < 2e-2 (tests/test_backbone.py)."""
    jfolded, tfolded = layer2_params
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 56, 56, 256)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jl2.layer2_fused(
        xb, jl2.pack_layer2_params(jfolded["params"]), interpret=True),
        np.float32)
    got = _layer2_grid_model(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16),
        tl2.pack_layer2_params(tfolded, torch.bfloat16)).float().numpy()
    assert got.shape == want.shape == (2, 28, 28, 512)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-2


def test_layer2_kernel_grid_ragged_matches_plain(layer2_params):
    """The same formulation at a ragged 8 x 6 output in f32 against
    :func:`layer2_plain` (atol 2e-4, rtol 1e-3: f32 throughout)."""
    _j, tfolded = layer2_params
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 16, 12, 256)).astype(
        np.float32))
    blocks = tl2.pack_layer2_params(tfolded, torch.float32)
    np.testing.assert_allclose(_layer2_grid_model(x, blocks).numpy(),
                               tl2.layer2_plain(x, blocks).numpy(),
                               atol=2e-4, rtol=1e-3)
