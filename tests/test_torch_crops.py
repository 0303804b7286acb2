"""Every crop size the JAX package runs, the port runs: the stem takes any
even crop on the CPU (its plain version; on the card the kernels cut wide
crops into column tiles, which ``chip_smoke.py``'s ``crops`` phase holds
against the plain versions), ``predict_clips`` at crop 200 matches the JAX
package's at the same weights, and the command line builds the config of
``--crop-size 200 --dtype bfloat16``.

Tolerances: the stem against the JAX chain atol 1e-3 (tests/
test_torch_kernels.py); ``predict_clips`` outputs atol 1e-4 and the
embeddings at the fp32 backbone gate of tests/test_backbone.py (atol 2e-4,
rtol 1e-3)."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mimamo_tpu import config as jc
from mimamo_tpu import preprocess as jpre
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import cli, weights
from mimamo_tpu_torch import config as tc
from mimamo_tpu_torch.kernels import stem_kernel
from mimamo_tpu_torch.preprocess import for_backbone
from mimamo_tpu_torch.runner import Mimamo

S = 200                     # past the old caps: 128 (fp32), 192 (bf16)
T = 3
OUT_ATOL = 1e-4
EMB_ATOL, EMB_RTOL = 2e-4, 1e-3
STEM_ATOL = 1e-3


def _stem_weights(seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    k7 = rng.normal(0, 0.05, (7, 7, 3, 64)).astype(np.float32)    # HWIO
    b = rng.normal(0, 0.1, (64,)).astype(np.float32)
    w2, bias = stem_kernel.prepare_stem_weights(
        torch.from_numpy(k7.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(b), "rgb", dtype)
    return k7, b, w2, bias


def test_stem_fused_on_cpu_takes_crop_200():
    """``stem_fused`` on CPU tensors at S = 200 (over the old 192 check)
    runs through ``stem_plain`` and matches the JAX reference chain
    for_backbone -> conv1 -> relu -> max_pool."""
    import flax.linen as nn
    rng = np.random.default_rng(3)
    crops = rng.uniform(0, 255, (1, S, S, 3)).astype(np.float32)
    k7, b, w2, bias = _stem_weights(4)
    mean = jc.BackboneSpec().mean_rgb
    got = stem_kernel.stem_fused(torch.from_numpy(crops), w2, bias, mean)
    assert torch.equal(got, stem_kernel.stem_plain(
        torch.from_numpy(crops), w2, bias, mean))
    spec = jc.BackboneSpec(input_size=2 * S)
    y = jax.lax.conv_general_dilated(
        jpre.for_backbone(jnp.asarray(crops), spec), jnp.asarray(k7),
        (2, 2), [(3, 3), (3, 3)], dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = np.asarray(nn.max_pool(nn.relu(y + b), (3, 3), strides=(2, 2),
                                  padding=((1, 1), (1, 1))))
    assert got.shape == want.shape == (1, S // 2, S // 2, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=STEM_ATOL, rtol=0)


def _stem_by_tiles(crops, w2, bias, mean, plan):
    """The kernel's column tiles in plain PyTorch: each tile convolves only
    its conv columns c0 .. c0 + nc - 1 (from the upscaled columns they
    read, zero outside the crop) and pools its pooled columns from them."""
    s = crops.shape[1]
    u = F.pad(for_backbone(crops, tc.BackboneSpec(input_size=2 * s)).permute(
        0, 3, 1, 2), (3, 3, 3, 3))
    k = w2.float().reshape(7, 7, 3, 64).permute(3, 2, 0, 1)
    tiles = []
    for q0, q1, c0, nc in plan:
        # conv column c reads padded upscaled columns 2c .. 2c + 6
        y = F.relu(F.conv2d(u[..., 2 * c0:2 * (c0 + nc) + 5], k, bias,
                            stride=2))
        assert y.shape[-2:] == (s, nc)
        if c0 == 0:           # column -1 is the pool's padding: zero
            y = F.pad(y, (1, 0))
        tiles.append(F.max_pool2d(F.pad(y, (0, 0, 1, 1)), 3, stride=2))
        assert tiles[-1].shape[-1] == q1 - q0
    return torch.cat(tiles, dim=-1).permute(0, 2, 3, 1)


@pytest.mark.parametrize("s, dtype", [
    (112, torch.float32), (128, torch.float32), (130, torch.float32),
    (160, torch.float32), (224, torch.float32), (264, torch.float32),
    (192, torch.bfloat16), (200, torch.bfloat16), (202, torch.bfloat16),
    (392, torch.bfloat16)],
    ids=lambda v: str(v).replace("torch.", ""))
def test_stem_column_tiles_cover_the_crop(s, dtype):
    """The tile plan of the stem kernels (``tile_plan``, the kernel's
    ``Tiles``/``block_tile``): one tile up to 128 (fp32) and 192 (bf16),
    the flagship's layout; past them tiles of at most TILE_Q pooled
    columns, evened out, that partition the pooled columns and each hold
    the conv columns their pooling reads; computed tile by tile they give
    the whole crop's stem."""
    plan = stem_kernel.tile_plan(s, dtype)
    q_max = (stem_kernel.TILE_Q_F32 if dtype == torch.float32
             else stem_kernel.TILE_Q)
    assert len(plan) == -(-(s // 2) // q_max)
    if s <= 2 * q_max:
        assert plan == [(0, s // 2, 0, s)]
    assert [q0 for q0, *_ in plan[1:]] == [q1 for _, q1, *_ in plan[:-1]]
    assert plan[0][0] == 0 and plan[-1][1] == s // 2
    widths = [q1 - q0 for q0, q1, *_ in plan]
    assert max(widths) - min(widths) <= 1 and max(widths) <= q_max
    for q0, q1, c0, nc in plan:
        assert c0 == max(2 * q0 - 1, 0) and c0 + nc == 2 * q1 <= s
    rng = np.random.default_rng(s)
    crops = torch.from_numpy(rng.uniform(0, 255, (1, s, s, 3)).astype(
        np.float32))
    _, _, w2, bias = _stem_weights(s)
    mean = tc.BackboneSpec().mean_rgb
    want = stem_kernel.stem_plain(crops, w2, bias, mean)
    got = _stem_by_tiles(crops, w2, bias, mean, plan)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=STEM_ATOL,
                               rtol=0)


def _configs(crop, dtype="float32"):
    def make(m):
        return m.MimamoConfig(
            pyramid=m.PyramidSpec(height=2, orientations=2,
                                  input_size=(crop, crop)),
            phase=m.PhaseSpec(phase_size=16),
            backbone=m.BackboneSpec(input_size=2 * crop, dtype=dtype),
            clip=m.ClipSpec(clip_len=T, stride=T, crop_size=crop))
    return make(jc), make(tc)


@pytest.fixture(scope="module")
def crop200():
    """The JAX model at crop 200 with its variables, the port's state_dict
    of them, a clip of T uint8 frames, and the JAX outputs and
    embeddings."""
    jcfg, tcfg = _configs(S)
    jmodel = JaxMimamo(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init_variables(
        jax.random.PRNGKey(2), clip_len=T))
    clip = np.random.default_rng(7).integers(0, 256, (1, T, S, S, 3),
                                             dtype=np.uint8)
    return {"tcfg": tcfg, "state": weights.from_jax_variables(variables),
            "clip": clip,
            "out": np.asarray(jmodel.predict_clips(variables, clip)),
            "emb": np.asarray(jmodel.embed_frames(
                variables, clip.astype(np.float32)))}


def test_predict_clips_at_crop_200_matches_jax(crop200):
    model = Mimamo(crop200["tcfg"], device="cpu")
    model.load_state_dict(crop200["state"])
    clip = crop200["clip"]
    with torch.no_grad():
        out = model.predict_clips(clip)
        emb = model.embed_frames(torch.from_numpy(clip).float())
    assert tuple(out.shape) == (1, T, 2)
    np.testing.assert_allclose(out.numpy(), crop200["out"], atol=OUT_ATOL)
    np.testing.assert_allclose(emb.numpy(), crop200["emb"], atol=EMB_ATOL,
                               rtol=EMB_RTOL)


def _args(argv):
    ap = argparse.ArgumentParser()
    cli._add_common(ap)
    return ap.parse_args(argv)


def test_cli_config_at_crop_200_bf16(crop200):
    """``--crop-size 200 --backbone-size 400 --dtype bfloat16`` builds the
    crop-200 bf16 config (no cap refuses it), and that config's model runs
    on the CPU with finite outputs."""
    cfg = cli._config(_args(["--crop-size", "200", "--backbone-size", "400",
                             "--dtype", "bfloat16", "--pyramid-height", "2",
                             "--orientations", "2", "--phase-size", "16",
                             "--clip-len", str(T), "--stride", str(T)]))
    assert cfg == _configs(S, "bfloat16")[1]
    assert cfg.pyramid.input_size == (S, S) and cfg.clip.crop_size == S
    assert cfg.backbone.input_size == 2 * S
    assert cfg.backbone.dtype == "bfloat16"
    model = Mimamo(cfg, device="cpu")
    model.load_state_dict(crop200["state"])
    with torch.no_grad():
        out = model.predict_clips(crop200["clip"][:, :2])
    assert tuple(out.shape) == (1, 2, 2) and torch.isfinite(out).all()
