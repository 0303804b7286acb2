"""The torchvision stride placement (``stride_in_1x1=False``: block 0 of
layers 2-4 strides its 3x3 conv2) in the port's ResNet-50, against the JAX
package's ``ResNet50(stride_in_1x1=False)`` on the CPU, with the JAX
variables (random BN, so folding has something to fold) carried over by
``weights.backbone_from_jax``: the unfolded model in inference mode and
the folded one (layer2 block 0 as plain convs, blocks 1-3 through the
layer2 kernel's stride-1 tail).

Tolerances: fp32 atol 2e-4, rtol 1e-3 (tests/test_backbone.py); bf16
max |d| / max |JAX| < 2e-2 (the bf16 kernels' gate; measured 4.7e-3
folded, 5.9e-3 unfolded: the two packages round at other points)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimamo_tpu import backbone as jbackbone
from mimamo_tpu import preprocess as jpre
from mimamo_tpu.config import BackboneSpec as JBackboneSpec
from mimamo_tpu_torch import backbone as tbackbone
from mimamo_tpu_torch import preprocess as tpre
from mimamo_tpu_torch import weights
from mimamo_tpu_torch.config import BackboneSpec
from mimamo_tpu_torch.kernels import layer2_kernel

from test_torch_backbone_temporal import _randomize_bn
from test_torch_finetune_bf16 import two_intra_op_threads  # noqa: F401

SIZE = 64                       # backbone input; crops of 32


@pytest.fixture(scope="module")
def case():
    """JAX variables of ``ResNet50(stride_in_1x1=False)`` (random BN), the
    port's unfolded model of them per dtype, and seeded crops."""
    torch.manual_seed(0)
    seed_sd = tbackbone.ResNet50(BackboneSpec(input_size=SIZE)).state_dict()
    variables = jbackbone.load_torch_state_dict(
        {k: v.numpy() for k, v in seed_sd.items()})
    variables = _randomize_bn(jax.tree_util.tree_map(np.asarray, variables),
                              seed=0)
    models = {}
    for dtype in ("float32", "bfloat16"):
        m = tbackbone.ResNet50(BackboneSpec(input_size=SIZE, dtype=dtype),
                               stride_in_1x1=False)
        m.load_state_dict(weights.backbone_from_jax(variables))
        models[dtype] = m.eval()
    crops = np.random.default_rng(1).uniform(
        0, 255, (2, SIZE // 2, SIZE // 2, 3)).astype(np.float32)
    return variables, models, crops


def _close(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() < 2e-2


def test_placement_moves_the_stride_only():
    """Block 0 of layers 2-4 strides conv2 and the projection, conv1 not;
    the key set is the Caffe placement's."""
    caffe = tbackbone.ResNet50(BackboneSpec(input_size=SIZE))
    tv = tbackbone.ResNet50(BackboneSpec(input_size=SIZE),
                            stride_in_1x1=False)
    for stage in (2, 3, 4):
        a, b = getattr(caffe, f"layer{stage}")[0], getattr(
            tv, f"layer{stage}")[0]
        assert (a.conv1.stride, a.conv2.stride) == ((2, 2), (1, 1))
        assert (b.conv1.stride, b.conv2.stride) == ((1, 1), (2, 2))
        assert b.downsample[0].stride == (2, 2)
    assert set(caffe.state_dict()) == set(tv.state_dict())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfolded_matches_jax(case, dtype):
    """The unfolded model in inference mode on ``for_backbone`` of the
    crops against JAX ``ResNet50(stride_in_1x1=False).apply``."""
    variables, models, crops = case
    jspec = JBackboneSpec(input_size=SIZE, dtype=dtype)
    want = jax.jit(jbackbone.ResNet50(jspec, stride_in_1x1=False).apply)(
        variables, jpre.for_backbone(jnp.asarray(crops), jspec))
    with torch.no_grad():
        got = models[dtype](tpre.for_backbone(torch.from_numpy(crops),
                                              models[dtype].spec))
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_matches_jax(case, dtype):
    """``FoldedResNet50(stride_in_1x1=False)`` against JAX's fused apply of
    the folded variables; layer2 routed by placement at construction."""
    variables, models, crops = case
    jspec = JBackboneSpec(input_size=SIZE, dtype=dtype)
    want = jax.jit(jbackbone.ResNet50(jspec, stride_in_1x1=False,
                                      fused_bn=True).apply)(
        jbackbone.fold_batchnorm(variables),
        jpre.for_backbone(jnp.asarray(crops), jspec))
    folded = tbackbone.FoldedResNet50(
        tbackbone.fold_batchnorm(models[dtype]), models[dtype].spec,
        stride_in_1x1=False)
    if dtype == "bfloat16":
        assert folded.run_layer2 == folded._layer2_tail_kernel
        assert len(folded.layer2) == 3 and len(folded.stages[2]) == 1
        assert folded.stages[2][0]["conv2"][2] == 2
    else:
        assert folded.run_layer2 == folded._layer2_convs
    with torch.no_grad():
        got = folded(torch.from_numpy(crops))
    for g, w in zip(got, want):
        _close(g, w, dtype)


def test_layer2_tail(case):
    """The kernel's stride-1 tail: blocks 1-3 are the same function in
    both placements (the same packed weights); the CPU wrapper is the
    plain version at [N, H, W, 512]; the input and blocks are checked."""
    _, models, _ = case
    folded = tbackbone.fold_batchnorm(models["bfloat16"])
    full = layer2_kernel.pack_layer2_params(folded, torch.bfloat16)
    tail = layer2_kernel.pack_layer2_params(folded, torch.bfloat16,
                                            stride_in_1x1=False)
    assert len(full) == 4 and len(tail) == 3
    for a, b in zip(full[1:], tail):
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name].weight, b[name].weight)
            assert a[name].stride == b[name].stride == 1
    x = torch.randn((2, 7, 5, 512),
                    generator=torch.Generator().manual_seed(0)).to(
                        torch.bfloat16)
    got = layer2_kernel.layer2_fused(x, tail)
    assert got.shape == (2, 7, 5, 512)
    assert torch.equal(got, layer2_kernel.layer2_plain(x, tail))
    with pytest.raises(ValueError, match="stride-1 tail"):
        layer2_kernel.layer2_fused(torch.zeros((1, 8, 8, 256),
                                               dtype=torch.bfloat16), tail)
    with pytest.raises(ValueError, match="2H, 2W"):
        layer2_kernel.layer2_fused(x, full)
    with pytest.raises(ValueError, match="layer2 shapes"):
        layer2_kernel.layer2_fused(x, tail[1:])


def test_torchvision_state_dict_loads_into_either_placement(case):
    """A torchvision-named ``state_dict`` (the placement is not in the
    keys) loads strictly through ``load_torch_state_dict`` into the
    torchvision placement and gives the model it came from."""
    _, models, crops = case
    sd = {k: v.numpy() for k, v in models["float32"].state_dict().items()}
    model = tbackbone.ResNet50(BackboneSpec(input_size=SIZE),
                               stride_in_1x1=False)
    model.load_state_dict(tbackbone.load_torch_state_dict(sd))
    x = tpre.for_backbone(torch.from_numpy(crops), model.spec)
    with torch.no_grad():
        a, b = model.eval()(x), models["float32"](x)
    for g, w in zip(a, b):
        assert torch.equal(g, w)
