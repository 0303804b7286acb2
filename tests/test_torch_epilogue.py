"""The epilogue of the backbone's cuDNN convs (``kernels.bottleneck_epilogue``).

On the CPU: the plain version against PyTorch's own bias add, relu,
residual add and relu, bit for bit in bf16 and fp32 (NaN, +-inf and -0
included; a NaN's payload aside); the wrapper's checks; the card's route
(convs without bias, then the epilogue) run on the CPU through the plain
version, with its calls per backbone call; the layout of
``FoldedResNet50.stages`` and the CPU route, which stays PyTorch's chain.

On the card (marker ``card``; skipped without CUDA): the kernel against
its plain version and each block against PyTorch's chain, ``torch.equal``,
at every bottleneck shape of the benchmark's batches (bf16 at 384 frames,
fp32 at 192); whole backbone calls against the same calls on PyTorch's
chain; the kernel's launches per backbone call. Run them there with
``python -m pytest tests/test_torch_epilogue.py -m card --noconftest``
(this file imports nothing of JAX).
"""

import pytest
import torch
import torch.nn.functional as F

from mimamo_tpu_torch.backbone import (FoldedResNet50, ResNet50,
                                       fold_batchnorm)
from mimamo_tpu_torch.config import BackboneSpec
from mimamo_tpu_torch.kernels import bottleneck_epilogue as be

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
INT_OF = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
SPECIALS = (float("nan"), float("inf"), float("-inf"), -0.0, 0.0)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns, except that any NaN matches any NaN."""
    nan = a.isnan()
    if not torch.equal(nan, b.isnan()):
        return False
    ints = INT_OF[a.dtype]
    return torch.equal(a.view(ints)[~nan], b.view(ints)[~nan])


def nhwc(gen, shape, dtype, scale=1.0, specials=False):
    """Seeded N(0, scale) [N, C, H, W] in channels_last, optionally with
    every special value planted at random places."""
    t = torch.randn(shape, generator=gen) * scale
    if specials:
        flat = t.view(-1)
        idx = torch.randperm(flat.numel(), generator=gen)
        for i, v in enumerate(SPECIALS):
            flat[idx[i * 7:(i + 1) * 7]] = v
    return t.to(dtype).contiguous(memory_format=torch.channels_last)


def library_chain(y, bias, res=None, res_bias=None):
    """PyTorch's ops on a raw conv output, as the card's ``F.conv2d`` with
    a bias and the block around it compose them."""
    out = y + bias.reshape(1, -1, 1, 1)
    if res is None:
        return F.relu(out)
    if res_bias is not None:
        res = res + res_bias.reshape(1, -1, 1, 1)
    return F.relu(out + res)


# -- the plain version ----------------------------------------------------

@pytest.mark.parametrize("form", ["bias", "residual", "projection"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_is_pytorchs_chain_bit_for_bit(dtype, form):
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(7)
    shape = (2, 24, 5, 3)
    y = nhwc(gen, shape, dt, specials=True)
    bias = (torch.randn(shape[1], generator=gen) * 0.5).to(dt)
    bias[:3] = torch.tensor([-0.0, float("inf"), float("nan")])
    y[0, 0, 0, 0] = -0.0                   # -0 + -0 (+ -0): a -0 out
    res = res_bias = None
    if form != "bias":
        res = nhwc(gen, shape, dt, specials=True)
        res[0, 0, 0, 0] = -0.0
    if form == "projection":
        res_bias = (torch.randn(shape[1], generator=gen) * 0.5).to(dt)
        res_bias[0] = -0.0
    got = be.epilogue_plain(y, bias, res, res_bias)
    want = library_chain(y, bias, res, res_bias)
    assert got.dtype == dt and same_bits(got, want)
    # every special value reached the output somewhere
    assert got.isnan().any() and got.isinf().any()
    assert (torch.signbit(got) & (got == 0)).any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_rounds_after_each_add(dtype):
    """(y + b) + r rounds twice: in bf16, 1 + 2^-8 + 2^-8 is 1, not the
    bf16 value next above 1 that one rounding of the sum would give."""
    dt = DTYPES[dtype]
    y = torch.ones((1, 8, 1, 1), dtype=dt).contiguous(
        memory_format=torch.channels_last)
    tiny = torch.full((8,), 2.0 ** -8, dtype=dt)
    res = torch.full_like(y, 2.0 ** -8)
    got = be.epilogue_plain(y, tiny, res)
    want = torch.full_like(y, 1.0) if dt == torch.bfloat16 else \
        torch.full_like(y, 1.0 + 2.0 ** -7)
    assert same_bits(got, want)


@pytest.mark.parametrize("form", ["bias", "residual", "projection"])
def test_epilogue_on_the_cpu_writes_the_plain_result_into_y(form):
    gen = torch.Generator().manual_seed(3)
    y = nhwc(gen, (3, 16, 4, 4), torch.bfloat16)
    bias = torch.randn(16, generator=gen).to(torch.bfloat16)
    res = None if form == "bias" else nhwc(gen, y.shape, torch.bfloat16)
    res_bias = (torch.randn(16, generator=gen).to(torch.bfloat16)
                if form == "projection" else None)
    want = be.epilogue_plain(y, bias, res, res_bias)
    out = be.epilogue(y, bias, res, res_bias)
    assert out is y and same_bits(y, want)


# -- the wrapper's checks -------------------------------------------------

def _bad_inputs(case):
    gen = torch.Generator().manual_seed(1)
    y = nhwc(gen, (2, 16, 3, 3), torch.bfloat16)
    bias = torch.zeros(16, dtype=torch.bfloat16)
    res = nhwc(gen, (2, 16, 3, 3), torch.bfloat16)
    if case == "nchw":
        return y.contiguous(), bias, None, None
    if case == "nchw_res":
        return y, bias, res.contiguous(), None
    if case == "channels_not_multiple_of_8":
        y12 = nhwc(gen, (2, 12, 3, 3), torch.bfloat16)
        return y12, torch.zeros(12, dtype=torch.bfloat16), None, None
    if case == "too_many_channels":
        wide = nhwc(gen, (1, be.MAX_C + 8, 1, 2), torch.float32)
        return wide, torch.zeros(be.MAX_C + 8), None, None
    if case == "mixed_bias_dtype":
        return y, bias.float(), None, None
    if case == "mixed_res_dtype":
        return y, bias, res.float(), None
    if case == "mixed_res_bias_dtype":
        return y, bias, res, torch.zeros(16)
    if case == "fp16":
        return y.half(), bias.half(), None, None
    if case == "res_bias_without_res":
        return y, bias, None, bias
    if case == "bias_shape":
        return y, torch.zeros(8, dtype=torch.bfloat16), None, None
    if case == "res_shape":
        return y, bias, res[:1], None
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "nchw", "nchw_res", "channels_not_multiple_of_8", "too_many_channels",
    "mixed_bias_dtype", "mixed_res_dtype", "mixed_res_bias_dtype", "fp16",
    "res_bias_without_res", "bias_shape", "res_shape"])
def test_wrapper_raises(case):
    with pytest.raises(ValueError):
        be.epilogue(*_bad_inputs(case))


# -- the backbone -----------------------------------------------------------

def _folded(dtype: str, stride_in_1x1: bool = True, size: int = 64,
            device: str = "cpu") -> FoldedResNet50:
    """A folded ResNet-50 of seeded weights and BatchNorm statistics (so
    that every folded bias is nonzero), for crops of size / 2."""
    torch.manual_seed(0)
    spec = BackboneSpec(input_size=size, dtype=dtype)
    model = ResNet50(spec, stride_in_1x1)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    return FoldedResNet50(fold_batchnorm(model.to(device)), spec,
                          stride_in_1x1=stride_in_1x1)


def _crops(n: int, s: int, device: str = "cpu") -> torch.Tensor:
    gen = torch.Generator().manual_seed(2)
    return (torch.rand((n, s, s, 3), generator=gen) * 255).to(device)


@pytest.mark.parametrize("stride_in_1x1", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stage_layout_is_unchanged(dtype, stride_in_1x1):
    """One (OIHW channels_last weight, bias, stride, padding) tuple per
    conv, in the work dtype; the stages that run as convs."""
    fb = _folded(dtype, stride_in_1x1)
    dt = DTYPES[dtype]
    want_stages = ([1, 2, 3, 4] if dtype == "float32"
                   else [1, 3, 4] if stride_in_1x1 else [1, 2, 3, 4])
    assert sorted(fb.stages) == want_stages
    for stage, blocks in fb.stages.items():
        for b, blk in enumerate(blocks):
            names = ["conv1", "conv2", "conv3"] + (["downsample"] if b == 0
                                                   else [])
            assert sorted(blk) == sorted(names)
            for name, (w, bias, stride, pad) in blk.items():
                assert w.dtype == bias.dtype == dt
                assert w.is_contiguous(memory_format=torch.channels_last)
                assert tuple(bias.shape) == (w.shape[0],)
                assert pad == w.shape[-1] // 2
                strided = stage > 1 and b == 0 and (
                    name == "downsample"
                    or name == ("conv1" if stride_in_1x1 else "conv2"))
                assert stride == (2 if strided else 1)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_route_is_pytorchs_chain(dtype):
    """On the CPU a bottleneck is ``F.conv2d`` with its bias, relu and the
    residual add: the parent's ops, the numbers every CPU test saw."""
    fb = _folded(dtype)
    blk = fb.stages[1][0]
    gen = torch.Generator().manual_seed(4)
    x = nhwc(gen, (2, 64, 16, 16), DTYPES[dtype])

    def conv(v, p):
        w, b, stride, pad = p
        return F.conv2d(v, w, b, stride=stride, padding=pad)

    want = F.relu(conv(F.relu(conv(F.relu(conv(x, blk["conv1"])),
                                   blk["conv2"])), blk["conv3"])
                  + conv(x, blk["downsample"]))
    assert same_bits(fb._bottleneck(x, blk), want)
    assert same_bits(be.bottleneck_library(x, blk), want)


@pytest.mark.parametrize("dtype,stride_in_1x1,calls", [
    ("bfloat16", True, 36), ("bfloat16", False, 39), ("float32", True, 48)])
def test_card_route_on_the_cpu(dtype, stride_in_1x1, calls, monkeypatch):
    """The card's route (each conv without its bias, then the epilogue),
    forced on the CPU where the epilogue runs its plain version: three
    epilogues a block run as convs, and embeddings within rounding of
    PyTorch's chain (the CPU convs fold the bias in before they round)."""
    fb = _folded(dtype, stride_in_1x1)
    crops = _crops(2, 32)
    want_emb, want_logits = fb(crops)
    seen = []
    real = be.epilogue

    def counted(y, *args):
        seen.append(y.shape[1])
        return real(y, *args)

    monkeypatch.setattr(be, "epilogue", counted)
    monkeypatch.setattr(FoldedResNet50, "_bottleneck",
                        staticmethod(be.bottleneck_epilogues))
    emb, logits = fb(crops)
    assert len(seen) == calls
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    scale = want_emb.abs().max()
    assert (emb - want_emb).abs().max() <= tol * scale
    assert (logits - want_logits).abs().max() <= tol * \
        want_logits.abs().max()


# -- on the card -------------------------------------------------------------

CARD_FRAMES = {"bfloat16": 384, "float32": 192}   # the benchmark's batches
CARD_STAGES = [("bfloat16", 1), ("bfloat16", 3), ("bfloat16", 4),
               ("float32", 1), ("float32", 2), ("float32", 3),
               ("float32", 4)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the epilogue kernel runs only there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_backbones():
    """Per dtype, lazily: the folded backbone on the card at the full
    input size, and its crops at the benchmark's batch."""
    cache = {}

    def get(dtype: str, stride_in_1x1: bool = True):
        key = (dtype, stride_in_1x1)
        if key not in cache:
            cache.clear()
            torch.cuda.empty_cache()
            cache[key] = (_folded(dtype, stride_in_1x1, 224, "cuda"),
                          _crops(CARD_FRAMES[dtype], 112, "cuda"))
        return cache[key]
    return get


@pytest.mark.card
@pytest.mark.parametrize("dtype,stage", CARD_STAGES)
@torch.no_grad()
def test_card_kernel_at_every_bottleneck_shape(card, card_backbones, dtype,
                                               stage):
    """Each epilogue of the stage against its plain version on the same
    raw conv output, and each block against PyTorch's chain, on the
    stage's real input at the benchmark's batch: ``torch.equal``."""
    fb, crops = card_backbones(dtype)
    x = fb.run_stem(crops)
    for s in range(1, stage):
        x = fb.run_layer2(x) if s == 2 else fb._stage(x, s)
    for blk in fb.stages[stage]:
        y1 = be._conv(x, blk["conv1"], bias=False)
        got1 = be.epilogue(y1.clone(), blk["conv1"][1])
        assert torch.equal(got1, be.epilogue_plain(y1, blk["conv1"][1]))
        y2 = be._conv(got1, blk["conv2"], bias=False)
        got2 = be.epilogue(y2.clone(), blk["conv2"][1])
        assert torch.equal(got2, be.epilogue_plain(y2, blk["conv2"][1]))
        y3 = be._conv(got2, blk["conv3"], bias=False)
        args = ((be._conv(x, blk["downsample"], bias=False),
                 blk["downsample"][1]) if "downsample" in blk else (x,))
        got3 = be.epilogue(y3.clone(), blk["conv3"][1], *args)
        assert torch.equal(got3, be.epilogue_plain(y3, blk["conv3"][1],
                                                   *args))
        want = be.bottleneck_library(x, blk)
        assert torch.equal(got3, want)
        assert torch.equal(fb._bottleneck(x, blk), want)
        x = want


@pytest.mark.card
@pytest.mark.parametrize("dtype,stride_in_1x1", [
    ("bfloat16", True), ("bfloat16", False), ("float32", True)])
@torch.no_grad()
def test_card_backbone_equals_pytorchs_chain(card, card_backbones, dtype,
                                             stride_in_1x1, monkeypatch):
    fb, crops = card_backbones(dtype, stride_in_1x1)
    emb, logits = fb(crops)
    monkeypatch.setattr(FoldedResNet50, "_bottleneck",
                        staticmethod(be.bottleneck_library))
    want_emb, want_logits = fb(crops)
    assert torch.isfinite(emb).all()
    assert torch.equal(emb, want_emb) and torch.equal(logits, want_logits)


@pytest.mark.card
@pytest.mark.parametrize("dtype,stride_in_1x1,launches", [
    ("bfloat16", True, 36), ("bfloat16", False, 39), ("float32", True, 48)])
@torch.no_grad()
def test_card_launches_per_backbone_call(card, card_backbones, dtype,
                                         stride_in_1x1, launches):
    fb, crops = card_backbones(dtype, stride_in_1x1)
    be.KERNEL.launches = 0
    fb(crops[:8])
    torch.cuda.synchronize()
    assert be.KERNEL.launches == launches
