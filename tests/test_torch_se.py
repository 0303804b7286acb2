"""SE-ResNet-50 FER+ in the port (``BackboneSpec.se_reduction``).

On the CPU, at 32^2 crops (a 64^2 backbone input): the port against the
benchmark's plain reference ``benchmark/reference/senet.py`` on seeded
weights, over clips and over a stream fed in chunks; the same weights with
every gate forced to 1 in the program's place, far outside that
tolerance; the gate's plain passes against PyTorch's chain; the card's
route (convs without bias, the SE passes) forced on the CPU; the
``state_dict`` with the gates' leaves; the reference's schema against the
port's ``state_dict``; the references' refusals; the streaming session and
the frozen and fine-tuning train steps of an SE model.

On the card (marker ``card``; skipped without CUDA): the squeeze and scale
kernels against their plain versions at every SE block of a backbone call
in bf16 (384 frames, the benchmark's call) and fp32 (192); a frame's
squeeze bits at other batch sizes; a whole bf16 backbone call against
PyTorch's chain; the kernels' launches per call in both dtypes.
Run them there with ``python -m pytest tests/test_torch_se.py -m card
--noconftest`` (this file imports nothing of JAX).
"""

import copy
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import data, program, spec
from benchmark.reference import mimamo, senet
from mimamo_tpu_torch import preprocess, tracing, train
from mimamo_tpu_torch.backbone import (FoldedResNet50, ResNet50,
                                       fold_batchnorm)
from mimamo_tpu_torch.config import BackboneSpec
from mimamo_tpu_torch.kernels import bottleneck_epilogue as be
from mimamo_tpu_torch.streaming import StreamingSession

CONFIG = spec.ROOT / "benchmark/configs/senet50-ferplus-bf16.json"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# fp32 round-off of the same model in two programs (convs and means summed
# in other orders, BN folded in other ways), over ~55 convs and 16 gates:
# the port against the plain reference reads 1.6e-6 to 4.2e-6 of the
# outputs' scale here (seeds 5-7); the bound leaves a decade and more.
# Gates forced to 1 move the outputs by tens of percent of it.
REL_TOL = 1e-4


def _config(dtype: str = "float32") -> dict:
    """The benchmark's SE configuration at 32^2 crops and 16^2 phase maps
    (the benchmark's own tests' small size), in ``dtype``."""
    c = json.loads(CONFIG.read_text())
    c["pyramid"]["input_size"] = [32, 32]
    c["phase"]["phase_size"] = 16
    c["backbone"]["input_size"] = 64
    c["backbone"]["dtype"] = dtype
    c["clip"].update(crop_size=32, clip_len=8, stride=4)
    return c


@pytest.fixture(scope="module")
def case():
    """The fp32 configuration, its seeded weights, the port and the plain
    reference on them, two clips of 6 frames and the reference's
    outputs."""
    cfg = _config()
    state = data.make_weights(cfg, 5, "cpu")
    model = program.build_model(cfg, state, "cpu")
    ref = senet.Reference(cfg, state, "cpu")
    clips = data.make_clips(5, "cpu", 1, 2, 6, 32)[0]
    return {"cfg": cfg, "state": state, "model": model, "ref": ref,
            "clips": clips, "want": ref.clips(clips).numpy()}


def _gap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the port against the plain reference -------------------------------------

def test_port_matches_the_reference_over_clips(case):
    got = case["model"].predict_clips(case["clips"]).numpy()
    assert _gap(got, case["want"]) < REL_TOL


def test_port_matches_the_reference_over_a_stream(case):
    """A stream fed in chunks of 3 (GRU carries and the pair across the
    seam) gives the reference's clip-mode outputs."""
    seq, carries, outs = case["clips"][1], None, []
    for i in range(0, 6, 3):
        out, carries = case["model"].predict_stream(seq[None, i:i + 3],
                                                    carries)
        outs.append(out[0])
    assert _gap(torch.cat(outs).numpy(), case["want"][1]) < REL_TOL


class _GatesAtOne(senet.Reference):
    """The reference with every gate forced to 1: ResNet-50 on the same
    weights, the SE leaves unused."""

    def gate(self, u, block):
        return u


def test_gates_forced_to_one_fail_the_tolerance(case):
    """Put in the program's place, the model without its gates is
    thousands of times outside the tolerance the port meets (0.4-1.2 of
    the outputs' scale on seeds 5-7): the comparison sees the gates."""
    plain = _GatesAtOne(case["cfg"], case["state"], "cpu")
    assert _gap(plain.clips(case["clips"]).numpy(), case["want"]) \
        > 100 * REL_TOL


def test_fp8_control_fails_the_cells_comparison():
    """The cell's check at this size: the bf16 program reads under
    ``se-bf16-clips``' ``out_err`` limit, the reference in fp8 put in its
    place above it."""
    from benchmark.tools.readings import readings
    cell = spec.load_cell("se-bf16-clips")
    config = _config("bfloat16")
    mix = dict(cell.mix, clips=2, frames=4, pool=2, warmup_calls=1)
    out = readings(cell, 21, 0.2, ["fp8"], "cpu", config=config, mix=mix)
    limit = cell.limits["out_err"]
    assert out["program"]["out_err"] < limit < out["fp8"]["out_err"]


def test_schema_is_the_ports_state_dict_in_order(case):
    """The reference's schema names the port's ``state_dict`` leaves, with
    their shapes, in the port's order (the gates right after ``bn3``)."""
    want = [(k, tuple(v.shape))
            for k, v in case["model"].state_dict().items()]
    got = [(n, s) for n, s, _, _ in senet.schema(case["cfg"])]
    assert got == want
    kinds = {n: k for n, _, k, _ in senet.schema(case["cfg"])}
    assert kinds["backbone.layer4.2.se.fc1.weight"] == "conv"
    assert kinds["backbone.layer4.2.se.fc2.bias"] == "linear"
    assert tuple(case["state"]["backbone.layer4.2.se.fc1.weight"].shape) \
        == (128, 2048, 1, 1)


# -- the gate's plain passes ------------------------------------------------

def _nhwc(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _gate(gen, c, r, dtype):
    w1 = (torch.randn((c // r, c), generator=gen) / c ** 0.5).to(dtype)
    w2 = (torch.randn((c, c // r), generator=gen) / (c // r) ** 0.5).to(dtype)
    return (w1, (torch.randn(c // r, generator=gen) * 0.1).to(dtype),
            w2, (torch.randn(c, generator=gen) * 0.1).to(dtype))


@pytest.mark.parametrize("projection", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gate_plain_is_pytorchs_chain_bit_for_bit(dtype, projection):
    """squeeze -> excite -> scale through the plain versions equals
    PyTorch's own ops on conv3's biased output, as ``bottleneck_library``
    composes them, bit for bit; in place through the CPU wrappers too."""
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(9)
    shape = (3, 32, 5, 4)
    y = _nhwc(gen, shape, dt, 2.0)
    bias = (torch.randn(32, generator=gen) * 0.5).to(dt)
    res = _nhwc(gen, shape, dt, 2.0)
    res_bias = (torch.randn(32, generator=gen) * 0.5).to(dt) if projection \
        else None
    gate = _gate(gen, 32, 4, dt)
    u = y + bias.reshape(1, -1, 1, 1)
    r = res + res_bias.reshape(1, -1, 1, 1) if projection else res
    want = F.relu(u * be.excite(be.se_mean(u), gate)[:, :, None, None] + r)
    g = be.excite(be.se_squeeze_plain(y, bias), gate)
    got = be.se_scale_plain(y, bias, g, res, res_bias)
    assert got.dtype == dt and torch.equal(got, want)
    assert torch.equal(be.se_squeeze(y, bias), be.se_squeeze_plain(y, bias))
    out = be.se_scale(y, bias, g, res, res_bias)
    assert out is y and torch.equal(y, want)


def test_gate_rounds_the_product_before_the_add():
    """rnd(rnd(u g) + r): in bf16, 1.5 * (1 + 2^-7) rounds to 1.5 + 2^-6
    before 2^-8 is added, which then rounds away."""
    y = torch.full((1, 8, 1, 1), 1.5, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    zero = torch.zeros(8, dtype=torch.bfloat16)
    g = torch.full((1, 8), 1 + 2 ** -7, dtype=torch.bfloat16)
    res = torch.full_like(y, 2.0 ** -8)
    got = be.se_scale_plain(y, zero, g, res)
    assert torch.equal(got, torch.full_like(y, 1.5 + 2 ** -6))


@pytest.mark.parametrize("case_", ["gate_shape", "gate_dtype", "frames",
                                   "no_res"])
def test_se_wrappers_raise(case_):
    gen = torch.Generator().manual_seed(1)
    y = _nhwc(gen, (2, 16, 3, 3), torch.bfloat16)
    bias = torch.zeros(16, dtype=torch.bfloat16)
    g = torch.ones((2, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        if case_ == "gate_shape":
            be.se_scale(y, bias, g[:1], y.clone())
        elif case_ == "gate_dtype":
            be.se_scale(y, bias, g.float(), y.clone())
        elif case_ == "frames":
            big = torch.zeros((be.MAX_FRAMES + 1, 8, 1, 1),
                              dtype=torch.bfloat16)
            be.se_squeeze(big, torch.zeros(8, dtype=torch.bfloat16))
        else:
            be.se_scale(y, bias, g, None)


# -- the backbone -----------------------------------------------------------

def _model(dtype: str, size: int = 64) -> ResNet50:
    """An SE-ResNet-50 of seeded weights and BatchNorm statistics (so that
    every folded bias is nonzero)."""
    torch.manual_seed(0)
    model = ResNet50(BackboneSpec(input_size=size, dtype=dtype,
                                  se_reduction=16))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    return model.eval()


def _folded(dtype: str, size: int = 64, device: str = "cpu"
            ) -> FoldedResNet50:
    """The folded form of :func:`_model`, for crops of size / 2."""
    model = _model(dtype, size)
    return FoldedResNet50(fold_batchnorm(model.to(device)), model.spec)


def _crops(n: int, s: int, device: str = "cpu") -> torch.Tensor:
    gen = torch.Generator().manual_seed(2)
    return (torch.rand((n, s, s, 3), generator=gen) * 255).to(device)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_se_layout_and_layer2_route(dtype):
    """Every stage runs as folded convs, layer2 too in bf16, and every
    block carries its gate in the work dtype."""
    fb = _folded(dtype)
    dt = DTYPES[dtype]
    assert fb.layer2 is None and fb.run_layer2 == fb._layer2_convs
    assert sorted(fb.stages) == [1, 2, 3, 4]
    for blocks in fb.stages.values():
        for blk in blocks:
            w1, b1, w2, b2 = blk["se"]
            c = blk["conv3"][0].shape[0]
            assert tuple(w1.shape) == (c // 16, c)
            assert tuple(w2.shape) == (c, c // 16)
            assert tuple(b1.shape) == (c // 16,) and tuple(b2.shape) == (c,)
            assert {t.dtype for t in blk["se"]} == {dt}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_folded_matches_the_unfolded_model(dtype):
    """The folded backbone against the unfolded ``ResNet50.forward`` in
    eval mode (the fine-tuning form): same gates, BN folded. fp32: fold
    round-off (reads ~8e-7); bf16: the two round at other places, folded
    weights against BN after each conv (reads ~7e-3), held at the bf16
    kernels' gate, 2e-2."""
    model = _model(dtype)
    fb = FoldedResNet50(fold_batchnorm(model), model.spec)
    crops = _crops(2, 32)
    with torch.no_grad():
        emb, _ = fb(crops)
        want, _ = model(preprocess.for_backbone(crops, model.spec))
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    assert (emb - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_card_route_on_the_cpu(dtype, monkeypatch):
    """The card's route (convs without bias; epilogues after conv1 and
    conv2; squeeze, excite and scale after conv3 under ``backbone.se``),
    forced on the CPU where the passes run their plain versions: 16 of
    each SE pass, 32 epilogues, and embeddings within rounding of
    PyTorch's chain (the CPU convs fold the bias in before they round)."""
    fb = _folded(dtype)
    crops = _crops(2, 32)
    want_emb, want_logits = fb(crops)
    seen = {"epilogue": 0, "se_squeeze": 0, "se_scale": 0}
    for name in seen:
        real = getattr(be, name)

        def counted(*args, _name=name, _real=real):
            seen[_name] += 1
            return _real(*args)
        monkeypatch.setattr(be, name, counted)
    monkeypatch.setattr(FoldedResNet50, "_bottleneck",
                        staticmethod(be.bottleneck_epilogues))
    emb, logits = fb(crops)
    assert seen == {"epilogue": 32, "se_squeeze": 16, "se_scale": 16}
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    assert (emb - want_emb).abs().max() <= tol * want_emb.abs().max()
    assert (logits - want_logits).abs().max() <= tol * \
        want_logits.abs().max()


def test_gate_span_around_each_block():
    fb = _folded("float32")
    tracing.enable()
    try:
        fb(_crops(1, 32))
    finally:
        tracing.enable(False)
    names = [r.name for r in tracing.collect()]
    assert names.count("backbone.se") == 16


# -- weights ------------------------------------------------------------------

def test_state_dict_with_gates_loads_only_into_an_se_spec(case):
    """Through ``Mimamo.load_state_dict`` (strict): the gates' 64 leaves
    load into an SE spec's model, which then predicts as the model built on
    them; a plain spec refuses them, and an SE spec refuses a state
    without them."""
    state = case["state"]
    assert len([k for k in state if ".se.fc" in k]) == 16 * 4
    se = program.build_model(case["cfg"],
                             data.make_weights(case["cfg"], 6, "cpu"), "cpu")
    se.load_state_dict(state)
    assert torch.equal(se.predict_clips(case["clips"]),
                       case["model"].predict_clips(case["clips"]))
    with pytest.raises(RuntimeError, match="Missing key.*se\\.fc1"):
        se.load_state_dict({k: v for k, v in state.items()
                            if ".se." not in k})
    plain_cfg = _mimamo(case["cfg"])
    plain = program.build_model(plain_cfg, data.make_weights(plain_cfg, 5,
                                                             "cpu"), "cpu")
    with pytest.raises(RuntimeError, match="Unexpected key.*se\\.fc1"):
        plain.load_state_dict(state)


def _mimamo(cfg: dict) -> dict:
    """``cfg`` as the plain MIMAMO-Net configuration (no gate key)."""
    c = copy.deepcopy(cfg)
    del c["reference"]
    del c["backbone"]["se_reduction"]
    return c


@pytest.mark.parametrize("value,ok", [(0, True), (1, True), (16, True),
                                      (256, True), (-16, False), (3, False),
                                      (512, False)])
def test_backbone_spec_checks_se_reduction(value, ok):
    if ok:
        assert BackboneSpec(se_reduction=value).se_reduction == value
    else:
        with pytest.raises(ValueError, match="se_reduction"):
            BackboneSpec(se_reduction=value)


# -- the references' refusals -------------------------------------------------

def test_mimamo_reference_still_refuses_se_reduction():
    with pytest.raises(ValueError,
                       match="backbone: .*'mimamo'.*'se_reduction'"):
        mimamo.check_supported(_config())


@pytest.mark.parametrize("value", [None, 0, -16, 3, 16.0, True])
def test_senet_reference_refuses_what_it_does_not_compute(value):
    cfg = _config()
    if value is None:
        del cfg["backbone"]["se_reduction"]
    else:
        cfg["backbone"]["se_reduction"] = value
    with pytest.raises(ValueError, match="'senet' computes se_reduction"):
        senet.check_supported(cfg)
    cfg = _config()
    cfg["temporal"]["attention_heads"] = 4
    with pytest.raises(ValueError, match="temporal: .*'senet'"):
        senet.check_supported(cfg)


# -- the session and the train steps ------------------------------------------

def test_session_matches_the_reference(case):
    """Two streams through one ``StreamingSession`` of 4 slots in chunks
    of 3 give the reference's clip-mode outputs."""
    clips = case["clips"].numpy()
    session = StreamingSession(case["model"], capacity=4, chunk=3)
    slots = [session.add_stream(), session.add_stream()]
    outs = {slot: [] for slot in slots}
    for i in range(0, 6, 3):
        got = session.feed({slot: clips[j, i:i + 3]
                            for j, slot in enumerate(slots)})
        for slot in slots:
            outs[slot].append(got[slot])
    for j, slot in enumerate(slots):
        assert _gap(np.concatenate(outs[slot]), case["want"][j]) < REL_TOL


def _batch(clips: torch.Tensor) -> dict:
    b, t = clips.shape[:2]
    gen = torch.Generator().manual_seed(3)
    return {"clips": clips, "labels": torch.rand((b, t, 2), generator=gen)
            * 2 - 1, "mask": torch.ones((b, t))}


@pytest.mark.parametrize("freeze", [True, False])
def test_train_step_runs_with_gates(case, freeze):
    """The frozen-backbone step leaves the gates alone and trains the
    temporal model; the fine-tuning step (unfolded, remat) moves the
    gates too."""
    cfg = copy.deepcopy(case["cfg"])
    cfg["train"]["freeze_backbone"] = freeze
    model = program.build_model(cfg, case["state"], "cpu")
    state = train.create_train_state(model)
    step = train.make_train_step(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, metrics = step(state, _batch(case["clips"]))
    assert torch.isfinite(metrics["loss"])
    after = model.state_dict()
    gate = "backbone.layer3.1.se.fc2.weight"
    assert torch.equal(after[gate], before[gate]) == freeze
    assert not torch.equal(after["temporal.head.weight"],
                           before["temporal.head.weight"])


# -- on the card -------------------------------------------------------------

CARD_FRAMES = {"bfloat16": 384, "float32": 192}   # as the epilogue's tests


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SE kernels run only there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_backbone():
    """Per dtype, lazily: the folded SE backbone on the card at the full
    input size, and crops of the benchmark's batch (bf16) or half of it."""
    cache = {}

    def get(dtype: str = "bfloat16"):
        if dtype not in cache:
            cache.clear()
            torch.cuda.empty_cache()
            cache[dtype] = (_folded(dtype, 224, "cuda"),
                            _crops(CARD_FRAMES[dtype], 112, "cuda"))
        return cache[dtype]
    return get


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in bf16 steps between ``a`` and ``b`` (finite,
    of one sign or zero)."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    return int((ia - ib).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("dtype", list(DTYPES))
@torch.no_grad()
def test_card_kernels_at_every_se_block(card, card_backbone, dtype):
    """At each of the 16 blocks, on the block's real input: the squeeze
    kernel against its plain version (sums in other orders: in bf16 at
    most one step apart once rounded, in fp32 within 1e-5 of the means'
    scale), the scale kernel against its plain version on the same gate
    (``torch.equal``), and the block against PyTorch's chain (gates that
    differ by a rounding move outputs by about as much: within 2e-2
    relative in bf16, the bf16 kernels' gate, and 1e-5 in fp32, the fp32
    route's)."""
    fb, crops = card_backbone(dtype)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    x = fb.run_stem(crops)
    for stage in (1, 2, 3, 4):
        for blk in fb.stages[stage]:
            y1 = be.epilogue(be._conv(x, blk["conv1"], bias=False),
                             blk["conv1"][1])
            y2 = be.epilogue(be._conv(y1, blk["conv2"], bias=False),
                             blk["conv2"][1])
            y3 = be._conv(y2, blk["conv3"], bias=False)
            b3 = blk["conv3"][1]
            s = be.se_squeeze(y3, b3)
            plain_s = be.se_squeeze_plain(y3, b3)
            if dtype == "bfloat16":
                assert _bf16_ulps(s, plain_s) <= 1
            else:
                assert (s - plain_s).abs().max() <= \
                    1e-5 * plain_s.abs().max()
            g = be.excite(s, blk["se"])
            args = ((be._conv(x, blk["downsample"], bias=False),
                     blk["downsample"][1]) if "downsample" in blk
                    else (x, None))
            got = be.se_scale(y3.clone(), b3, g, *args)
            assert torch.equal(got, be.se_scale_plain(y3, b3, g, *args))
            want = be.bottleneck_library(x, blk)
            assert torch.isfinite(got).all()
            assert (got.float() - want.float()).abs().max() <= \
                tol * want.float().abs().max()
            x = want


@pytest.mark.card
@torch.no_grad()
def test_card_squeeze_is_batch_invariant(card, card_backbone):
    """A frame's squeezed means have the same bits alone, in a batch of 3
    and in the whole batch (fixed order, no atomics)."""
    fb, crops = card_backbone()
    x = fb.run_stem(crops)
    blk = fb.stages[1][0]
    y = be._conv(be.epilogue(be._conv(be.epilogue(
        be._conv(x, blk["conv1"], bias=False), blk["conv1"][1]),
        blk["conv2"], bias=False), blk["conv2"][1]), blk["conv3"],
        bias=False)
    b3 = blk["conv3"][1]
    whole = be.se_squeeze(y, b3)
    n = crops.shape[0]
    for lo, hi in ((5, 6), (100, 103), (n - 1, n)):
        assert torch.equal(be.se_squeeze(y[lo:hi].contiguous(
            memory_format=torch.channels_last), b3), whole[lo:hi])
    assert torch.equal(be.se_squeeze(y, b3), whole)       # run to run


@pytest.mark.card
@torch.no_grad()
def test_card_backbone_against_pytorchs_chain(card, card_backbone,
                                              monkeypatch):
    fb, crops = card_backbone()
    emb, logits = fb(crops)
    monkeypatch.setattr(FoldedResNet50, "_bottleneck",
                        staticmethod(be.bottleneck_library))
    want, _ = fb(crops)
    assert torch.isfinite(emb).all()
    assert (emb - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.card
@pytest.mark.parametrize("dtype", list(DTYPES))
@torch.no_grad()
def test_card_launches_per_backbone_call(card, card_backbone, dtype):
    """One SE backbone call: the stem kernel of its dtype once, no layer2
    kernel, the epilogue after conv1 and conv2 of each of the 16 blocks,
    one squeeze and one scale a block."""
    from mimamo_tpu_torch.kernels import layer2_kernel, stem_kernel
    fb, crops = card_backbone(dtype)
    kernels = {"stem": stem_kernel.KERNEL if dtype == "bfloat16"
               else stem_kernel.KERNEL_F32, "layer2": layer2_kernel.KERNEL,
               "epilogue": be.KERNEL, "squeeze": be.SQUEEZE,
               "scale": be.SCALE}
    for k in kernels.values():
        k.launches = 0
    fb(crops[:8])
    torch.cuda.synchronize()
    assert {n: k.launches for n, k in kernels.items()} == {
        "stem": 1, "layer2": 0, "epilogue": 32, "squeeze": 16, "scale": 16}
