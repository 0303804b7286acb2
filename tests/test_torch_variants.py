"""The model variants of the port against the JAX package: the stream
ablations (``streams="micro" | "macro"``), stacked GRUs, snippet pooling,
``appearance_stride`` and a backbone input other than twice the crop.

``TwoStreamRNN`` is held against the JAX ``TwoStreamRNN`` (outputs and
carries, clip mode and a streamed second chunk, atol 1e-5),
``predict_clips`` against the JAX ``predict_clips`` in f32 (atol 1e-3, the
gate of ``test_predict_clips_matches_jax_f32``), and ``FoldedResNet50`` at
a non-2x input against the JAX ``Mimamo._apply_fused`` (f32: atol 2e-4,
rtol 1e-3; bf16: the embeddings' max-rel < 2e-2 of
``test_embed_frames_matches_jax_bf16``). Weights come over by
``weights.from_jax_variables``; inputs are seeded numpy. Each variant's JAX
reference is computed once per module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimamo_tpu import config as jc
from mimamo_tpu import temporal as jtemporal
from mimamo_tpu.runner import Mimamo as JaxMimamo
from mimamo_tpu_torch import config as tc
from mimamo_tpu_torch import temporal as ttemporal
from mimamo_tpu_torch import weights
from mimamo_tpu_torch.backbone import FoldedResNet50, fold_batchnorm
from mimamo_tpu_torch.kernels import layer2_kernel, phase_kernel, stem_kernel
from mimamo_tpu_torch.runner import Mimamo, stride_anchor_plan

from test_torch_backbone_temporal import SMALL_TEMPORAL, _randomize_bn

# crop 16 -> backbone 32; 2 scales x 2 orientations; phase maps 8^2
B, T, S = 1, 8, 16
TEMPORAL = {"micro": {"streams": "micro"}, "macro": {"streams": "macro"},
            "gru2": {"gru_layers": 2}, "snippet4": {"snippet_len": 4},
            "gru2_micro": {"gru_layers": 2, "streams": "micro"}}
VARIANTS = {**{k: (v, {}) for k, v in TEMPORAL.items()},
            "stride2": ({}, {"appearance_stride": 2}),
            "stride3": ({}, {"appearance_stride": 3})}
# measured max |d| of predict_clips against JAX, f32 (CHANGES.md)
ATOL_F32 = 1e-3


def configs(temporal=None, backbone=None, s=S):
    """(JAX config, port config) of one variant."""
    temporal, backbone = dict(temporal or {}), dict(backbone or {})
    backbone.setdefault("input_size", 2 * s)

    def build(m):
        return m.MimamoConfig(
            pyramid=m.PyramidSpec(height=2, orientations=2,
                                  input_size=(s, s)),
            phase=m.PhaseSpec(phase_size=8),
            backbone=m.BackboneSpec(**backbone),
            temporal=m.TemporalSpec(**SMALL_TEMPORAL, **temporal),
            clip=m.ClipSpec(clip_len=T, stride=4, crop_size=s))

    return build(jc), build(tc)


def jax_variables(jcfg, seed=0):
    variables = JaxMimamo(jcfg).init_variables(jax.random.PRNGKey(seed),
                                               clip_len=T)
    return _randomize_bn(jax.tree_util.tree_map(np.asarray, variables),
                         seed)


def port(tcfg, variables):
    model = Mimamo(tcfg, device="cpu")
    model.load_state_dict(weights.from_jax_variables(variables))
    return model


# -- TwoStreamRNN ------------------------------------------------------------

@pytest.fixture(scope="module", params=list(TEMPORAL))
def rnn_case(request):
    """One temporal variant: inputs, JAX variables and the JAX outputs and
    carries of clip mode and of a streamed second chunk."""
    b, t, c, p, f = 2, 8, 4, 16, 32
    rng = np.random.default_rng(3)
    phase = rng.uniform(-np.pi, np.pi, (b, 2 * t, c, p, p)).astype(
        np.float32)
    feats = rng.standard_normal((b, 2 * t, f)).astype(np.float32)
    kw = TEMPORAL[request.param]
    jspec = jc.TemporalSpec(**SMALL_TEMPORAL, **kw)
    jmodel = jtemporal.TwoStreamRNN(jspec)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(phase[:, 1:t]),
                            jnp.asarray(feats[:, :t]))
    variables = _randomize_bn(jax.tree_util.tree_map(np.asarray, variables),
                              seed=4)
    # clip mode on frames 0..t-1, then frames t..2t-1 as a streamed chunk
    # (their t pairs, the carries of the first)
    clip_in = (phase[:, 1:t], feats[:, :t])
    chunk_in = (phase[:, t:], feats[:, t:])
    out1, carries = jmodel.apply(variables, *map(jnp.asarray, clip_in),
                                 num_frames=t)
    out2, carries2 = jmodel.apply(variables, *map(jnp.asarray, chunk_in),
                                  carries, num_frames=t)
    tmodel = ttemporal.TwoStreamRNN(tc.TemporalSpec(**SMALL_TEMPORAL, **kw),
                                    c, p, f).eval()
    tmodel.load_state_dict(weights.temporal_from_jax(variables), strict=True)
    want = [np.asarray(x) for x in (out1, *carries, out2, *carries2)]
    return request.param, tmodel, clip_in, chunk_in, want


def test_two_stream_rnn_variants_match_jax(rnn_case):
    """Outputs and both carries, clip mode and a second chunk fed the
    first's carries, against the JAX model: atol 1e-5. The inactive
    stream's input is None and its carry passes through as zeros."""
    name, tmodel, clip_in, chunk_in, want = rnn_case
    spec = tmodel.spec

    def inputs(pair):
        ph, ft = (torch.from_numpy(x) for x in pair)
        return (ph if spec.use_micro else None,
                ft if spec.use_macro else None)

    t = clip_in[1].shape[1]
    with torch.no_grad():
        out1, carries = tmodel(*inputs(clip_in), num_frames=t)
        out2, carries2 = tmodel(*inputs(chunk_in), carries, num_frames=t)
    got = [x.numpy() for x in (out1, *carries, out2, *carries2)]
    layers = spec.gru_layers
    shape = (2, 16) if layers == 1 else (layers, 2, 16)
    assert got[1].shape == got[2].shape == shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
    if not spec.use_macro:
        assert not got[2].any() and not got[5].any()


def test_single_stream_state_dict_has_no_inactive_tensors(rnn_case):
    """A single-stream model creates no module of the other stream, and
    its fusion layer takes one stream's H inputs."""
    _name, tmodel, *_ = rnn_case
    keys = tmodel.state_dict().keys()
    spec = tmodel.spec
    assert any(k.startswith("gru_micro.") for k in keys) == spec.use_micro
    assert any(k.startswith("micro_cnn.") for k in keys) == spec.use_micro
    assert any(k.startswith("gru_macro.") for k in keys) == spec.use_macro
    assert any(k.startswith("macro_proj.") for k in keys) == spec.use_macro
    streams = int(spec.use_micro) + int(spec.use_macro)
    assert tmodel.fusion.in_features == streams * spec.gru_hidden
    assert (f"gru_{'micro' if spec.use_micro else 'macro'}.weight_ih_l1"
            in keys) == (spec.gru_layers > 1)


def test_two_stream_rnn_rejects_bad_inputs():
    """An indivisible snippet length and a missing active input raise, as
    in the JAX package (tests/test_temporal.py)."""
    c, p, f = 4, 16, 32
    rng = np.random.default_rng(0)
    phase = torch.from_numpy(rng.standard_normal((1, 7, c, p, p)).astype(
        np.float32))
    feats = torch.from_numpy(rng.standard_normal((1, 8, f)).astype(
        np.float32))
    model = ttemporal.TwoStreamRNN(
        tc.TemporalSpec(**SMALL_TEMPORAL, snippet_len=3), c, p, f)
    with pytest.raises(ValueError, match="snippet_len"):
        model(phase, feats)
    for streams, args in (("micro", (None, feats)), ("macro", (phase, None)),
                          ("both", (None, feats)), ("both", (phase, None))):
        model = ttemporal.TwoStreamRNN(
            tc.TemporalSpec(**SMALL_TEMPORAL, streams=streams), c, p, f)
        with pytest.raises(ValueError, match="needs"):
            model(*args)


# -- predict_clips -------------------------------------------------------------

@pytest.fixture(scope="module")
def clips():
    return np.random.default_rng(0).integers(0, 256, (B, T, S, S, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module", params=list(VARIANTS))
def clip_case(request, clips):
    """One variant: the port model with the JAX weights and the JAX
    ``predict_clips`` of the clips."""
    jcfg, tcfg = configs(*VARIANTS[request.param])
    variables = jax_variables(jcfg)
    want = np.asarray(JaxMimamo(jcfg).predict_clips(variables,
                                                    jnp.asarray(clips)))
    return request.param, port(tcfg, variables), want


def test_predict_clips_variants_match_jax(clip_case, clips, monkeypatch):
    """f32 ``predict_clips`` of each variant against JAX at atol 1e-3, and
    the kernel wrappers it reaches: a micro-only model runs no stem and no
    layer2, a macro-only one no phase stage; at stride k the backbone sees
    ceil(T / k) frames, as one contiguous batch (the kernel's layout)."""
    name, model, want = clip_case
    calls = {"phase": 0, "stem": 0}

    def count(mod, attr, key, frames):
        real = getattr(mod, attr)

        def wrapped(x, *a, **kw):
            calls[key] += frames(x)
            return real(x, *a, **kw)
        monkeypatch.setattr(mod, attr, wrapped)

    count(phase_kernel, "micro_motion_features_fused", "phase",
          lambda x: 1)
    # the stem kernel reads one dense array: the anchors of a stride too
    count(stem_kernel, "stem_fused", "stem",
          lambda x: x.shape[0] if x.is_contiguous() else float("nan"))
    got = model.predict_clips(clips)
    assert got.shape == (B, T, 2)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= ATOL_F32, (name, err)
    spec = model.config.temporal
    k = model.config.backbone.appearance_stride
    assert calls == {"phase": int(spec.use_micro),
                     "stem": B * -(-T // k) if spec.use_macro else 0}, name


@pytest.mark.parametrize("k", [2, 3])
def test_stride_anchors_are_exact(clips, k):
    """At stride k the anchor frames' embeddings are the stride-1
    embeddings of those frames, bit for bit; the others are the lerp of
    ``stride_anchor_plan`` (frames past the last anchor hold it)."""
    jcfg, tcfg = configs()
    variables = jax_variables(jcfg)
    full = port(tcfg, variables)
    strided = port(dataclasses.replace(tcfg, backbone=dataclasses.replace(
        tcfg.backbone, appearance_stride=k)), variables)
    x = torch.from_numpy(clips).float()
    with torch.no_grad():
        want = full.embed_frames(x)
        got = strided.embed_frames(x)
        anchors = full.embed_frames(x[:, ::k])
    assert torch.equal(got[:, ::k], anchors)
    assert torch.equal(anchors, want[:, ::k])
    i0, i1, frac = stride_anchor_plan(T, k)
    lerp = (anchors[:, i0] * (1 - torch.from_numpy(frac)[None, :, None])
            + anchors[:, i1] * torch.from_numpy(frac)[None, :, None])
    assert torch.equal(got, lerp)
    assert (i0[-1], frac[-1]) == ((T - 1) // k, 0.0)


def test_macro_only_output_independent_of_motion():
    """Appearance-identical first frames with different motion after them
    give a macro-only model the same frame-0 prediction (the micro stream
    is not computed), and a two-stream model different ones
    (tests/test_runner.py)."""
    rng = np.random.default_rng(1)
    base = rng.uniform(40, 215, (1, T, S, S, 3)).astype(np.float32)
    moved = base.copy()
    moved[:, 1:] = np.roll(moved[:, 1:], 2, axis=3)
    outs = {}
    for streams in ("macro", "both"):
        jcfg, tcfg = configs({"streams": streams})
        model = port(tcfg, jax_variables(jcfg))
        outs[streams] = [model.predict_clips(torch.from_numpy(c)).numpy()
                         for c in (base, moved)]
    a, b = outs["macro"]
    np.testing.assert_allclose(a[:, 0], b[:, 0], atol=1e-6)
    a, b = outs["both"]
    assert np.abs(a - b).max() > 1e-6


# -- a backbone input other than twice the crop ---------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [16, 24])
def test_folded_resnet_non_2x_matches_jax(size, dtype):
    """Crops of 16 into a backbone of 16 (no resize) and of 24 (bilinear
    resize), through the resize route (no stem kernel) against the JAX
    ``_apply_fused`` (its general ``for_backbone`` branch): f32 atol 2e-4,
    rtol 1e-3 on embeddings and logits; bf16 embeddings max-rel < 2e-2."""
    backbone = {"input_size": size, "dtype": dtype, "channel_order": "bgr"}
    jcfg, tcfg = configs(backbone=backbone)
    variables = jax_variables(jcfg)
    crops = np.random.default_rng(2).uniform(0, 255, (3, S, S, 3)).astype(
        np.float32)
    want_emb, want_logits = JaxMimamo(jcfg)._apply_fused(
        variables, jnp.asarray(crops))
    model = port(tcfg, variables)
    folded = model._backbone_folded()
    assert folded.run_stem == folded._stem_resized and folded.stem is None
    with torch.no_grad():
        emb, logits = folded(torch.from_numpy(crops))
    want_emb = np.asarray(want_emb, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(emb.numpy(), want_emb, atol=2e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                                   atol=2e-4, rtol=1e-3)
    else:
        rel = np.abs(emb.numpy() - want_emb).max() / np.abs(want_emb).max()
        assert rel < 2e-2, rel


def test_non_2x_route_reaches_layer2_kernel_in_bf16(monkeypatch):
    """At a backbone input of 2 x 16 = 32 the stem kernel runs; at 16 the
    resize route runs, and in bf16 layer2 still goes through its wrapper,
    on the smaller grid ([N, 4, 4, 256] -> [N, 2, 2, 512])."""
    seen = []
    real = layer2_kernel.layer2_fused

    def spy(x, blocks):
        seen.append(tuple(x.shape))
        return real(x, blocks)

    monkeypatch.setattr(layer2_kernel, "layer2_fused", spy)
    jcfg, tcfg = configs(backbone={"input_size": S, "dtype": "bfloat16"})
    folded = FoldedResNet50(fold_batchnorm(port(tcfg, jax_variables(
        jcfg)).backbone), tcfg.backbone, (S, S))
    folded(torch.rand((2, S, S, 3)) * 255)
    assert seen == [(2, 4, 4, 256)]
    with pytest.raises(ValueError, match="built for"):
        folded(torch.rand((2, 2 * S, 2 * S, 3)))
