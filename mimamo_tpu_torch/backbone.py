"""ResNet-50 FER+ appearance backbone for the macro stream (PyTorch).

Counterpart of ``mimamo_tpu/backbone.py``. :class:`ResNet50` holds the
parameters in the canonical torchvision schema (``conv1.weight``,
``layer1.0.bn2.running_var``, ``layer2.0.downsample.0.weight``, ``fc.*``;
docs/WEIGHTS.md), by default with the Caffe/MatConvNet stride placement
(``stride_in_1x1``: block 0 of layers 2-4 strides its first 1x1 conv) that
converted FER+ checkpoints expect; ``stride_in_1x1=False`` is the
torchvision v1.5 placement (block 0 strides its 3x3 conv2), as in the JAX
package, reached by no config field. Both placements have the same keys.
Inference runs the BN-folded form, :class:`FoldedResNet50`, built by
:func:`fold_batchnorm`:

  * stem: for a crop of exactly half ``input_size``, ``kernels.
    stem_kernel`` (upscale + conv1 + relu + max pool from the crop;
    replaces the JAX path's ``composite_stem``), in the configured dtype
    (bf16 or fp32 kernel); at any other ratio (``--backbone-size 112`` of
    a 112 crop, for one), ``preprocess.for_backbone``'s bilinear resize,
    then conv1 + relu + max pool as ``F.conv2d`` / ``F.max_pool2d``, as
    the JAX package runs it (both of its fused stems take only the exact
    2x);
  * layer1, layer3, layer4: ``F.conv2d`` in channels_last, in the
    configured dtype (XLA lowered these outside any Pallas kernel); on the
    card each conv runs on cuDNN without its bias, and ``kernels.
    bottleneck_epilogue`` adds the bias (and the residual) and applies
    relu in one pass, bit for bit PyTorch's own ops;
  * layer2: ``kernels.layer2_kernel`` in bf16 (under the 3x3 placement
    block 0 as ``F.conv2d``, blocks 1-3 through the kernel: it computes
    block 0 in the 1x1 placement only); ``F.conv2d`` like the other stages
    in fp32, as the JAX package routes it (its Pallas layer2 is bf16-only,
    so an fp32 backbone runs layer2 as XLA convs);
  * pool5: mean over space, the 2048-d embedding, and the FER+ ``fc``.

SE-ResNet-50 (``BackboneSpec.se_reduction`` r > 0; Hu et al.,
arXiv:1709.01507, as ``senet50_ferplus_dag``): every bottleneck has a
squeeze-and-excitation gate, ``se.fc1`` (C -> C / r) and ``se.fc2`` (C / r
-> C), 1x1 convs with bias, between conv3 (after its BN) and the residual
add: ``out = relu(u * sigmoid(fc2(relu(fc1(mean_hw(u))))) + shortcut)``.
The folded form carries the gate's weights unfolded (they act after BN)
and runs it through ``kernels.bottleneck_epilogue``'s SE passes on the
card; its layer2 runs as folded ``F.conv2d`` bottlenecks in every dtype
(:class:`FoldedResNet50`).

Fine-tuning runs the unfolded :meth:`ResNet50.forward` with training-mode
BatchNorm (``batchnorm.BatchNorm2d``) on ``preprocess.for_backbone`` input,
as plain autograd (cuDNN on the card): the kernels are inference-only. A
bf16 spec runs it as Flax's ``dtype=bfloat16`` modules do: fp32 parameters
(the optimizer's copy), each conv on its input and weight cast to bf16,
BatchNorm statistics and normalization in fp32 with a bf16 output, relu,
the residual add and the max pool in bf16, pool5 averaged to bf16 and fc
in fp32.

The reference's weights come in through :func:`load_torch_state_dict`
(torchvision names, or the FER+ MatConvNet ``dag`` names by
:func:`resolve_torch_names`), as ``cli convert`` reads them.

An SE spec's ``state_dict`` is ResNet-50's plus 64 gate tensors, one gate
per bottleneck (C the block's conv3 width: 256, 512, 1024, 2048 in layers
1-4): ``layer{s}.{b}.se.fc1.weight`` [C/r, C, 1, 1], ``.fc1.bias`` [C/r],
``.fc2.weight`` [C, C/r, 1, 1], ``.fc2.bias`` [C]. It loads through
``Mimamo.load_state_dict`` (strict, so a plain spec refuses the gates and
an SE spec wants them). :func:`load_torch_state_dict` and ``cli convert``
read ResNet-50 only: ``senet50_ferplus_dag``'s own names (believed to be
``conv{s}_{b}_1x1_down`` / ``_1x1_up`` for the gates) are mapped once that
file can be tested against.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from . import preprocess, tracing
from .batchnorm import BatchNorm2d, stats_frozen
from .config import BackboneSpec
from .kernels import bottleneck_epilogue, layer2_kernel, stem_kernel
from .preprocess import work_dtype

STAGE_SIZES = (3, 4, 6, 3)            # ResNet-50
STAGE_WIDTHS = (64, 128, 256, 512)    # bottleneck inner widths

# FER+ label order (Barsoum et al. 2016; the albanie ferplus models'
# classifier emits logits in this order — 8 classes incl. contempt).
FERPLUS_CLASSES = ("neutral", "happiness", "surprise", "sadness",
                   "anger", "disgust", "fear", "contempt")

Folded = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` in the dtype of ``x``: its fp32 weight cast to it, as
    Flax's ``nn.Conv(dtype=...)`` casts its kernel."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding)


def _gate(fc1: Tuple[torch.Tensor, torch.Tensor],
          fc2: Tuple[torch.Tensor, torch.Tensor], dtype: torch.dtype
          ) -> bottleneck_epilogue.Gate:
    """An SE gate's two 1x1 convs, (weight, bias) each, as ``F.linear``
    weights and biases in ``dtype``."""
    (w1, b1), (w2, b2) = fc1, fc2
    return (w1.flatten(1).to(dtype), b1.to(dtype), w2.flatten(1).to(dtype),
            b2.to(dtype))


def _strides(stride: int, stride_in_1x1: bool) -> Tuple[int, int]:
    """(conv1's stride, conv2's) of a block that strides by ``stride``."""
    return (stride, 1) if stride_in_1x1 else (1, stride)


class SqueezeExcite(nn.Module):
    """The squeeze-and-excitation gate of an SE-ResNet bottleneck over
    ``channels`` channels: ``fc1`` (-> channels / ``reduction``) and ``fc2``
    (-> channels), 1x1 convs with bias."""

    def __init__(self, channels: int, reduction: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """``u * gate`` for [N, C, H, W] ``u``, in its dtype: the mean over
        space summed in fp32 and rounded, each fc on inputs and weights of
        that dtype (``kernels.bottleneck_epilogue.excite``)."""
        g = bottleneck_epilogue.excite(
            bottleneck_epilogue.se_mean(u),
            _gate((self.fc1.weight, self.fc1.bias),
                  (self.fc2.weight, self.fc2.bias), u.dtype))
        return u * g[:, :, None, None]


class Bottleneck(nn.Module):
    """Bottleneck block; its ``forward`` is the unfolded (training) form,
    inference uses the folded one. ``stride_in_1x1``: the stride in conv1
    (Caffe) or, False, in conv2 (torchvision v1.5); the projection strides
    either way. ``se_reduction`` > 0 adds the gate ``se``
    (:class:`SqueezeExcite`) between bn3 and the residual add."""

    def __init__(self, inplanes: int, width: int, stride: int,
                 stride_in_1x1: bool = True, se_reduction: int = 0):
        super().__init__()
        s1, s2 = _strides(stride, stride_in_1x1)
        self.conv1 = nn.Conv2d(inplanes, width, 1, stride=s1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=s2, padding=1,
                               bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(width * 4)
        self.se = (SqueezeExcite(width * 4, se_reduction) if se_reduction
                   else None)
        self.downsample = None
        if stride != 1 or inplanes != width * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, width * 4, 1, stride=stride, bias=False),
                BatchNorm2d(width * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        if self.downsample is not None:
            res = self.downsample[1](_conv(self.downsample[0], x))
        y = F.relu(self.bn1(_conv(self.conv1, x)))
        y = F.relu(self.bn2(_conv(self.conv2, y)))
        y = self.bn3(_conv(self.conv3, y))
        if self.se is not None:
            y = self.se(y)
        return F.relu(y + res)


class ResNet50(nn.Module):
    """ResNet-50 parameters in the canonical torchvision schema, with the
    stride placement ``stride_in_1x1`` (:class:`Bottleneck`)."""

    def __init__(self, spec: BackboneSpec, stride_in_1x1: bool = True):
        super().__init__()
        self.spec = spec
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for i, (blocks, width) in enumerate(zip(STAGE_SIZES, STAGE_WIDTHS)):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(inplanes, width,
                                        2 if (i > 0 and b == 0) else 1,
                                        stride_in_1x1, spec.se_reduction))
                inplanes = width * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.fc = nn.Linear(spec.feature_dim, spec.num_classes)

    def _forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(work_dtype(self.spec))
        x = F.relu(self.bn1(_conv(self.conv1, x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(len(STAGE_SIZES)):
            x = getattr(self, f"layer{i + 1}")(x)
        # pool5: summed in fp32, rounded to the work dtype (jnp.mean)
        return x.to(torch.float32).mean(dim=(2, 3)).to(x.dtype).to(
            torch.float32)

    def forward(self, images: torch.Tensor, remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, H, W, 3] preprocessed images (``preprocess.for_backbone``)
        -> (pool5 embeddings [N, 2048] fp32, FER+ logits), unfolded, in the
        spec's dtype (module docstring), with each BatchNorm in the
        module's mode (training: batch statistics and one running-stat
        update per call).

        ``remat``: keep no activations for the backward pass and compute
        them again in it (``torch.utils.checkpoint``), as the JAX package's
        ``jax.checkpoint`` does under ``TrainSpec.remat_backbone``; the
        recomputation leaves the running stats alone."""
        if remat:
            emb = torch.utils.checkpoint.checkpoint(
                self._forward, images, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(),
                                    stats_frozen(self)))
        else:
            emb = self._forward(images)
        return emb, self.fc(emb)


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return (conv.weight * s[:, None, None, None],
            bn.bias - bn.running_mean * s)


@torch.no_grad()
def fold_batchnorm(model: ResNet50) -> Folded:
    """Fold inference-mode BN into conv weights and biases.

    ``gamma * (conv(x) - mean) / sqrt(var + eps) + beta`` becomes
    ``conv'(x) + bias'`` with ``weight' = weight * s`` over the output
    channel and ``bias' = beta - mean * s``, ``s = gamma / sqrt(var + eps)``.
    Returns fp32 (OIHW weight, bias) per conv, keyed by its torch name
    (``conv1``, ``layer2.0.conv1``, ``layer2.0.downsample``), plus ``fc``;
    an SE gate's 1x1 convs (``layer2.0.se.fc1``, ``.fc2``) unfolded, since
    they act after bn3.
    """
    out: Folded = {"conv1": _fold(model.conv1, model.bn1),
                   "fc": (model.fc.weight.clone(), model.fc.bias.clone())}
    for stage in range(len(STAGE_SIZES)):
        for b, blk in enumerate(getattr(model, f"layer{stage + 1}")):
            p = f"layer{stage + 1}.{b}."
            for i in (1, 2, 3):
                out[f"{p}conv{i}"] = _fold(getattr(blk, f"conv{i}"),
                                           getattr(blk, f"bn{i}"))
            if blk.downsample is not None:
                out[f"{p}downsample"] = _fold(blk.downsample[0],
                                              blk.downsample[1])
            if blk.se is not None:
                for fc in ("fc1", "fc2"):
                    conv = getattr(blk.se, fc)
                    out[f"{p}se.{fc}"] = (conv.weight.clone(),
                                          conv.bias.clone())
    return {k: (w.float(), b.float()) for k, (w, b) in out.items()}


class FoldedResNet50:
    """BN-folded inference ResNet-50 on raw crops of ``crop_hw`` (default:
    half ``spec.input_size``).

    Built once from :func:`fold_batchnorm`'s output; the weights are cast
    to the configured dtype and laid out for their consumers (the stem
    kernel, the layer2 kernel in bf16, channels_last ``F.conv2d`` for the
    other stages). Both routes are chosen here, once, on every device:
    ``run_stem`` is :meth:`_stem_kernel` when ``spec.input_size`` is
    exactly twice a square crop and :meth:`_stem_resized` otherwise (a
    route the config picks, not a fallback: the stem kernel computes only
    the exact 2x upscale); ``run_layer2`` is :meth:`_layer2_kernel` in
    bf16, :meth:`_layer2_tail_kernel` in bf16 under ``stride_in_1x1=False``
    (block 0 strides its 3x3 conv, a function the kernel does not compute:
    block 0 as ``F.conv2d``, blocks 1-3 through the kernel) and
    :meth:`_layer2_convs` in fp32 and in an SE configuration
    (``spec.se_reduction``) in every dtype: the gate needs each frame's
    whole conv3 map before the residual add, and ``layer2.cu``'s block
    kernel computes a bottleneck tile by tile, so it never holds one (a
    route the config picks, not a fallback). Every SE block carries its
    gate's weights (``se``) in the work dtype.
    """

    def __init__(self, folded: Folded, spec: BackboneSpec,
                 crop_hw: Optional[Tuple[int, int]] = None,
                 stride_in_1x1: bool = True):
        self.spec = spec
        self.stride_in_1x1 = stride_in_1x1
        self.crop_hw = tuple(crop_hw or (spec.input_size // 2,) * 2)
        dt = work_dtype(spec)
        h, w = self.crop_hw
        if spec.input_size == 2 * h == 2 * w:
            self.stem = stem_kernel.prepare_stem_weights(
                *folded["conv1"], spec.channel_order, dt)
            self.run_stem = self._stem_kernel
        else:
            w1, b1 = folded["conv1"]
            self.stem = None
            self.conv1 = (w1.to(dt).contiguous(
                memory_format=torch.channels_last), b1.to(dt))
            self.run_stem = self._stem_resized
        # the blocks of each stage that run as F.conv2d
        conv_blocks = dict(enumerate(STAGE_SIZES, 1))
        if dt == torch.bfloat16 and not spec.se_reduction:
            self.layer2 = layer2_kernel.pack_layer2_params(folded, dt,
                                                           stride_in_1x1)
            if stride_in_1x1:
                del conv_blocks[2]
                self.run_layer2 = self._layer2_kernel
            else:
                conv_blocks[2] = 1
                self.run_layer2 = self._layer2_tail_kernel
        else:
            self.layer2 = None
            self.run_layer2 = self._layer2_convs
        self.stages = {}
        for stage, n_blocks in conv_blocks.items():
            blocks = []
            for b in range(n_blocks):
                p = f"layer{stage}.{b}."
                s = 2 if stage > 1 and b == 0 else 1
                s1, s2 = _strides(s, stride_in_1x1)
                blk = {}
                for name, stride in (("conv1", s1), ("conv2", s2),
                                     ("conv3", 1), ("downsample", s)):
                    if p + name not in folded:
                        continue
                    w, bias = folded[p + name]
                    blk[name] = (
                        w.to(dt).contiguous(memory_format=torch.channels_last),
                        bias.to(dt), stride, w.shape[-1] // 2)
                if p + "se.fc1" in folded:
                    blk["se"] = _gate(folded[p + "se.fc1"],
                                      folded[p + "se.fc2"], dt)
                blocks.append(blk)
            self.stages[stage] = blocks
        self.fc = folded["fc"]

    _bottleneck = staticmethod(bottleneck_epilogue.bottleneck)
    # each SE block's gate: squeeze, excite and scale
    _gate_span = staticmethod(functools.partial(tracing.span, "backbone.se"))

    def _stage(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        for blk in self.stages[stage]:
            x = self._bottleneck(x, blk, self._gate_span)
        return x

    def _stem_kernel(self, crops: torch.Tensor) -> torch.Tensor:
        """upscale + conv1 + relu + pool through ``kernels.stem_kernel``
        (NCHW view of its NHWC output)."""
        return stem_kernel.stem_fused(crops, *self.stem,
                                      self.spec.mean_rgb).permute(0, 3, 1, 2)

    def _stem_resized(self, crops: torch.Tensor) -> torch.Tensor:
        """``preprocess.for_backbone`` (resize to ``input_size``, flip,
        mean) then conv1 + relu + 3x3/2 max pool, in the work dtype."""
        x = preprocess.for_backbone(crops, self.spec).permute(0, 3, 1, 2)
        x = F.conv2d(x.contiguous(memory_format=torch.channels_last),
                     *self.conv1, stride=2, padding=3)
        return F.max_pool2d(F.relu(x), 3, stride=2, padding=1)

    def _layer2_kernel(self, x: torch.Tensor) -> torch.Tensor:
        """layer2 through ``kernels.layer2_kernel`` (NCHW view of NHWC in
        and out)."""
        return layer2_kernel.layer2_fused(
            x.permute(0, 2, 3, 1).contiguous(), self.layer2).permute(0, 3, 1, 2)

    def _layer2_tail_kernel(self, x: torch.Tensor) -> torch.Tensor:
        """layer2 under the 3x3 stride placement: block 0 as folded
        ``F.conv2d`` (stride in conv2), blocks 1-3 through
        ``kernels.layer2_kernel``'s stride-1 tail."""
        y = self._stage(x, 2)                                # block 0 alone
        return layer2_kernel.layer2_fused(
            y.permute(0, 2, 3, 1).contiguous(), self.layer2).permute(0, 3, 1, 2)

    def _layer2_convs(self, x: torch.Tensor) -> torch.Tensor:
        """layer2 as four folded bottlenecks of ``F.conv2d``."""
        return self._stage(x, 2)

    def __call__(self, crops: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, H, W, 3] float32 RGB crops (0..255, (H, W) = ``crop_hw``) ->
        (pool5 embeddings [N, 2048] float32, FER+ logits [N, classes])."""
        if tuple(crops.shape[1:3]) != self.crop_hw:
            raise ValueError(
                f"crops {tuple(crops.shape[1:3])}: this backbone was built "
                f"for {self.crop_hw} crops (its stem route depends on it)")
        dev = crops.device
        with tracing.span("backbone.stem", dev):
            x = self.run_stem(crops)                     # NCHW view of NHWC
        with tracing.span("backbone.layer1", dev):
            x = self._stage(x, 1)
        with tracing.span("backbone.layer2", dev):
            x = self.run_layer2(x)
        with tracing.span("backbone.layer3", dev):
            x = self._stage(x, 3)
        with tracing.span("backbone.layer4", dev):
            x = self._stage(x, 4)
        with tracing.span("backbone.pool", dev):
            emb = x.to(torch.float32).mean(dim=(2, 3)).to(x.dtype)
            emb = emb.to(torch.float32)
            return emb, F.linear(emb, *self.fc)


# -- the reference's weight schema ---------------------------------------------

@functools.lru_cache(maxsize=1)
def canonical_keys() -> FrozenSet[str]:
    """The canonical torchvision names of a ResNet-50 ``state_dict``, as
    :class:`ResNet50` holds them (``num_batches_tracked`` left out): the key
    set that :func:`load_torch_state_dict` maps onto and checks against."""
    with torch.device("meta"):
        model = ResNet50(BackboneSpec())
    return frozenset(k for k in model.state_dict()
                     if not k.endswith("num_batches_tracked"))


def ferplus_dag_rename() -> Dict[str, str]:
    """``resnet50_ferplus_dag`` name -> canonical torchvision name, all 267
    parameter tensors.

    The FER+ checkpoint is a MatConvNet conversion whose module names follow
    the Caffe scheme: ``conv1_7x7_s2`` (+ ``_bn``), per bottleneck
    ``conv{stage+2}_{block+1}_1x1_reduce / _3x3 / _1x1_increase`` with
    ``_bn`` variants, ``_1x1_proj`` (+ ``_bn``) on each stage's first
    block, and a 1x1-conv ``classifier``. Its convs have no bias (the
    biases live in the BN layers); the classifier's [C, 2048, 1, 1] kernel
    is squeezed by :func:`normalize_dag_state_dict`, not here.
    """
    bn_parts = ("weight", "bias", "running_mean", "running_var")
    m = {"conv1_7x7_s2.weight": "conv1.weight",
         "classifier.weight": "fc.weight",
         "classifier.bias": "fc.bias"}
    for p in bn_parts:
        m[f"conv1_7x7_s2_bn.{p}"] = f"bn1.{p}"
    for stage, blocks in enumerate(STAGE_SIZES):
        for block in range(blocks):
            dp = f"conv{stage + 2}_{block + 1}"       # Caffe stage names
            cp = f"layer{stage + 1}.{block}"
            for suffix, i in (("1x1_reduce", 1), ("3x3", 2),
                              ("1x1_increase", 3)):
                m[f"{dp}_{suffix}.weight"] = f"{cp}.conv{i}.weight"
                for p in bn_parts:
                    m[f"{dp}_{suffix}_bn.{p}"] = f"{cp}.bn{i}.{p}"
            if block == 0:   # projection shortcut on the first block only
                m[f"{dp}_1x1_proj.weight"] = f"{cp}.downsample.0.weight"
                for p in bn_parts:
                    m[f"{dp}_1x1_proj_bn.{p}"] = f"{cp}.downsample.1.{p}"
    return m


def looks_like_ferplus_dag(state_dict: Dict[str, Any]) -> bool:
    """Does this ``state_dict`` use the MatConvNet ``dag`` names?"""
    return "conv1_7x7_s2.weight" in state_dict


def normalize_dag_state_dict(state_dict: Dict[str, Any]
                             ) -> Dict[str, np.ndarray]:
    """``dag``-named ``state_dict`` -> canonical torchvision names, as numpy
    arrays: :func:`ferplus_dag_rename`, and the 1x1-conv classifier kernel
    squeezed to [C, 2048] (any other kernel size raises ``ValueError``).
    ``num_batches_tracked`` is dropped; any other unknown key passes
    through, for :func:`load_torch_state_dict`'s strict mode to catch."""
    rename = ferplus_dag_rename()
    out = {}
    for k, v in state_dict.items():
        if k.endswith("num_batches_tracked"):
            continue
        nk = rename.get(k, k)
        arr = np.asarray(v)
        if nk == "fc.weight" and arr.ndim == 4:
            if arr.shape[2:] != (1, 1):
                raise ValueError(f"classifier.weight: expected a 1x1 conv "
                                 f"kernel, got shape {arr.shape}")
            arr = arr.reshape(arr.shape[0], arr.shape[1])
        out[nk] = arr
    return out


def resolve_torch_names(state_dict: Dict[str, Any],
                        rename: Optional[Dict[str, str]] = None):
    """The torchvision-named view of a source ``state_dict``, and how it was
    made: ``(state_dict, how)``, ``how`` in ``("rename", "dag", "as-is")``.
    An explicit ``rename`` (source name -> canonical name) wins over the
    ``dag`` auto-detect. ``cli convert`` imports and ``--verify`` forwards
    this one view, so the check sees exactly the converted tensors."""
    if rename is not None:
        return ({rename.get(k, k): v for k, v in state_dict.items()},
                "rename")
    if looks_like_ferplus_dag(state_dict):
        return normalize_dag_state_dict(state_dict), "dag"
    return state_dict, "as-is"


def load_torch_state_dict(state_dict: Dict[str, Any],
                          rename: Optional[Dict[str, str]] = None,
                          strict: bool = True) -> Dict[str, torch.Tensor]:
    """A torch ResNet-50 ``state_dict`` (numpy arrays or CPU tensors,
    torchvision names after ``rename``) -> :class:`ResNet50` entries as
    float32 tensors, BN running stats carried and ``num_batches_tracked``
    0 for every BN layer whose running variance came in.

    ``strict`` (the default) raises ``KeyError`` on a key that maps to no
    :func:`canonical_keys` entry and on a canonical key the source lacks;
    ``num_batches_tracked`` is skipped. Without it unknown keys are
    skipped and the result may be partial (merge it over initialized
    weights)."""
    if rename:
        state_dict = {rename.get(k, k): v for k, v in state_dict.items()}
    keys = canonical_keys()
    out: Dict[str, torch.Tensor] = {}
    for k, v in state_dict.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k not in keys:
            if strict:
                raise KeyError(f"unmapped torch key: {k}")
            continue
        out[k] = torch.from_numpy(np.array(v, dtype=np.float32))
        if k.endswith(".running_var"):
            out[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    if strict:
        missing = keys - set(out)
        if missing:
            raise KeyError(f"missing torch keys: {sorted(missing)[:5]} ...")
    return out
