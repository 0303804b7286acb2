"""ResNet-50 FER+ appearance backbone for the macro stream (PyTorch).

Counterpart of ``mimamo_tpu/backbone.py``. :class:`ResNet50` holds the
parameters in the canonical torchvision schema (``conv1.weight``,
``layer1.0.bn2.running_var``, ``layer2.0.downsample.0.weight``, ``fc.*``;
docs/WEIGHTS.md), with the Caffe/MatConvNet stride placement
(``stride_in_1x1``: block 0 of layers 2-4 strides its first 1x1 conv) that
converted FER+ checkpoints expect. Inference runs the BN-folded form,
:class:`FoldedResNet50`, built by :func:`fold_batchnorm`:

  * stem: for a crop of exactly half ``input_size``, ``kernels.
    stem_kernel`` (upscale + conv1 + relu + max pool from the crop;
    replaces the JAX path's ``composite_stem``), in the configured dtype
    (bf16 or fp32 kernel); at any other ratio (``--backbone-size 112`` of
    a 112 crop, for one), ``preprocess.for_backbone``'s bilinear resize,
    then conv1 + relu + max pool as ``F.conv2d`` / ``F.max_pool2d``, as
    the JAX package runs it (both of its fused stems take only the exact
    2x);
  * layer1, layer3, layer4: ``F.conv2d`` in channels_last, in the
    configured dtype (XLA lowered these outside any Pallas kernel);
  * layer2: ``kernels.layer2_kernel`` in bf16; ``F.conv2d`` like the other
    stages in fp32, as the JAX package routes it (its Pallas layer2 is
    bf16-only, so an fp32 backbone runs layer2 as XLA convs);
  * pool5: mean over space, the 2048-d embedding, and the FER+ ``fc``.

Fine-tuning runs the unfolded :meth:`ResNet50.forward` with training-mode
BatchNorm (``batchnorm.BatchNorm2d``) on ``preprocess.for_backbone`` input,
as plain autograd: the kernels are inference-only.

The reference's weights come in through :func:`load_torch_state_dict`
(torchvision names, or the FER+ MatConvNet ``dag`` names by
:func:`resolve_torch_names`), as ``cli convert`` reads them.
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

from . import preprocess
from .batchnorm import BatchNorm2d, stats_frozen
from .config import BackboneSpec
from .kernels import layer2_kernel, stem_kernel
from .preprocess import work_dtype

STAGE_SIZES = (3, 4, 6, 3)            # ResNet-50
STAGE_WIDTHS = (64, 128, 256, 512)    # bottleneck inner widths

# FER+ label order (Barsoum et al. 2016; the albanie ferplus models'
# classifier emits logits in this order — 8 classes incl. contempt).
FERPLUS_CLASSES = ("neutral", "happiness", "surprise", "sadness",
                   "anger", "disgust", "fear", "contempt")

Folded = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


class Bottleneck(nn.Module):
    """Bottleneck block; its ``forward`` is the unfolded (training) form,
    inference uses the folded one."""

    def __init__(self, inplanes: int, width: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, width, 1, stride=stride, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(width * 4)
        self.downsample = None
        if stride != 1 or inplanes != width * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, width * 4, 1, stride=stride, bias=False),
                BatchNorm2d(width * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + res)


class ResNet50(nn.Module):
    """ResNet-50 parameters in the canonical torchvision schema."""

    def __init__(self, spec: BackboneSpec):
        super().__init__()
        self.spec = spec
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for i, (blocks, width) in enumerate(zip(STAGE_SIZES, STAGE_WIDTHS)):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(inplanes, width,
                                        2 if (i > 0 and b == 0) else 1))
                inplanes = width * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.fc = nn.Linear(spec.feature_dim, spec.num_classes)

    def _forward(self, images: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(images.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(len(STAGE_SIZES)):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.mean(dim=(2, 3))

    def forward(self, images: torch.Tensor, remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, H, W, 3] preprocessed fp32 images (``preprocess.for_backbone``)
        -> (pool5 embeddings [N, 2048], FER+ logits), unfolded, with each
        BatchNorm in the module's mode (training: batch statistics and one
        running-stat update per call).

        ``remat``: keep no activations for the backward pass and compute
        them again in it (``torch.utils.checkpoint``), as the JAX package's
        ``jax.checkpoint`` does under ``TrainSpec.remat_backbone``; the
        recomputation leaves the running stats alone."""
        if self.spec.dtype != "float32":
            raise NotImplementedError(
                f"the unfolded backbone runs in float32 only, got "
                f"{self.spec.dtype!r} (a bf16 fine-tune is not ported; "
                f"see ROADMAP.md)")
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
    (``conv1``, ``layer2.0.conv1``, ``layer2.0.downsample``), plus ``fc``.
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
    bf16 and :meth:`_layer2_convs` in fp32.
    """

    def __init__(self, folded: Folded, spec: BackboneSpec,
                 crop_hw: Optional[Tuple[int, int]] = None):
        self.spec = spec
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
        if dt == torch.bfloat16:
            self.layer2 = layer2_kernel.pack_layer2_params(folded, dt)
            self.run_layer2 = self._layer2_kernel
            conv_stages = (1, 3, 4)
        else:
            self.layer2 = None
            self.run_layer2 = self._layer2_convs
            conv_stages = (1, 2, 3, 4)
        self.stages = {}
        for stage in conv_stages:
            blocks = []
            for b in range(STAGE_SIZES[stage - 1]):
                p = f"layer{stage}.{b}."
                blk = {}
                for name in ("conv1", "conv2", "conv3", "downsample"):
                    if p + name not in folded:
                        continue
                    w, bias = folded[p + name]
                    stride = 2 if (stage > 1 and b == 0
                                   and name in ("conv1", "downsample")) else 1
                    blk[name] = (
                        w.to(dt).contiguous(memory_format=torch.channels_last),
                        bias.to(dt), stride, w.shape[-1] // 2)
                blocks.append(blk)
            self.stages[stage] = blocks
        self.fc = folded["fc"]

    @staticmethod
    def _bottleneck(x: torch.Tensor, blk) -> torch.Tensor:
        def conv(v, p):
            w, b, stride, pad = p
            return F.conv2d(v, w, b, stride=stride, padding=pad)

        res = conv(x, blk["downsample"]) if "downsample" in blk else x
        y = F.relu(conv(x, blk["conv1"]))
        y = F.relu(conv(y, blk["conv2"]))
        return F.relu(conv(y, blk["conv3"]) + res)

    def _stage(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        for blk in self.stages[stage]:
            x = self._bottleneck(x, blk)
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
        x = self._stage(self.run_stem(crops), 1)         # NCHW view of NHWC
        x = self._stage(self.run_layer2(x), 3)
        x = self._stage(x, 4)
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
