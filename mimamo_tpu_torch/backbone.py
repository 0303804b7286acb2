"""ResNet-50 FER+ appearance backbone for the macro stream (PyTorch).

Counterpart of ``mimamo_tpu/backbone.py``. :class:`ResNet50` holds the
parameters in the canonical torchvision schema (``conv1.weight``,
``layer1.0.bn2.running_var``, ``layer2.0.downsample.0.weight``, ``fc.*``;
docs/WEIGHTS.md), with the Caffe/MatConvNet stride placement
(``stride_in_1x1``: block 0 of layers 2-4 strides its first 1x1 conv) that
converted FER+ checkpoints expect. Inference runs the BN-folded form,
:class:`FoldedResNet50`, built by :func:`fold_batchnorm`:

  * stem: ``kernels.stem_kernel`` (upscale + conv1 + relu + max pool from
    the crop; replaces the JAX path's ``composite_stem``);
  * layer1, layer3, layer4: ``F.conv2d`` in channels_last, in the
    configured dtype (XLA lowered these outside any Pallas kernel);
  * layer2: ``kernels.layer2_kernel``;
  * pool5: mean over space, the 2048-d embedding, and the FER+ ``fc``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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
    """Bottleneck block (parameters only; inference uses the folded form)."""

    def __init__(self, inplanes: int, width: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, width, 1, stride=stride, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width * 4)
        self.downsample = None
        if stride != 1 or inplanes != width * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, width * 4, 1, stride=stride, bias=False),
                nn.BatchNorm2d(width * 4))


class ResNet50(nn.Module):
    """ResNet-50 parameters in the canonical torchvision schema."""

    def __init__(self, spec: BackboneSpec):
        super().__init__()
        self.spec = spec
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for i, (blocks, width) in enumerate(zip(STAGE_SIZES, STAGE_WIDTHS)):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(inplanes, width,
                                        2 if (i > 0 and b == 0) else 1))
                inplanes = width * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.fc = nn.Linear(spec.feature_dim, spec.num_classes)


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
    """BN-folded inference ResNet-50 on raw crops.

    Built once from :func:`fold_batchnorm`'s output; the weights are cast
    to the configured dtype and laid out for their consumers (the stem and
    layer2 kernels, channels_last ``F.conv2d`` for the other stages).
    """

    def __init__(self, folded: Folded, spec: BackboneSpec):
        self.spec = spec
        dt = work_dtype(spec)
        self.stem = stem_kernel.prepare_stem_weights(
            *folded["conv1"], spec.channel_order, dt)
        self.layer2 = layer2_kernel.pack_layer2_params(folded, dt)
        self.stages = {}
        for stage in (1, 3, 4):
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

    def __call__(self, crops: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, S, S, 3] float32 RGB crops (0..255, S = input_size / 2) ->
        (pool5 embeddings [N, 2048] float32, FER+ logits [N, classes])."""
        if crops.shape[1] * 2 != self.spec.input_size:
            raise NotImplementedError(
                f"crop size {crops.shape[1]} with backbone input_size "
                f"{self.spec.input_size}: the port runs only the exact 2x "
                f"upscale so far (see ROADMAP.md)")
        stem = stem_kernel.stem_fused(crops, *self.stem, self.spec.mean_rgb)
        x = self._stage(stem.permute(0, 3, 1, 2), 1)     # NCHW view of NHWC
        x = layer2_kernel.layer2_fused(
            x.permute(0, 2, 3, 1).contiguous(), self.layer2)
        x = self._stage(x.permute(0, 3, 1, 2), 3)
        x = self._stage(x, 4)
        emb = x.to(torch.float32).mean(dim=(2, 3)).to(x.dtype)
        emb = emb.to(torch.float32)
        return emb, F.linear(emb, *self.fc)
