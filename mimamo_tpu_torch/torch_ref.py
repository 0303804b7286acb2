"""Reference forwards of the SOURCE ``.pth`` tensors, for ``cli convert
--verify``.

An own copy of ``mimamo_tpu/torch_ref.py`` (the port imports nothing of the
JAX package). These graphs are built from ``torch.nn`` alone, not from the
port's modules, and consume the source layouts directly: torchvision-named
OIHW convs and [O, I] linears for the backbone; the canonical two-stream
schema (torch GRU gate layout, NCHW flatten before the micro fc) for the
temporal model. ``convert --verify`` forwards the converted model on the
same inputs, so a wrong key mapping or transpose shows as a large |delta|,
not as a silent accuracy loss later. They run on the CPU in fp32.

The backbone is built for either stride placement (``stride_in_1x1``:
block 0 of layers 2-4 strides its 1x1 conv1, or, False, its 3x3 conv2);
the temporal model for every ``TemporalSpec`` variant: the stream
ablations, stacked GRU layers and snippet pooling.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _tensors(state_dict: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in state_dict.items()
            if not k.endswith("num_batches_tracked")}


def _load(module: nn.Module, sd: Dict[str, torch.Tensor], what: str):
    missing, unexpected = module.load_state_dict(sd, strict=False)
    missing = [m for m in missing if not m.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{what}: the source does not fit the reference "
                       f"graph; missing {missing[:5]}, unexpected "
                       f"{list(unexpected)[:5]}")
    return module.eval()


# -- ResNet-50 FER+ backbone (torchvision state_dict names) ------------------

class _Bottleneck(nn.Module):
    def __init__(self, inplanes: int, width: int, stride: int,
                 stride_in_1x1: bool):
        super().__init__()
        # stride_in_1x1: the Caffe / MatConvNet placement; else torchvision's
        s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = nn.Conv2d(inplanes, width, 1, stride=s1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=s2, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width * 4)
        self.downsample = None
        if stride != 1 or inplanes != width * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, width * 4, 1, stride=stride, bias=False),
                nn.BatchNorm2d(width * 4))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        return torch.relu(self.bn3(self.conv3(out)) + identity)


class _ResNet50(nn.Module):
    def __init__(self, num_classes: int, stride_in_1x1: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for i, (blocks, width) in enumerate(zip((3, 4, 6, 3),
                                                (64, 128, 256, 512))):
            layer = []
            for b in range(blocks):
                layer.append(_Bottleneck(inplanes, width,
                                         2 if (i > 0 and b == 0) else 1,
                                         stride_in_1x1))
                inplanes = width * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
        emb = x.mean(dim=(2, 3))
        return emb, self.fc(emb)


def backbone_forward(state_dict: Dict[str, np.ndarray],
                     images_nhwc: np.ndarray, stride_in_1x1: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Forward SOURCE backbone tensors (torchvision names: apply the
    ``dag`` or user rename first, as the importer does) on [N, S, S, 3]
    preprocessed fp32 images (mean subtracted: the check isolates the
    weights' conversion). Returns (embeddings [N, 2048], logits [N, C]) as
    numpy. ``stride_in_1x1``: the placement of block 0's stride."""
    model = _ResNet50(int(np.asarray(state_dict["fc.weight"]).shape[0]),
                      stride_in_1x1)
    _load(model, _tensors(state_dict), "backbone")
    with torch.no_grad():
        x = torch.from_numpy(np.ascontiguousarray(
            np.asarray(images_nhwc, np.float32).transpose(0, 3, 1, 2)))
        emb, logits = model(x)
    return emb.numpy(), logits.numpy()


# -- two-stream temporal model (canonical .pth schema) -----------------------

def temporal_forward(state_dict: Dict[str, np.ndarray], spec,
                     phase_stacks: Optional[np.ndarray],
                     rgb_feats: Optional[np.ndarray],
                     num_frames: Optional[int] = None) -> np.ndarray:
    """Forward SOURCE two-stream tensors (the canonical schema of
    ``checkpoints.load_temporal_state_dict``) in clip mode: phase stacks
    [B, T-1, C, P, P] (NCHW maps; None for a macro-only spec) and
    appearance features [B, T, F] (None for a micro-only spec) ->
    [B, T, num_outputs] numpy predictions. ``num_frames`` gives T to a
    micro-only spec (default: pairs + 1). ``spec.snippet_len`` w > 1
    mean-pools each stream over windows of w frames and repeats the
    outputs back; ``spec.gru_layers`` stacks the GRUs."""
    sd = _tensors(state_dict)
    use_micro = spec.streams in ("both", "micro")
    use_macro = spec.streams in ("both", "macro")
    if use_macro:
        b, t = rgb_feats.shape[:2]
    else:
        b = phase_stacks.shape[0]
        t = (num_frames if num_frames is not None
             else phase_stacks.shape[1] + 1)
    w = spec.snippet_len
    if t % w:
        raise ValueError(f"clip length {t} not divisible by snippet_len "
                         f"{w}")

    def take(prefix: str, module: nn.Module) -> nn.Module:
        sub = {k[len(prefix) + 1:]: v for k, v in sd.items()
               if k.startswith(prefix + ".")}
        return _load(module, sub, prefix)

    def pool(x: torch.Tensor) -> torch.Tensor:      # [B, T, D] -> [B, T/w, D]
        return x if w == 1 else x.reshape(b, t // w, w, -1).mean(dim=2)

    def gru(prefix: str, in_dim: int) -> nn.Module:
        return take(prefix, nn.GRU(in_dim, spec.gru_hidden,
                                   num_layers=spec.gru_layers,
                                   batch_first=True))

    outs = []
    with torch.no_grad():
        if use_micro:
            tm1, c_in, p = (phase_stacks.shape[1], phase_stacks.shape[2],
                            phase_stacks.shape[-1])
            if tm1 != t - 1:
                raise ValueError(f"phase stacks T-1={tm1} vs frames T={t}")
            layers = []
            for feats in spec.micro_cnn_features:
                layers += [nn.Conv2d(c_in, feats, 3, padding=1, bias=False),
                           nn.BatchNorm2d(feats), nn.ReLU(),
                           nn.MaxPool2d(2, 2)]
                c_in, p = feats, p // 2
            # conv<i> / bn<i> of the schema are Sequential entries 4(i-1), +1
            cnn_sd = {}
            for i in range(len(spec.micro_cnn_features)):
                for src, dst in ((f"conv{i + 1}", 4 * i),
                                 (f"bn{i + 1}", 4 * i + 1)):
                    pref = f"micro_cnn.{src}."
                    cnn_sd.update({f"{dst}.{k[len(pref):]}": v
                                   for k, v in sd.items()
                                   if k.startswith(pref)})
            cnn = _load(nn.Sequential(*layers), cnn_sd, "micro_cnn")
            fc = take("micro_cnn.fc",
                      nn.Linear(c_in * p * p, spec.micro_embed_dim))
            x = torch.from_numpy(np.ascontiguousarray(
                phase_stacks.reshape((b * tm1,) + phase_stacks.shape[2:]),
                np.float32))
            micro = fc(cnn(x).flatten(1)).reshape(b, tm1, -1)
            micro = torch.cat([torch.zeros(b, 1, micro.shape[-1]), micro],
                              dim=1)
            ys, _ = gru("gru_micro", spec.micro_embed_dim)(pool(micro))
            outs.append(ys)
        if use_macro:
            proj = take("macro_proj",
                        nn.Linear(rgb_feats.shape[-1], spec.macro_embed_dim))
            macro = torch.relu(proj(torch.from_numpy(
                np.ascontiguousarray(rgb_feats, np.float32))))
            ys, _ = gru("gru_macro", spec.macro_embed_dim)(pool(macro))
            outs.append(ys)
        fused = torch.cat(outs, dim=-1)
        fusion = take("fusion", nn.Linear(fused.shape[-1],
                                          spec.fusion_hidden))
        head = take("head", nn.Linear(spec.fusion_hidden, spec.num_outputs))
        out = head(torch.relu(fusion(fused)))
        if spec.output_activation == "tanh":
            out = torch.tanh(out)
        if w > 1:
            out = out.repeat_interleave(w, dim=1)
    return out.numpy()
