"""Weights for the port: random ones from a seed, and the JAX package's.

The port's ``state_dict`` is the canonical torch schema of docs/WEIGHTS.md
under two prefixes, ``backbone.`` (torchvision ResNet-50 names, BN stats
carried: the port folds BN itself) and ``temporal.`` (``gru_micro.*``,
``micro_cnn.conv1.weight``, ``macro_proj.*``, ...). This module reads the
JAX package's variables tree as plain arrays; it imports nothing of it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from .backbone import STAGE_SIZES
from .config import MimamoConfig
from .runner import Mimamo

StateDict = Dict[str, torch.Tensor]


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def _conv(arr) -> torch.Tensor:
    return _t(np.transpose(np.asarray(arr), (3, 2, 0, 1)))    # HWIO -> OIHW


def _bn(sd: StateDict, prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _dense(sd: StateDict, prefix: str, params: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(params["kernel"]).T)  # [in, out]
    sd[f"{prefix}.bias"] = _t(params["bias"])


def backbone_from_jax(variables: Mapping[str, Any]) -> StateDict:
    """JAX ``ResNet50`` variables ``{"params", "batch_stats"}`` -> the
    port's ``ResNet50`` ``state_dict`` (torchvision names)."""
    bp, bs = variables["params"], variables["batch_stats"]
    sd: StateDict = {"conv1.weight": _conv(bp["conv1"]["kernel"])}
    _bn(sd, "bn1", bp["bn1"], bs["bn1"])
    for stage, blocks in enumerate(STAGE_SIZES):
        for b in range(blocks):
            fp, tp = f"layer{stage + 1}_{b}", f"layer{stage + 1}.{b}"
            for i in (1, 2, 3):
                sd[f"{tp}.conv{i}.weight"] = _conv(bp[fp][f"conv{i}"]["kernel"])
                _bn(sd, f"{tp}.bn{i}", bp[fp][f"bn{i}"], bs[fp][f"bn{i}"])
            if "downsample_conv" in bp[fp]:
                sd[f"{tp}.downsample.0.weight"] = _conv(
                    bp[fp]["downsample_conv"]["kernel"])
                _bn(sd, f"{tp}.downsample.1", bp[fp]["downsample_bn"],
                    bs[fp]["downsample_bn"])
    _dense(sd, "fc", bp["fc"])
    return sd


_GRU_NAMES = (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
              ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))


def temporal_from_jax(variables: Mapping[str, Any]) -> StateDict:
    """JAX ``TwoStreamRNN`` variables -> the port's ``TwoStreamRNN``
    ``state_dict``, for every variant: a stream the config leaves out has
    no params on either side, and a stacked GRU's layer i > 0
    (``l<i>_w_ih`` ... in JAX) becomes ``weight_ih_l<i>`` ..."""
    tp = variables["params"]
    sd: StateDict = {}
    if "micro_cnn" in tp:
        cnn, cnn_stats = tp["micro_cnn"], variables["batch_stats"][
            "micro_cnn"]
        depth = sum(1 for k in cnn if k.startswith("conv"))
        for i in range(1, depth + 1):
            sd[f"micro_cnn.conv{i}.weight"] = _conv(cnn[f"conv{i}"]["kernel"])
            _bn(sd, f"micro_cnn.bn{i}", cnn[f"bn{i}"], cnn_stats[f"bn{i}"])
        kern = np.asarray(cnn["fc"]["kernel"])               # [h*w*c, out]
        c = np.asarray(cnn[f"conv{depth}"]["kernel"]).shape[-1]
        side = math.isqrt(kern.shape[0] // c)
        sd["micro_cnn.fc.weight"] = _t(
            kern.T.reshape(-1, side, side, c).transpose(0, 3, 1, 2)
            .reshape(kern.shape[1], -1))
        sd["micro_cnn.fc.bias"] = _t(cnn["fc"]["bias"])
    for name in ("macro_proj", "fusion", "head"):
        if name in tp:
            _dense(sd, name, tp[name])
    for stream in ("gru_micro", "gru_macro"):
        if stream not in tp:
            continue
        gru = tp[stream]
        layers = 1 + sum(k.startswith("l") and k.endswith("_w_ih")
                         for k in gru)
        for li in range(layers):
            prefix = "" if li == 0 else f"l{li}_"
            for jax_name, torch_name in _GRU_NAMES:
                sd[f"{stream}.{torch_name}_l{li}"] = _t(
                    gru[prefix + jax_name])
    return sd


def from_jax_variables(variables: Mapping[str, Any]) -> StateDict:
    """The JAX package's ``{"backbone": {"params", "batch_stats"},
    "temporal": {"params", "batch_stats"}}`` (as ``Mimamo.init_variables``
    returns it; leaves may be numpy or JAX arrays) -> the port's
    ``state_dict``.

    HWIO conv kernels become OIHW, Dense ``[in, out]`` becomes Linear
    ``[out, in]``, the micro ``fc`` input rows are permuted from the NHWC
    flatten to the NCHW flatten, GRU tensors (already torch layout) carry
    over as they are, and BN scale/bias/mean/var carry over unfolded.
    """
    sd = {f"backbone.{k}": v
          for k, v in backbone_from_jax(variables["backbone"]).items()}
    sd.update({f"temporal.{k}": v
               for k, v in temporal_from_jax(variables["temporal"]).items()})
    return sd


@torch.no_grad()
def init_variables(config: MimamoConfig, seed: int) -> StateDict:
    """Random port weights from a seed (``torch.Generator``, on the CPU):
    convs normal with std 1/sqrt(fan_in) (a conv's bias, as in the SE
    gates, uniform in +-1/sqrt(fan_in)), Linear and GRU uniform in
    +-1/sqrt(fan_in), BN affine and running stats near identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.device("meta"):        # no default init, no global RNG draws
        model = Mimamo(config, device="meta")
    model.to_empty(device="cpu")

    def uniform_(t: torch.Tensor, bound: float) -> None:
        t.copy_((torch.rand(t.shape, generator=g) * 2 - 1) * bound)

    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            fan_in = module.weight[0].numel()
            module.weight.copy_(torch.randn(module.weight.shape, generator=g)
                                / math.sqrt(fan_in))
            if module.bias is not None:       # the SE gates' 1x1 convs
                uniform_(module.bias, 1 / math.sqrt(fan_in))
        elif isinstance(module, nn.BatchNorm2d):
            n = module.num_features
            module.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
            module.bias.copy_(0.1 * torch.randn(n, generator=g))
            module.running_mean.copy_(0.1 * torch.randn(n, generator=g))
            module.running_var.copy_(0.5 + torch.rand(n, generator=g))
            module.num_batches_tracked.zero_()
        elif isinstance(module, nn.Linear):
            bound = 1 / math.sqrt(module.in_features)
            uniform_(module.weight, bound)
            uniform_(module.bias, bound)
        elif isinstance(module, nn.GRU):
            for p in module.parameters():
                uniform_(p, 1 / math.sqrt(module.hidden_size))
    return model.state_dict()
