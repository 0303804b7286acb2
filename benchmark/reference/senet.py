"""Plain fp32 reference of MIMAMO-Net with an SE-ResNet-50 FER+ backbone.

The macro stream's ResNet-50 becomes SE-ResNet-50 (Hu et al.,
"Squeeze-and-Excitation Networks", arXiv:1709.01507), as the zoo of
Albanie et al. (arXiv:1808.05561) ships it fine-tuned on FER+
(``senet50_ferplus_dag``): every bottleneck keeps ResNet-50's widths and
depths and gates conv3's output (after its BatchNorm) before the residual
add. For conv3's output ``u`` of C channels and ``r`` the configuration's
``backbone.se_reduction``:

* squeeze: ``z = mean_hw(u)`` per frame and channel;
* excite: ``g = sigmoid(W2 relu(W1 z + b1) + b2)``, W1 mapping C -> C / r
  and W2 C / r -> C, both 1x1 convs with bias (``se.fc1``, ``se.fc2``);
* ``out = relu(g * u + shortcut)``.

Everything else is ``mimamo``'s reference, which this module subclasses:
it adds the gates' leaves to the schema and the gate to the backbone's
forward, and imports nothing of the program. The gate runs in fp32 with
TF32 off; under ``low`` at the rounding points of the other convs: in
``bf16`` the mean summed in fp32 and rounded to bf16, each fc on bf16
inputs and weights, the sigmoid, the product and the add rounded to bf16;
in ``fp8`` each fc's input and weight rounded to fp8 as the convs' are; in
``tf32`` its matmuls in TF32.
"""

from __future__ import annotations

import copy
from typing import List, Tuple

import torch
import torch.nn.functional as F

from . import mimamo
from .mimamo import FAULTS, STAGES, fp8, train_steps  # noqa: F401

NAME = "senet"
SMALLEST_C = 4 * STAGES[0][1]          # conv3's narrowest output, 256
KEYS = dict(mimamo.KEYS,
            backbone=mimamo.KEYS["backbone"] | {"se_reduction"})


def schema(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """``mimamo``'s schema with each block's gate right after its ``bn3``:
    ``se.fc1`` ([C / r, C, 1, 1], fan-in C) and ``se.fc2`` ([C, C / r, 1,
    1], fan-in C / r), weights of kind ``conv`` and biases of kind
    ``linear``."""
    r = cfg["backbone"]["se_reduction"]
    out: List[Tuple[str, Tuple[int, ...], str, int]] = []
    c = 0
    for leaf in mimamo.schema(cfg):
        out.append(leaf)
        name = leaf[0]
        if not name.startswith("backbone.layer"):
            continue
        if name.endswith(".bn3.weight"):
            c = leaf[1][0]
        elif name.endswith(".bn3.num_batches_tracked"):
            block = name[:-len(".bn3.num_batches_tracked")]
            for fc, o, i in (("fc1", c // r, c), ("fc2", c, c // r)):
                out.append((f"{block}.se.{fc}.weight", (o, i, 1, 1), "conv",
                            i))
                out.append((f"{block}.se.{fc}.bias", (o,), "linear", i))
    return out


def check_supported(cfg: dict) -> None:
    """What ``mimamo`` computes, with ``backbone.se_reduction`` a whole r
    >= 1 that divides 256 (each stage's C / r a whole number of channels),
    and no key of a section that this reference does not know."""
    for section, known in KEYS.items():
        unknown = sorted(set(cfg.get(section, {})) - known)
        if unknown:
            raise ValueError(
                f"{section}: the reference {NAME!r} does not compute "
                f"{unknown}; name a reference of the configuration's own "
                f"(\"reference\": \"<module>\" in its file, a module of "
                f"benchmark/reference/)")
    r = cfg["backbone"].get("se_reduction")
    if (not isinstance(r, int) or isinstance(r, bool) or r < 1
            or SMALLEST_C % r):
        raise ValueError(f"backbone: the reference {NAME!r} computes "
                         f"se_reduction r >= 1 dividing {SMALLEST_C}, got "
                         f"{r!r}")
    plain = copy.deepcopy(cfg)
    del plain["backbone"]["se_reduction"]
    mimamo.check_supported(plain)


class Reference(mimamo.Reference):
    """``mimamo.Reference`` with a gate in every bottleneck."""

    check_supported = staticmethod(check_supported)

    def _fc(self, z: torch.Tensor, name: str) -> torch.Tensor:
        """One gate fc (a 1x1 conv on a [N, C] vector) in ``z``'s dtype,
        on fp8-rounded input and weight under the ``fp8`` control."""
        w = self.p[f"{name}.weight"].flatten(1)
        b = self.p[f"{name}.bias"]
        if self.low == "fp8":
            z, w = fp8(z), fp8(w)
        return F.linear(z, w.to(z.dtype), b.to(z.dtype))

    def gate(self, u: torch.Tensor, block: str) -> torch.Tensor:
        """``u * g`` for conv3's output ``u`` [N, C, H, W] of ``block``."""
        z = u.float().mean(dim=(2, 3)).to(u.dtype)
        h = F.relu(self._fc(z, f"{block}.se.fc1"))
        g = torch.sigmoid(self._fc(h, f"{block}.se.fc2"))
        return u * g[:, :, None, None]

    def embed(self, crops: torch.Tensor, block: int = 96) -> torch.Tensor:
        """[N, S, S, 3] crops (0..255) -> [N, 2048] pool5 embeddings."""
        outs = []
        size = self.cfg["backbone"]["input_size"]
        bgr = self.cfg["backbone"]["channel_order"] == "bgr"
        with torch.no_grad(), self.precision():
            for i in range(0, crops.shape[0], block):
                x = crops[i:i + block].to(self.device, torch.float32) - self.mean
                if bgr:
                    x = x.flip(-1)
                x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                                  mode="bilinear", align_corners=False)
                if self.low == "bf16":
                    x = x.to(torch.bfloat16)
                x = F.max_pool2d(F.relu(self._conv(x, "conv1")), 3, 2, 1)
                for s, (blocks, _) in enumerate(STAGES):
                    for j in range(blocks):
                        p = f"backbone.layer{s + 1}.{j}"
                        res = (self._conv(x, f"{p}.downsample") if j == 0
                               else x)
                        y = F.relu(self._conv(x, f"{p}.conv1"))
                        y = F.relu(self._conv(y, f"{p}.conv2"))
                        y = self.gate(self._conv(y, f"{p}.conv3"), p)
                        x = F.relu(y + res)
                outs.append(x.float().mean(dim=(2, 3)).to(x.dtype).float())
        return torch.cat(outs)
