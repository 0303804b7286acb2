"""Two-stream temporal model (PyTorch): micro (phase CNN + GRU) and macro
(ResNet feature GRU) streams fused into per-frame (valence, arousal).

Counterpart of ``MicroCNN``, ``TwoStreamRNN`` and ``init_carries`` in
``mimamo_tpu/temporal.py``: clip mode (both GRUs start from zeros) and
streaming (the previous chunk's carries come in, the new ones go out),
with the JAX package's variants: the stream ablations, stacked GRU layers
and snippet pooling. Parameter names are the canonical two-stream schema
of docs/WEIGHTS.md (``gru_micro.*``, ``micro_cnn.conv1.weight``,
``macro_proj.*``, ...). The JAX package's GRU is a hand-rolled
torch-convention cell (gate order r, z, n; reset gate applied to the
hidden projection including its bias) under ``lax.scan``, so its weights
load into ``nn.GRU`` verbatim (a stack's layer i > 0 as
``weight_ih_l<i>`` and so on); its ``_dual_gru`` interleaving of the
two recurrences is a TPU scheduling choice, and two GRUs back to back
compute the same thing. Everything here runs in fp32; the runner keeps
TF32 off so the convs and the GRU stay IEEE on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .batchnorm import BatchNorm2d
from .config import TemporalSpec


# (h_micro, h_macro): [B, H] each, or [L, B, H] with L stacked GRU layers
Carries = Tuple[torch.Tensor, torch.Tensor]


class MicroCNN(nn.Module):
    """Stacked phase-diff maps [N, C, P, P] -> [N, micro_embed_dim]:
    per width, conv3x3 (no bias) -> BN -> relu -> max_pool 2x2, then fc on
    the NCHW flatten. In training mode the BNs use batch statistics and
    update their running stats as Flax does (``batchnorm.BatchNorm2d``)."""

    def __init__(self, spec: TemporalSpec, in_channels: int, phase_size: int):
        super().__init__()
        self.depth = len(spec.micro_cnn_features)
        c, p = in_channels, phase_size
        for i, feats in enumerate(spec.micro_cnn_features):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(c, feats, 3, padding=1, bias=False))
            setattr(self, f"bn{i + 1}", BatchNorm2d(feats))
            c, p = feats, p // 2
        self.fc = nn.Linear(c * p * p, spec.micro_embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.depth + 1):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            x = F.max_pool2d(F.relu(x), 2)
        return self.fc(x.flatten(1))


class TwoStreamRNN(nn.Module):
    """Micro + macro streams -> two GRUs -> fused (valence, arousal).

    The variants of ``TemporalSpec`` as the JAX package runs them:
    ``streams="micro"`` / ``"macro"`` builds only the active stream's
    modules (its ``state_dict`` has no tensor of the other, and ``fusion``
    takes H inputs, not 2H); ``gru_layers = L`` stacks L layers in each
    ``nn.GRU``; ``snippet_len = w`` mean-pools each stream's per-frame
    inputs over windows of w frames, steps the GRUs once per window and
    repeats the outputs back to the frames."""

    def __init__(self, spec: TemporalSpec, num_phase: int, phase_size: int,
                 feature_dim: int):
        super().__init__()
        self.spec = spec
        if spec.use_micro:
            self.micro_cnn = MicroCNN(spec, num_phase, phase_size)
            self.gru_micro = nn.GRU(spec.micro_embed_dim, spec.gru_hidden,
                                    num_layers=spec.gru_layers,
                                    batch_first=True)
        if spec.use_macro:
            self.macro_proj = nn.Linear(feature_dim, spec.macro_embed_dim)
            self.gru_macro = nn.GRU(spec.macro_embed_dim, spec.gru_hidden,
                                    num_layers=spec.gru_layers,
                                    batch_first=True)
        streams = int(spec.use_micro) + int(spec.use_macro)
        self.fusion = nn.Linear(streams * spec.gru_hidden,
                                spec.fusion_hidden)
        self.head = nn.Linear(spec.fusion_hidden, spec.num_outputs)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, D] -> [B, T / w, D] means over snippets of w frames."""
        w = self.spec.snippet_len
        if w == 1:
            return x
        return x.reshape(x.shape[0], x.shape[1] // w, w, -1).mean(dim=2)

    def _gru(self, gru: nn.GRU, xs: torch.Tensor,
             carry: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One stream's GRU from a carry in ``init_carries``'s layout
        ([B, H] for one layer, [L, B, H] for L): (outputs, new carry)."""
        one = self.spec.gru_layers == 1
        h0 = None if carry is None else (
            carry[None] if one else carry).contiguous()
        ys, h = gru(xs, h0)
        return ys, (h[0] if one else h)

    def forward(self, phase_stacks: Optional[torch.Tensor],
                rgb_feats: Optional[torch.Tensor],
                carries: Optional[Carries] = None,
                first_pair_invalid: Optional[torch.Tensor] = None,
                num_frames: Optional[int] = None
                ) -> Tuple[torch.Tensor, Carries]:
        """phase_stacks [B, T-1 | T, C, P, P] and rgb_feats [B, T, F] ->
        ([B, T, num_outputs], new carries).

        With T-1 pairs (clip mode) frame 0 has no predecessor and its micro
        embedding is zero; with T pairs (streaming: the caller prepended the
        previous chunk's last frame) every frame has one. ``carries`` are
        the two GRUs' hidden states from the previous chunk (zeros when
        None), in :func:`init_carries`' layout. ``first_pair_invalid``
        ([B] bool) zeroes step 0's micro embedding of the rows it marks, so
        that a stream's first chunk equals clip mode; it selects, so a
        non-finite embedding of a marked row does not get through.

        The inactive stream's input may be None; its carry passes through
        unchanged, or as zeros when there is none. ``num_frames`` gives T
        to a micro-only model (no ``rgb_feats`` to read it from); without
        it T is the number of pairs plus one."""
        spec = self.spec
        if spec.use_micro and phase_stacks is None:
            raise ValueError(f"streams={spec.streams!r} needs phase_stacks")
        if spec.use_macro and rgb_feats is None:
            raise ValueError(f"streams={spec.streams!r} needs rgb_feats")
        if spec.use_macro:
            b, t = rgb_feats.shape[:2]
        else:
            b = phase_stacks.shape[0]
            t = (num_frames if num_frames is not None
                 else phase_stacks.shape[1] + 1)
        if t % spec.snippet_len:
            raise ValueError(f"clip length {t} not divisible by "
                             f"snippet_len {spec.snippet_len}")
        h_micro, h_macro = (None, None) if carries is None else carries
        ys = []
        if spec.use_micro:
            tm1 = phase_stacks.shape[1]
            micro = self.micro_cnn(phase_stacks.reshape(
                (b * tm1,) + phase_stacks.shape[2:])).reshape(b, tm1, -1)
            if tm1 == t - 1:
                micro = F.pad(micro, (0, 0, 1, 0))
            elif tm1 != t:
                raise ValueError(f"phase stacks T-1={tm1} vs frames T={t}")
            if first_pair_invalid is not None:
                first = torch.where(first_pair_invalid[:, None],
                                    torch.zeros_like(micro[:, 0]),
                                    micro[:, 0])
                micro = torch.cat([first[:, None], micro[:, 1:]], dim=1)
            y, h_micro = self._gru(self.gru_micro, self._pool(micro),
                                   h_micro)
            ys.append(y)
        if spec.use_macro:
            macro = F.relu(self.macro_proj(rgb_feats))
            y, h_macro = self._gru(self.gru_macro, self._pool(macro),
                                   h_macro)
            ys.append(y)
        fused = F.relu(self.fusion(torch.cat(ys, dim=-1)))
        out = self.head(fused)
        if spec.output_activation == "tanh":
            out = torch.tanh(out)
        if spec.snippet_len > 1:
            out = out.repeat_interleave(spec.snippet_len, dim=1)
        if h_micro is None or h_macro is None:
            zeros = init_carries(spec, b, out.device)
            h_micro = zeros[0] if h_micro is None else h_micro
            h_macro = zeros[1] if h_macro is None else h_macro
        return out, (h_micro, h_macro)


def init_carries(spec: TemporalSpec, batch: int, device=None) -> Carries:
    """Zero carries of both GRUs, float32: [B, H] each for one GRU layer,
    [L, B, H] (``nn.GRU``'s ``h_n`` layout) for L stacked layers."""
    shape = ((batch, spec.gru_hidden) if spec.gru_layers == 1
             else (spec.gru_layers, batch, spec.gru_hidden))
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device))
