"""Two-stream temporal model (PyTorch): micro (phase CNN + GRU) and macro
(ResNet feature GRU) streams fused into per-frame (valence, arousal).

Counterpart of ``MicroCNN``, ``TwoStreamRNN`` and ``init_carries`` in
``mimamo_tpu/temporal.py``: clip mode (both GRUs start from zeros) and
streaming (the previous chunk's carries come in, the new ones go out).
Parameter names are
the canonical two-stream schema of docs/WEIGHTS.md (``gru_micro.*``,
``micro_cnn.conv1.weight``, ``macro_proj.*``, ...). The JAX package's GRU is
a hand-rolled torch-convention cell (gate order r, z, n; reset gate applied
to the hidden projection including its bias) under ``lax.scan``, so its
weights load into ``nn.GRU`` verbatim; its ``_dual_gru`` interleaving of the
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


Carries = Tuple[torch.Tensor, torch.Tensor]     # (h_micro, h_macro), [B, H]


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
    """Micro + macro streams -> two GRUs -> fused (valence, arousal)."""

    def __init__(self, spec: TemporalSpec, num_phase: int, phase_size: int,
                 feature_dim: int):
        super().__init__()
        self.spec = spec
        self.micro_cnn = MicroCNN(spec, num_phase, phase_size)
        self.macro_proj = nn.Linear(feature_dim, spec.macro_embed_dim)
        self.gru_micro = nn.GRU(spec.micro_embed_dim, spec.gru_hidden,
                                batch_first=True)
        self.gru_macro = nn.GRU(spec.macro_embed_dim, spec.gru_hidden,
                                batch_first=True)
        self.fusion = nn.Linear(2 * spec.gru_hidden, spec.fusion_hidden)
        self.head = nn.Linear(spec.fusion_hidden, spec.num_outputs)

    def forward(self, phase_stacks: torch.Tensor, rgb_feats: torch.Tensor,
                carries: Optional[Carries] = None,
                first_pair_invalid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Carries]:
        """phase_stacks [B, T-1 | T, C, P, P] and rgb_feats [B, T, F] ->
        ([B, T, num_outputs], new carries).

        With T-1 pairs (clip mode) frame 0 has no predecessor and its micro
        embedding is zero; with T pairs (streaming: the caller prepended the
        previous chunk's last frame) every frame has one. ``carries`` are
        the two GRUs' [B, H] hidden states from the previous chunk (zeros
        when None). ``first_pair_invalid`` ([B] bool) zeroes step 0's micro
        embedding of the rows it marks, so that a stream's first chunk
        equals clip mode; it selects, so a non-finite embedding of a marked
        row does not get through."""
        b, t = rgb_feats.shape[:2]
        tm1 = phase_stacks.shape[1]
        micro = self.micro_cnn(phase_stacks.reshape(
            (b * tm1,) + phase_stacks.shape[2:])).reshape(b, tm1, -1)
        if tm1 == t - 1:
            micro = F.pad(micro, (0, 0, 1, 0))
        elif tm1 != t:
            raise ValueError(f"phase stacks T-1={tm1} vs frames T={t}")
        if first_pair_invalid is not None:
            first = torch.where(first_pair_invalid[:, None],
                                torch.zeros_like(micro[:, 0]), micro[:, 0])
            micro = torch.cat([first[:, None], micro[:, 1:]], dim=1)
        macro = F.relu(self.macro_proj(rgb_feats))
        # nn.GRU wants [layers = 1, B, H]
        h_micro, h_macro = (None, None) if carries is None else (
            c[None].contiguous() for c in carries)
        ys_micro, h_micro = self.gru_micro(micro, h_micro)
        ys_macro, h_macro = self.gru_macro(macro, h_macro)
        fused = F.relu(self.fusion(torch.cat([ys_micro, ys_macro], dim=-1)))
        out = self.head(fused)
        if self.spec.output_activation == "tanh":
            out = torch.tanh(out)
        return out, (h_micro[0], h_macro[0])


def init_carries(spec: TemporalSpec, batch: int, device=None) -> Carries:
    """Zero carries of both GRUs, [B, H] float32 each."""
    return (torch.zeros((batch, spec.gru_hidden), device=device),
            torch.zeros((batch, spec.gru_hidden), device=device))
