"""Two-stream temporal model (PyTorch): micro (phase CNN + GRU) and macro
(ResNet feature GRU) streams fused into per-frame (valence, arousal).

Counterpart of ``MicroCNN`` and ``TwoStreamRNN`` in
``mimamo_tpu/temporal.py``, in clip mode (no carries). Parameter names are
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

import torch
import torch.nn.functional as F
from torch import nn

from .config import TemporalSpec


class MicroCNN(nn.Module):
    """Stacked phase-diff maps [N, C, P, P] -> [N, micro_embed_dim]:
    per width, conv3x3 (no bias) -> BN -> relu -> max_pool 2x2, then fc on
    the NCHW flatten."""

    def __init__(self, spec: TemporalSpec, in_channels: int, phase_size: int):
        super().__init__()
        self.depth = len(spec.micro_cnn_features)
        c, p = in_channels, phase_size
        for i, feats in enumerate(spec.micro_cnn_features):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(c, feats, 3, padding=1, bias=False))
            setattr(self, f"bn{i + 1}", nn.BatchNorm2d(feats))
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

    def forward(self, phase_stacks: torch.Tensor, rgb_feats: torch.Tensor
                ) -> torch.Tensor:
        """phase_stacks [B, T-1, C, P, P] and rgb_feats [B, T, F] ->
        [B, T, num_outputs]. Frame 0 has no predecessor, so its micro
        embedding is zero."""
        b, t = rgb_feats.shape[:2]
        tm1 = phase_stacks.shape[1]
        if tm1 != t - 1:
            raise ValueError(f"phase stacks T-1={tm1} vs frames T={t}")
        micro = self.micro_cnn(phase_stacks.reshape(
            (b * tm1,) + phase_stacks.shape[2:])).reshape(b, tm1, -1)
        micro = F.pad(micro, (0, 0, 1, 0))
        macro = F.relu(self.macro_proj(rgb_feats))
        ys_micro, _ = self.gru_micro(micro)
        ys_macro, _ = self.gru_macro(macro)
        fused = F.relu(self.fusion(torch.cat([ys_micro, ys_macro], dim=-1)))
        out = self.head(fused)
        if self.spec.output_activation == "tanh":
            out = torch.tanh(out)
        return out
