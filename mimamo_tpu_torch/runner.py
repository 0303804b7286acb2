"""End-to-end pipeline: face-crop clips -> per-frame (valence, arousal).

Counterpart of ``Mimamo.predict_clips`` / ``forward`` / ``embed_frames`` /
``_micro_motion`` in ``mimamo_tpu/runner.py``, in clip mode (no carries).
On the card the micro stream's phase-difference stage, the macro stream's
stem and its layer2 run in the hand-written kernels of ``kernels/``; on the
CPU (``device="cpu"``, as the tests run it) each kernel's wrapper takes its
plain version.

Weights: a :class:`Mimamo` is an ``nn.Module`` whose ``state_dict`` is the
canonical torch schema (``backbone.*`` torchvision names, ``temporal.*``
two-stream names; docs/WEIGHTS.md). ``weights.init_variables`` makes a
random one from a seed and ``weights.from_jax_variables`` converts the
JAX package's variables. Inference folds BN into the backbone once, on
first use after construction or ``load_state_dict``; edit parameters only
through ``load_state_dict``, or the folded copy goes stale.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from . import preprocess
from .backbone import FoldedResNet50, ResNet50, fold_batchnorm
from .config import MimamoConfig
from .kernels import phase_kernel
from .temporal import TwoStreamRNN


def resolve_device(device=None) -> torch.device:
    """``device`` as given, or the card when it is None. Without a card
    and without an explicit device this raises: the port never falls back
    to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return torch.device("cuda")


class Mimamo(nn.Module):
    """Config + modules + the clip forward, on one device."""

    def __init__(self, config: Optional[MimamoConfig] = None, device=None):
        super().__init__()
        self.config = config or MimamoConfig()
        device = resolve_device(device)
        # TF32 would round the fp32 convs and GEMMs (micro CNN, GRU, phase
        # resize reference) to ~3 decimal digits, as bf16 matmul passes did
        # on the TPU; keep them IEEE.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = self.config
        self.backbone = ResNet50(cfg.backbone)
        self.temporal = TwoStreamRNN(cfg.temporal, cfg.num_phase,
                                     cfg.phase.phase_size,
                                     cfg.backbone.feature_dim)
        self.device = device
        self.to(device).eval()
        self._folded: Optional[FoldedResNet50] = None

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        self._folded = None
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def _backbone_folded(self) -> FoldedResNet50:
        if self._folded is None:
            self._folded = FoldedResNet50(fold_batchnorm(self.backbone),
                                          self.config.backbone)
        return self._folded

    def embed_frames(self, crops_rgb: torch.Tensor) -> torch.Tensor:
        """[B, T, S, S, 3] float32 0..255 crops -> [B, T, F] pool5
        embeddings (BN folded, inference mode)."""
        b, t = crops_rgb.shape[:2]
        emb, _ = self._backbone_folded()(
            crops_rgb.reshape((b * t,) + crops_rgb.shape[2:]))
        return emb.reshape(b, t, -1)

    def _micro_motion(self, gray: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W] grayscale -> [B, T-1, S*K, P, P] phase stacks."""
        return phase_kernel.micro_motion_features_fused(
            gray, self.config.pyramid, self.config.phase)

    def forward(self, crops_rgb: torch.Tensor) -> torch.Tensor:
        """[B, T, S, S, 3] aligned crops in 0..255 (uint8 preferred: the
        cast to float32 happens here, on the device) -> [B, T, 2]."""
        crops_rgb = crops_rgb.to(self.device).to(torch.float32)
        phase_stacks = self._micro_motion(preprocess.to_grayscale(crops_rgb))
        return self.temporal(phase_stacks, self.embed_frames(crops_rgb))

    @torch.no_grad()
    def predict_clips(self, crops_rgb: Union[np.ndarray, torch.Tensor]
                      ) -> torch.Tensor:
        """[B, T, S, S, 3] aligned crops (numpy or tensor) -> [B, T, 2]
        float32 on the model's device."""
        if isinstance(crops_rgb, np.ndarray):
            crops_rgb = torch.from_numpy(crops_rgb)
        s = tuple(self.config.pyramid.input_size)
        if (crops_rgb.dim() != 5 or tuple(crops_rgb.shape[2:4]) != s
                or crops_rgb.shape[4] != 3 or crops_rgb.shape[1] < 2):
            raise ValueError(f"crops must be [B, T >= 2, {s[0]}, {s[1]}, 3], "
                             f"got {tuple(crops_rgb.shape)}")
        return self(crops_rgb)
