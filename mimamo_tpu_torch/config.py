"""Frozen configuration dataclasses for the PyTorch/CUDA port.

An own copy of ``mimamo_tpu/config.py`` (the port imports nothing of the
JAX package). Field names and defaults are the JAX package's, so a config
written for one reads the same in the other. Knobs that only chose a TPU
lowering are gone: ``fft_mode``/``dft_precision`` (the port takes its FFTs
from ``torch.fft``), ``use_pallas``/``layer2_mode``/``stem_mode`` (on CUDA
the hand-written kernels are the path), ``fold_bn_inference`` (inference
always folds), ``fused_gru``/``scan_unroll`` (scan scheduling).

Conventions pinned for parity:
  * Pyramid radial coordinate normalized so the spectrum edge midpoint is
    r = pi; raised-cosine transitions are one octave wide in log2(r).
  * Band at scale index ``s`` (0-based) lives on a grid of spatial size
    (H / 2**s, W / 2**s).
  * Phase diff: ``angle(c_t * conj(c_{t-1}))`` (product form), wrapped to
    (-pi, pi], resized to ``phase_size`` with bilinear interpolation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PyramidSpec:
    """Complex steerable pyramid configuration."""

    height: int = 3           # number of oriented band scales S
    orientations: int = 4     # number of angular bands K
    input_size: Tuple[int, int] = (112, 112)  # H, W of grayscale crops
    # Include the (-i)**(K-1) analytic-band constant (SCFpyr convention).
    complex_factor: bool = True

    def __post_init__(self):
        h, w = self.input_size
        if h % (1 << self.height) or w % (1 << self.height):
            raise ValueError(
                f"input_size {self.input_size} must be divisible by "
                f"2**height = {1 << self.height}")


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """Inter-frame phase-difference (micro-motion) configuration."""

    phase_size: int = 48       # output resolution of each phase-diff map
    amplitude_weighting: bool = False


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    """ResNet-50 FER+ appearance stream.

    The port runs the backbone on crops of exactly half ``input_size``
    (the stem kernel fuses the exact 2x upscale); preprocessing is the
    MatConvNet convention: 0..255 pixels, per-channel mean subtraction.
    """

    input_size: int = 224
    feature_dim: int = 2048    # pool5 embedding width
    num_classes: int = 8       # FER+ emotion classes
    mean_rgb: Tuple[float, float, float] = (131.0912, 103.8827, 91.4953)
    channel_order: str = "rgb"  # "rgb" | "bgr"
    dtype: str = "float32"      # compute dtype: "float32" | "bfloat16"

    def __post_init__(self):
        if self.channel_order not in ("rgb", "bgr"):
            raise ValueError(f"channel_order must be 'rgb' or 'bgr', "
                             f"got {self.channel_order!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', "
                             f"got {self.dtype!r}")


@dataclasses.dataclass(frozen=True)
class TemporalSpec:
    """Two-stream GRU temporal model.

    The port runs the fused two-stream model with one GRU layer and
    per-frame steps; the stream ablations, stacked GRUs and snippet
    pooling of the JAX package are listed in ROADMAP.md as not yet ported.
    """

    streams: str = "both"
    micro_cnn_features: Tuple[int, ...] = (64, 128)  # conv widths
    micro_embed_dim: int = 256
    macro_embed_dim: int = 256   # projection of the 2048-d feature
    gru_hidden: int = 256        # per-stream GRU hidden size
    gru_layers: int = 1
    fusion_hidden: int = 256
    num_outputs: int = 2         # (valence, arousal)
    output_activation: str = "linear"  # "linear" | "tanh"
    snippet_len: int = 1

    def __post_init__(self):
        for name, want in (("streams", "both"), ("gru_layers", 1),
                           ("snippet_len", 1)):
            if getattr(self, name) != want:
                raise NotImplementedError(
                    f"TemporalSpec.{name}={getattr(self, name)!r}: the port "
                    f"supports only {want!r} so far (see ROADMAP.md)")
        if self.output_activation not in ("linear", "tanh"):
            raise ValueError(f"output_activation must be 'linear' or "
                             f"'tanh', got {self.output_activation!r}")


@dataclasses.dataclass(frozen=True)
class ClipSpec:
    """Clip / window hyperparameters (48-frame clips at half overlap)."""

    clip_len: int = 48
    stride: int = 24            # sliding-window stride (clip_len // 2)
    crop_size: int = 112        # aligned face-crop size
    fps: Optional[float] = None  # metadata only


@dataclasses.dataclass(frozen=True)
class MimamoConfig:
    """Top-level config for the full pipeline."""

    pyramid: PyramidSpec = PyramidSpec()
    phase: PhaseSpec = PhaseSpec()
    backbone: BackboneSpec = BackboneSpec()
    temporal: TemporalSpec = TemporalSpec()
    clip: ClipSpec = ClipSpec()

    @property
    def num_phase(self) -> int:
        return self.pyramid.height * self.pyramid.orientations
