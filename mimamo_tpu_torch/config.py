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

    Preprocessing is the MatConvNet convention: 0..255 pixels, per-channel
    mean subtraction. A crop of exactly half ``input_size`` goes through
    the stem kernel (the exact 2x upscale fused); any other ratio through
    the bilinear resize and a plain conv1 (``backbone.FoldedResNet50``).

    ``se_reduction``: 0 is ResNet-50; r > 0 is SE-ResNet-50 (Hu et al.,
    arXiv:1709.01507; ``senet50_ferplus_dag``): every bottleneck gates its
    conv3 output with a squeeze-and-excitation block of C / r hidden
    channels (16 in the published model). r must divide 256, the
    narrowest conv3 output.
    """

    input_size: int = 224
    feature_dim: int = 2048    # pool5 embedding width
    num_classes: int = 8       # FER+ emotion classes
    mean_rgb: Tuple[float, float, float] = (131.0912, 103.8827, 91.4953)
    channel_order: str = "rgb"  # "rgb" | "bgr"
    dtype: str = "float32"      # compute dtype: "float32" | "bfloat16"
    # Serving profile (not reference parity): the ResNet runs on frames
    # 0, k, 2k, ... only and the other embeddings are linear
    # interpolations between anchors (frames past the last anchor hold
    # it). Applies wherever ``Mimamo.embed_frames`` runs (inference and
    # frozen-backbone training); fine-tuning ignores it. Streaming chunks
    # anchor per chunk, so for k > 1 streamed outputs differ slightly from
    # batch prediction of the same frames (the anchor grids shift at chunk
    # seams).
    appearance_stride: int = 1
    se_reduction: int = 0

    def __post_init__(self):
        if self.se_reduction < 0 or (self.se_reduction
                                     and 256 % self.se_reduction):
            raise ValueError(f"se_reduction must be 0 or divide 256, got "
                             f"{self.se_reduction}")
        if self.appearance_stride < 1:
            raise ValueError(f"appearance_stride must be >= 1, got "
                             f"{self.appearance_stride}")
        if self.channel_order not in ("rgb", "bgr"):
            raise ValueError(f"channel_order must be 'rgb' or 'bgr', "
                             f"got {self.channel_order!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', "
                             f"got {self.dtype!r}")


@dataclasses.dataclass(frozen=True)
class TemporalSpec:
    """Two-stream GRU temporal model.

    ``streams``: "both", or the paper's micro-only and macro-only
    ablations ("micro" | "macro"; the inactive stream has no parameters
    and is never computed). ``gru_layers``: stacked GRU layers per stream.
    ``snippet_len``: frames mean-pooled into one GRU step (the clip length
    must be a multiple of it; outputs repeat back to every frame).
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
        if self.streams not in ("both", "micro", "macro"):
            raise ValueError(f"streams must be 'both', 'micro' or 'macro', "
                             f"got {self.streams!r}")
        if self.gru_layers < 1:
            raise ValueError(f"gru_layers must be >= 1, got "
                             f"{self.gru_layers}")
        if self.snippet_len < 1:
            raise ValueError(f"snippet_len must be >= 1, got "
                             f"{self.snippet_len}")
        if self.output_activation not in ("linear", "tanh"):
            raise ValueError(f"output_activation must be 'linear' or "
                             f"'tanh', got {self.output_activation!r}")

    @property
    def use_micro(self) -> bool:
        return self.streams in ("both", "micro")

    @property
    def use_macro(self) -> bool:
        return self.streams in ("both", "macro")


@dataclasses.dataclass(frozen=True)
class ClipSpec:
    """Clip / window hyperparameters (48-frame clips at half overlap)."""

    clip_len: int = 48
    stride: int = 24            # sliding-window stride (clip_len // 2)
    crop_size: int = 112        # aligned face-crop size
    fps: Optional[float] = None  # metadata only


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Training hyperparameters (``train.make_optimizer``,
    ``train.make_train_step``, ``train.fit``)."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.0    # > 0: AdamW
    # "constant" | "cosine" (linear warmup over warmup_steps, cosine decay
    # to 0 over the run; needs total_steps at optimizer build)
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    batch_size: int = 4          # clips per step
    epochs: int = 20
    loss: str = "ccc"            # "ccc" | "ccc+mse"
    mse_weight: float = 0.0
    # Per-clip augmentation inside the train step, deterministic in
    # (seed, step). Needs the online appearance stream: cached features
    # cannot reflect an augmented crop.
    augment: bool = False            # per-clip random horizontal flip
    brightness_jitter: float = 0.0   # per-clip scale in [1-j, 1+j]
    # "time": CCC per clip over its frames (frame-level labels, Aff-Wild2);
    # "batch": CCC over the clip batch of time-averaged predictions
    # (utterance-level labels, OMG).
    loss_axis: str = "time"
    seed: int = 0
    freeze_backbone: bool = True  # the reference trains on cached features
    # Recompute the backbone's activations in the backward pass (only with
    # freeze_backbone=False).
    remat_backbone: bool = True

    def __post_init__(self):
        # loss and mse_weight are one knob under two names (the step reads
        # only mse_weight): a config may not claim "ccc" and train with MSE
        if self.loss not in ("ccc", "ccc+mse"):
            raise ValueError(f"loss must be 'ccc' or 'ccc+mse', got "
                             f"{self.loss!r}")
        if self.loss == "ccc+mse" and self.mse_weight <= 0:
            raise ValueError("loss='ccc+mse' requires mse_weight > 0")
        if self.loss == "ccc" and self.mse_weight:
            raise ValueError(f"mse_weight={self.mse_weight} requires "
                             f"loss='ccc+mse'")
        if self.weight_decay < 0:
            raise ValueError(f"weight_decay must be >= 0, got "
                             f"{self.weight_decay}")


@dataclasses.dataclass(frozen=True)
class MimamoConfig:
    """Top-level config for the full pipeline."""

    pyramid: PyramidSpec = PyramidSpec()
    phase: PhaseSpec = PhaseSpec()
    backbone: BackboneSpec = BackboneSpec()
    temporal: TemporalSpec = TemporalSpec()
    clip: ClipSpec = ClipSpec()
    train: TrainSpec = TrainSpec()

    @property
    def num_phase(self) -> int:
        return self.pyramid.height * self.pyramid.orientations
