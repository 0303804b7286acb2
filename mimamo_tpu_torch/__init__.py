"""PyTorch/CUDA port of mimamo_tpu for NVIDIA Hopper (H100).

The JAX package ``mimamo_tpu`` is the reference; this package imports
nothing of it. Entry point: ``Mimamo(config, device=None).predict_clips``
([B, T, S, S, 3] face crops -> [B, T, 2] valence/arousal), running on the
card unless ``device="cpu"`` is passed. Weights come from
``weights.init_variables`` or ``weights.from_jax_variables``.
"""

from .config import (BackboneSpec, MimamoConfig, PhaseSpec, PyramidSpec,
                     TemporalSpec)
from .runner import Mimamo

__all__ = ["BackboneSpec", "Mimamo", "MimamoConfig", "PhaseSpec",
           "PyramidSpec", "TemporalSpec"]
