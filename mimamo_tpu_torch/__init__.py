"""PyTorch/CUDA port of mimamo_tpu for NVIDIA Hopper (H100).

The JAX package ``mimamo_tpu`` is the reference; this package imports
nothing of it. Entry points: ``Mimamo(config, device=None)`` with
``predict_clips`` ([B, T, S, S, 3] face crops -> [B, T, 2]
valence/arousal), ``predict_stream`` (chunk by chunk, state carried) and
``predict_from_crops`` (sliding windows over a long crop sequence),
``predict_video`` (decoded frames plus face boxes or landmarks, cropped or
aligned on the device), and ``StreamingSession`` (a fixed number of
concurrent streams advancing together); the user API in ``api``
(``MimamoAPI``, ``VideoProcessor``, ``FeatureExtractor``); training in
``train`` (``fit``, ``make_train_step``), with ``checkpoints``,
``data.datasets`` and ``data.eval``. All run on the card unless
``device="cpu"`` is passed. Weights come from ``weights.init_variables``,
``weights.from_jax_variables`` or a checkpoint.
"""

from .config import (BackboneSpec, ClipSpec, MimamoConfig, PhaseSpec,
                     PyramidSpec, TemporalSpec)
from .runner import Mimamo
from .streaming import StreamingSession

__all__ = ["BackboneSpec", "ClipSpec", "Mimamo", "MimamoConfig", "PhaseSpec",
           "PyramidSpec", "StreamingSession", "TemporalSpec"]
