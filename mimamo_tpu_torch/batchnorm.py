"""BatchNorm with the JAX package's training semantics.

The JAX package's BatchNorms (``flax.linen.BatchNorm(momentum=0.9,
epsilon=1e-5)`` in ``mimamo_tpu/temporal.py`` and ``backbone.py``)
normalize a training batch with its biased (1/N) variance and update the
running variance with that same biased variance. ``nn.BatchNorm2d``
normalizes the same way but updates with the unbiased variance, so
:class:`BatchNorm2d` keeps the stock module's parameters, buffers and
inference path and replaces only the update. Flax's ``momentum=0.9`` (the
weight of the old value) is torch's ``momentum=0.1`` (the weight of the
batch's).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step updates the running stats as
    Flax does: ``running = (1 - momentum) * running + momentum * batch``
    with the biased batch variance. The batch statistics cover every
    element of the batch (masked frames included, as in JAX).
    ``update_stats`` is cleared by :func:`stats_frozen` while an
    activation checkpoint recomputes the forward, so that each step
    updates the running stats once."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        if self.update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self.running_mean.mul_(1 - self.momentum).add_(
                    mean, alpha=self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(
                    var, alpha=self.momentum)
                self.num_batches_tracked.add_(1)
        return y


@contextlib.contextmanager
def stats_frozen(module: nn.Module) -> Iterator[None]:
    """Inside, the :class:`BatchNorm2d` layers of ``module`` normalize with
    batch statistics but leave their running stats alone."""
    layers = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in layers:
        m.update_stats = False
    try:
        yield
    finally:
        for m in layers:
            m.update_stats = True
