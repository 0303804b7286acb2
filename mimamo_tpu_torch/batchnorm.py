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

Half precision follows ``flax.linen.BatchNorm(dtype=bfloat16)`` (its
``force_float32_reductions``): on bf16 activations the mean and the biased
variance are taken in fp32, ``(x - mean) * (rsqrt(var + eps) * scale) +
bias`` is computed in fp32 from the fp32 parameters, the output is rounded
to bf16, and the running stats stay fp32. ``F.batch_norm`` computes
exactly that for a bf16 input with fp32 parameters (one fused kernel that
keeps only the bf16 input for its backward); the synced path forms the
same from its fp32 sums.

Data parallelism: under GSPMD the JAX train-mode BN reduces over the global
batch. Inside :func:`synced` a layer takes its mean and biased variance
from the channel sums and sums of squares all-reduced over a
``parallel.DataGroup`` (with autograd, ``parallel.all_reduce``), as Flax
computes them (E[x²] − E[x]², clipped at 0), and every rank updates the same
running stats. ``nn.SyncBatchNorm`` is no substitute: it refuses CPU
tensors, and its running update is not Flax's.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import parallel


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step updates the running stats as
    Flax does: ``running = (1 - momentum) * running + momentum * batch``
    with the biased batch variance. The batch statistics cover every
    element of the batch (masked frames included, as in JAX).
    ``update_stats`` is cleared by :func:`stats_frozen` while an
    activation checkpoint recomputes the forward, so that each step
    updates the running stats once; ``group`` is set by :func:`synced`."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.update_stats = True
        self.group: Optional[parallel.DataGroup] = None

    def _global_stats(self, x: torch.Tensor):
        """(mean, biased var) [C] in fp32 over the batches of every rank."""
        c = x.shape[1]
        x = x.to(torch.float32)
        sums = parallel.all_reduce(torch.cat([
            x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
            x.new_tensor([x.numel() // c])]), self.group)
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = var = None
        if self.group is None or self.group.world == 1:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True,
                             0.0, self.eps)
        else:
            mean, var = self._global_stats(x)
            scale = self.weight * torch.rsqrt(var + self.eps)
            y = ((x.to(torch.float32) - mean[None, :, None, None])
                 * scale[None, :, None, None]
                 + self.bias[None, :, None, None]).to(x.dtype)
        if self.update_stats:
            with torch.no_grad():
                if mean is None:
                    var, mean = torch.var_mean(x.to(torch.float32),
                                               dim=(0, 2, 3), unbiased=False)
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


@contextlib.contextmanager
def synced(module: nn.Module, group: Optional[parallel.DataGroup]
           ) -> Iterator[None]:
    """Inside, the :class:`BatchNorm2d` layers of ``module`` in training
    mode take their statistics over the batches of all ranks of ``group``
    (None or a world of one: the local batch)."""
    layers = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in layers:
        m.group = group
    try:
        yield
    finally:
        for m in layers:
            m.group = None
