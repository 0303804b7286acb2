"""Concordance correlation coefficient (CCC): the training loss and metric.

Counterpart of ``mimamo_tpu/losses.py``: ``ccc = 2 cov(p, y) / (var(p) +
var(y) + (mean(p) - mean(y))**2)`` with population (biased, 1/N) moments
over the leading axis, optionally masked; the loss is ``1 - ccc`` averaged
over the output dims, plus an optional masked MSE term.
"""

from __future__ import annotations

from typing import Optional

import torch


def _mask_like(mask: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.float32)
    while m.dim() < pred.dim():
        m = m[..., None]
    return m


def ccc(pred: torch.Tensor, target: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        eps: float = 1e-8) -> torch.Tensor:
    """CCC over the leading (time or sample) axis of [N] or [N, D]
    sequences; ``mask`` [N] marks the valid rows (1 = valid). Returns a
    scalar or [D] in [-1, 1]."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    if mask is not None:
        m = _mask_like(mask, pred)
        n = m.sum(dim=0) + eps
        mu_p = (pred * m).sum(dim=0) / n
        mu_t = (target * m).sum(dim=0) / n
        dp, dt = (pred - mu_p) * m, (target - mu_t) * m
        var_p = (dp * dp).sum(dim=0) / n
        var_t = (dt * dt).sum(dim=0) / n
        cov = (dp * dt).sum(dim=0) / n
    else:
        mu_p, mu_t = pred.mean(dim=0), target.mean(dim=0)
        var_p = pred.var(dim=0, unbiased=False)
        var_t = target.var(dim=0, unbiased=False)
        cov = ((pred - mu_p) * (target - mu_t)).mean(dim=0)
    return 2.0 * cov / (var_p + var_t + (mu_p - mu_t) ** 2 + eps)


def ccc_loss(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             mse_weight: float = 0.0) -> torch.Tensor:
    """``1 - ccc`` averaged over the output dims, plus ``mse_weight`` times
    the (masked) mean squared error."""
    loss = (1.0 - ccc(pred, target, mask=mask)).mean()
    if mse_weight:
        if mask is not None:
            # broadcast before the denominator's sum: the mask counts rows,
            # the numerator sums rows x dims
            m = _mask_like(mask, pred).expand(pred.shape)
            mse = (m * (pred - target) ** 2).sum() / (m.sum() + 1e-8)
        else:
            mse = ((pred - target) ** 2).mean()
        loss = loss + mse_weight * mse
    return loss
