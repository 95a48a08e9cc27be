"""Detection losses — masked, fixed-shape, batch-global (counterpart of the
JAX package's ``train/losses.py``).

* smooth-L1 with sigma: 0.5 * s^2 * d^2 below 1/s^2, |d| - 0.5/s^2 above,
  summed over positives and divided by the batch's positive count, at
  least 1;
* softmax cross-entropy with ignore-index -1: the mean over the batch's
  non-ignored entries.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def smooth_l1(pred: Tensor, target: Tensor, sigma: float = 1.0) -> Tensor:
    """Elementwise smooth-L1 with the sigma^2 knee."""
    s2 = sigma * sigma
    diff = torch.abs(pred - target)
    return torch.where(diff < 1.0 / s2, 0.5 * s2 * diff * diff, diff - 0.5 / s2)


def loc_loss(pred: Tensor, target: Tensor, labels: Tensor, sigma: float = 1.0) -> Tensor:
    """Localization loss on positives (labels > 0): pred/target [..., 4],
    labels [...]; summed, divided by max(#positives, 1)."""
    pos = (labels > 0).to(pred.dtype)
    per = smooth_l1(pred, target, sigma).sum(dim=-1)
    n_pos = torch.clamp(pos.sum(), min=1.0)
    return (per * pos).sum() / n_pos


def ignore_cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Softmax CE averaged over entries with label >= 0: logits [..., C],
    labels [...] with -1 = ignore. Each entry is logsumexp(logits) minus
    the label's logit, as optax computes it."""
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = torch.logsumexp(logits, dim=-1) - picked
    n = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, ce, 0.0).sum() / n
