"""The losses of the supervised route without mixing (``tpuwsi/train/losses.py``).

``main`` picks one of these (``tpuwsi/cli/train.py:499-518``): smoothed
cross-entropy, sigmoid BCE on one-hot targets (``--bce-loss``), the focal
loss (``--focal``) and the masked per-head cross-entropy of '+'-joined
targets. The soft-target, JSD and Cox losses come with mixing (M3b) and
survival (M5). All take fp32 logits and return a scalar tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).to(torch.float32)


def _smoothed(one_hot: torch.Tensor, smoothing: float) -> torch.Tensor:
    if smoothing > 0.0:
        return one_hot * (1.0 - smoothing) + smoothing / one_hot.shape[-1]
    return one_hot


def _softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy``: -Σ targets · log_softmax(logits)."""
    return -(targets * torch.log_softmax(logits.float(), dim=-1)).sum(dim=-1)


def cross_entropy(logits, labels, smoothing: float = 0.0, weights=None):
    """labels: int (B,). Targets ``one_hot · (1 − s) + s / C``; optional
    per-sample weights multiply the per-sample losses before the mean."""
    targets = _smoothed(_one_hot(labels, logits.shape[-1]), smoothing)
    losses = _softmax_cross_entropy(logits, targets)
    if weights is not None:
        losses = losses * weights
    return losses.mean()


def binary_cross_entropy(logits, labels, smoothing: float = 0.0,
                         target_thresh: Optional[float] = None):
    """Per-class sigmoid BCE on (smoothed) one-hot targets; ``target_thresh``
    re-binarises them (timm's --bce-target-thresh)."""
    targets = _smoothed(_one_hot(labels, logits.shape[-1]), smoothing)
    if target_thresh is not None:
        targets = (targets > target_thresh).to(torch.float32)
    return F.binary_cross_entropy_with_logits(logits.float(), targets)


def focal_loss(logits, labels, gamma: float = 2.0, alpha=None):
    """CE scaled by (1 − p_t)^γ; ``alpha`` (C,) weights by the true class."""
    log_pt = torch.log_softmax(logits.float(), dim=-1).gather(
        -1, labels.long()[:, None])[:, 0]
    loss = -((1.0 - torch.exp(log_pt)) ** gamma) * log_pt
    if alpha is not None:
        loss = torch.as_tensor(alpha, dtype=loss.dtype, device=loss.device)[labels.long()] * loss
    return loss.mean()


def multi_target_cross_entropy(logits, labels, smoothing: float = 0.0):
    """'+'-joined targets: logits (B, 2T) are T two-class heads, labels (B, T)
    with -1 for unknown, masked out of the mean."""
    b, t = labels.shape
    mask = labels >= 0
    targets = _smoothed(_one_hot(torch.clamp(labels, min=0), 2), smoothing)
    ce = _softmax_cross_entropy(logits.reshape(b, t, 2), targets)
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1)
