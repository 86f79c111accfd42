"""Step metrics on the device (``tpuwsi/train/metrics.py``).

AUC is the rank statistic (Mann-Whitney U) with average ranks for ties and
an optional mask, so a train step computes it without a host read. Slide
score = mean tile softmax of the slide's tiles.
"""

from __future__ import annotations

import torch


def _average_ranks(scores: torch.Tensor) -> torch.Tensor:
    """1-based average ranks, ties sharing the mean of their positions
    (scipy's ``rankdata``)."""
    order = torch.argsort(scores, stable=True)
    ordered = scores[order]
    first = torch.searchsorted(ordered, ordered, side="left")
    last = torch.searchsorted(ordered, ordered, side="right") - 1
    avg = (first + last).to(torch.float32) / 2.0 + 1.0
    ranks = torch.empty_like(avg)
    ranks[order] = avg
    return ranks


def auc_score(scores, labels, mask=None) -> torch.Tensor:
    """Binary ROC-AUC of ``scores`` for class 1; 0.5 where one class is
    absent. scores (N,) float, labels (N,) int in {0, 1}, mask (N,) bool or
    None. Masked entries rank below every real one and are left out."""
    scores = scores.to(torch.float32)
    labels = labels.to(torch.int32)
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.bool)
    ranks = _average_ranks(torch.where(mask, scores, torch.full_like(scores, -torch.inf)))
    is_pos = (labels == 1) & mask
    is_neg = (labels == 0) & mask
    n_pos, n_neg = is_pos.sum(), is_neg.sum()
    rank_sum_pos = torch.where(is_pos, ranks, torch.zeros_like(ranks)).sum() \
        - n_pos * (~mask).sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    denom = (n_pos * n_neg).to(torch.float32)
    return torch.where(denom > 0, u / torch.clamp(denom, min=1.0), torch.full_like(u, 0.5))


def accuracy_topk(logits, labels, k: int = 1, mask=None) -> torch.Tensor:
    """Share of (unmasked) rows whose label is among the k largest logits
    (ties to the lower index, as a stable sort orders them)."""
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.bool)
    topk = torch.argsort(-logits, dim=-1, stable=True)[:, :k]
    correct = (topk == labels.long()[:, None]).any(dim=-1) & mask
    return correct.sum() / torch.clamp(mask.sum(), min=1)


def slide_scores_from_tiles(tile_probs, slide_ids, num_slides: int, mask=None):
    """Mean class-1 probability per slide over its (unmasked) tiles →
    ``(scores (num_slides,), has_tiles (num_slides,) bool)``."""
    if mask is None:
        mask = torch.ones(tile_probs.shape[0], dtype=torch.bool, device=tile_probs.device)
    w = mask.to(torch.float32)
    sums = torch.zeros(num_slides, device=tile_probs.device).index_add_(
        0, slide_ids.long(), tile_probs.float() * w)
    counts = torch.zeros(num_slides, device=tile_probs.device).index_add_(0, slide_ids.long(), w)
    return sums / torch.clamp(counts, min=1.0), counts > 0


class AverageMeter:
    """Host-side running average (timm's ``AverageMeter``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)
