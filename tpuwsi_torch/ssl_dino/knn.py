"""Weighted kNN over frozen features, the DINO probe (``tpuwsi/ssl_dino/knn.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def knn_classify(train_feats: torch.Tensor, train_labels: torch.Tensor,
                 test_feats: torch.Tensor, k: int = 20, temperature: float = 0.07,
                 num_classes: Optional[int] = None):
    """Temperature-weighted cosine kNN → ``(predicted labels (M,), class
    probabilities (M, C))``: cosine similarity to the (N, D) bank, the top
    ``k``, weights ``exp(sim / temperature)`` summed per class, the argmax,
    and the softmax of the scores' logarithm. ``num_classes`` None takes
    ``max(train_labels) + 1``; pass it where the bank may lack the last class."""
    if num_classes is None:
        num_classes = int(train_labels.max()) + 1
    tr = train_feats / (torch.linalg.vector_norm(train_feats, dim=1, keepdim=True) + 1e-12)
    te = test_feats / (torch.linalg.vector_norm(test_feats, dim=1, keepdim=True) + 1e-12)
    sim = te @ tr.T  # (M, N)
    k = min(k, tr.shape[0])
    top_sim, top_idx = torch.topk(sim, k, dim=1)
    top_labels = train_labels[top_idx]  # (M, k)
    weights = torch.exp(top_sim / temperature)
    one_hot = F.one_hot(top_labels.long(), num_classes).to(weights.dtype)  # (M, k, C)
    scores = torch.einsum("mk,mkc->mc", weights, one_hot)
    return torch.argmax(scores, dim=1), torch.softmax(torch.log(scores + 1e-12), dim=1)


def knn_accuracy(train_feats, train_labels, test_feats, test_labels, k: int = 20,
                 num_classes: Optional[int] = None) -> float:
    preds, _ = knn_classify(train_feats, train_labels, test_feats, k=k,
                            num_classes=num_classes)
    hits = (preds == test_labels).float().sum()
    # the reference's mean: the fp32 sum times fp32 1/n (XLA's division by a constant)
    return float(hits * torch.tensor(1.0 / test_labels.numel(), dtype=torch.float32))
