"""MIL heads over frozen tile features (``tpuwsi/models/mil.py``).

Parity: the reference's MIL over precomputed features (datasets.py:820
``Features_MILdataset``), the attention weights before and after the softmax
that it exports (utils_MIL.py:1502-1600), and the linear tile-score readout
``score = (w1 - w0)ᵀ f`` (utils_MIL.py:1603-1630). The pooling is the gated
attention MIL of Ilse et al.

A bag is a padded (B, N, D) batch with a (B, N) validity mask; the pooling
softmax is masked. The head's products (D → hidden, hidden → 1, D →
classes) are plain ``torch`` ops: the JAX package runs no Pallas kernel
here. The bag axis sharded over devices (``sharded_attention_pool``) comes
with distribution (ROADMAP.md, Queue 1, M7).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpuwsi_torch.models.dino_head import trunc_normal_

NEG_INF = -1e30


def masked_attention_pool(scores, feats, mask):
    """Softmax-pool ``feats`` (B, N, D) by ``scores`` (B, N), the masked
    tiles' scores set to ``NEG_INF`` first (a fully masked bag pools
    uniformly). → (pooled (B, D), scores before the softmax, attention
    after it), the weights the reference exports (utils_MIL.py:1539-1546)."""
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bn,bnd->bd", attn, feats), scores, attn


class GatedAttentionMIL(nn.Module):
    """Gated attention pooling and a linear classifier over a feature bag:
    ``att_V`` with tanh, times the ``att_U`` sigmoid gate when ``gated``,
    ``att_w`` to one score a tile, divided by ``temperature``."""

    def __init__(self, in_dim: int, hidden_dim: int = 128, num_classes: int = 2,
                 gated: bool = True, temperature: float = 1.0):
        super().__init__()
        self.temperature = temperature
        self.att_V = nn.Linear(in_dim, hidden_dim)
        self.att_U = nn.Linear(in_dim, hidden_dim) if gated else None
        self.att_w = nn.Linear(hidden_dim, 1)
        self.classifier = nn.Linear(in_dim, num_classes)

    def forward(self, feats, mask: Optional[torch.Tensor] = None,
                return_attention: bool = False):
        """``feats`` (B, N, D) fp32, ``mask`` (B, N) bool (True: a real
        tile). → logits (B, classes), with the scores before and the
        attention after the softmax when ``return_attention``."""
        if mask is None:
            mask = torch.ones(feats.shape[:2], dtype=torch.bool, device=feats.device)
        h = torch.tanh(self.att_V(feats))
        if self.att_U is not None:
            h = h * torch.sigmoid(self.att_U(feats))
        scores = self.att_w(h)[..., 0] / self.temperature
        pooled, before, after = masked_attention_pool(scores, feats, mask)
        logits = self.classifier(pooled)
        if return_attention:
            return logits, before, after
        return logits


class MeanPoolMIL(nn.Module):
    """Masked mean pooling and a linear classifier (the reference's
    mean-softmax slide score, train.py:1288, as a MIL head)."""

    def __init__(self, in_dim: int, num_classes: int = 2):
        super().__init__()
        self.classifier = nn.Linear(in_dim, num_classes)

    def forward(self, feats, mask: Optional[torch.Tensor] = None):
        if mask is None:
            mask = torch.ones(feats.shape[:2], dtype=torch.bool, device=feats.device)
        m = mask.to(feats.dtype)
        pooled = torch.einsum("bn,bnd->bd", m, feats) / torch.clamp(
            m.sum(-1, keepdim=True), min=1.0)
        return self.classifier(pooled)


def init_mil_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Every weight normal(0, 0.02) truncated at two standard deviations
    (the reference's ``trunc_normal_init``), drawn from ``generator`` in
    ``named_parameters`` order; every bias 0."""
    with torch.no_grad():
        for _, p in model.named_parameters():
            if p.ndim > 1:
                trunc_normal_(p, generator=generator)
            else:
                p.zero_()


def tile_scores_from_head(features, head_weight, receptor_slice: Optional[int] = None):
    """The reference's tile-score readout (utils_MIL.py:1623-1629): the
    classifier's class-1 minus class-0 weight row dotted with each tile's
    features. ``head_weight`` is the torch layout (classes, D); for the
    paired Receptor+is_Tumor features only the first ``receptor_slice``
    dimensions count."""
    diff = head_weight[1] - head_weight[0]
    if receptor_slice is not None:
        return features[..., :receptor_slice] @ diff[:receptor_slice]
    return features @ diff
