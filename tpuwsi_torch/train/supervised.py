"""Supervised eval step (counterpart of ``tpuwsi/train/supervised.py:144``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


def make_eval_step(model: nn.Module, preprocess_fn: Optional[Callable] = None):
    """Return step(images) → (logits, fp32 softmax probs) for a tile batch."""

    def step(images: torch.Tensor):
        if preprocess_fn is not None:
            images = preprocess_fn(images)
        logits = model(images)
        return logits, torch.softmax(logits.float(), dim=-1)

    return step
