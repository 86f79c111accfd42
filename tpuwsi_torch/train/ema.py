"""Exponential moving averages of parameters, on the device
(``tpuwsi/train/ema.py``)."""

from __future__ import annotations

import math
from typing import Iterable

import torch


@torch.no_grad()
def ema_update(ema_params: Iterable[torch.Tensor], new_params: Iterable[torch.Tensor],
               decay: float) -> None:
    """ema ← decay * ema + (1 - decay) * new, in place, over two sequences
    of floating-point tensors that pair up in order."""
    ema_params, new_params = list(ema_params), list(new_params)
    if len(ema_params) != len(new_params):
        raise ValueError(f"{len(ema_params)} averaged tensors for {len(new_params)} new ones")
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, [p.to(e.dtype) for e, p in zip(ema_params, new_params)],
                        alpha=1.0 - decay)


def cosine_momentum_schedule(base: float, final: float, total_steps: int):
    """DINO teacher-momentum schedule: cosine from base to final."""

    def schedule(step: int) -> float:
        t = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return final - (final - base) * (math.cos(math.pi * t) + 1.0) / 2.0

    return schedule
