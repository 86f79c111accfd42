"""Optimizers and LR schedule of the DINO, supervised, survival and MIL
steps (``tpuwsi/train/optim.py``).

Ported: AdamW, and SGD with momentum (``momentum``) or Nesterov momentum
(``sgd``, ``nesterov``), each with no weight decay on 1-D parameters (AdamW
also with decay on every parameter, as the MIL head's ``optax.adamw``);
clipping by global norm; the warm-up-cosine schedule with an optional offset
of its count; the batch-size LR scaling rule; and ``freeze_non_head`` for
--no-grad. The conventions are optax's, which differ from ``torch.optim``
in places that show in a trajectory: the clip scales by ``max_norm / norm``
only when ``norm >= max_norm`` (no epsilon); the schedule is read at the
optimizer's own count, 0 at the first step; SGD adds the decayed weights to
the gradient before the momentum trace. The other optimizers, schedules,
clip modes, layer decay and the cosine weight-decay schedule raise
``NotImplementedError`` (ROADMAP.md, M3b).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import torch


@dataclasses.dataclass
class OptimConfig:
    """Field for field the reference's ``OptimConfig``."""

    opt: str = "sgd"
    lr: Optional[float] = None  # None → derived via the scaling rule
    base_lr: float = 0.1
    lr_base_size: int = 512
    lr_base_scale: str = "linear"  # 'linear' (sgd-family) | 'sqrt' (adaptive)
    momentum: float = 0.9
    weight_decay: float = 2e-5
    eps: float = 1e-8
    betas: tuple = (0.9, 0.999)
    clip_grad: Optional[float] = None
    clip_mode: str = "norm"
    weight_decay_end: Optional[float] = None
    sched: str = "cosine"
    epochs: int = 300
    warmup_epochs: int = 5
    warmup_lr: float = 1e-5
    min_lr: float = 0.0
    steps_per_epoch: int = 1000
    decay_epochs: float = 90.0
    decay_rate: float = 0.1
    layer_decay: Optional[float] = None
    cooldown_epochs: int = 0
    schedule_offset_steps: int = 0
    lr_cycle_mul: float = 1.0
    lr_cycle_decay: float = 0.5
    lr_cycle_limit: int = 1
    lr_k_decay: float = 1.0
    warmup_prefix: bool = False
    lr_noise: Optional[tuple] = None
    lr_noise_pct: float = 0.67
    lr_noise_std: float = 1.0
    seed: int = 42
    decay_milestones: Optional[tuple] = None
    patience_epochs: int = 10

    def resolved_lr(self, global_batch_size: int) -> float:
        if self.lr is not None:
            return self.lr
        ratio = global_batch_size / self.lr_base_size
        if self.lr_base_scale == "sqrt":
            ratio = ratio ** 0.5
        return self.base_lr * ratio


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, Queue 1, M3b)")


def make_schedule(cfg: OptimConfig, peak_lr: float) -> Callable[[int], float]:
    """count → learning rate: linear warm-up from ``warmup_lr`` to the peak,
    then a cosine to ``min_lr`` that ends at the last step
    (``optax.warmup_cosine_decay_schedule``), read at count +
    ``schedule_offset_steps`` (--start-epoch, --no-resume-opt)."""
    if cfg.sched != "cosine":
        raise _not_ported(f"schedule {cfg.sched!r}")
    if (cfg.lr_cycle_mul != 1.0 or cfg.lr_cycle_decay != 0.5 or cfg.lr_cycle_limit != 1
            or cfg.lr_k_decay != 1.0 or cfg.warmup_prefix):
        raise _not_ported("cosine restarts, k-decay and warm-up prefix")
    if cfg.lr_noise:
        raise _not_ported("LR noise")
    offset = cfg.schedule_offset_steps
    warmup_steps = cfg.warmup_epochs * cfg.steps_per_epoch
    total_steps = cfg.epochs * cfg.steps_per_epoch
    decay_total = max(total_steps - cfg.cooldown_epochs * cfg.steps_per_epoch,
                      warmup_steps + 1)
    decay_steps = decay_total - warmup_steps
    alpha = cfg.min_lr / peak_lr if peak_lr else 0.0

    def schedule(count: int) -> float:
        count += offset
        if count < warmup_steps:
            return cfg.warmup_lr + (peak_lr - cfg.warmup_lr) * count / warmup_steps
        frac = min(count - warmup_steps, decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return peak_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` where the global norm
    reaches ``max_norm``, leave them otherwise; returns the norm before."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    """``optax.adamw`` behind an optional global-norm clip, updating the
    parameters in place: the Adam direction, plus ``weight_decay * p`` where
    ``p.ndim > 1`` (on every parameter with ``decay_1d``, optax's default
    without a mask), times ``-schedule(count)``."""

    def __init__(self, schedule: Callable[[int], float], b1: float, b2: float, eps: float,
                 weight_decay: float, clip_grad: Optional[float], decay_1d: bool = False):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad
        self.decay_1d = decay_1d

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: AdamWState) -> Optional[torch.Tensor]:
        """One update of ``params`` and ``state`` in place (``grads`` is
        scratch). Returns the gradients' global norm before clipping when the
        clip is on."""
        params, grads = list(params), list(grads)
        norm = None
        if self.clip_grad is not None:
            norm = clip_by_global_norm(grads, self.clip_grad)
        lr = self.schedule(state.count)
        state.count += 1
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(state.nu, 1.0 - self.b2 ** state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(state.mu, 1.0 - self.b1 ** state.count)
        torch._foreach_div_(update, denom)
        decayed = [(u, p) for u, p in zip(update, params) if self.decay_1d or p.ndim > 1]
        if self.weight_decay and decayed:
            torch._foreach_add_([u for u, _ in decayed], [p for _, p in decayed],
                                alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)
        return norm


@dataclasses.dataclass
class SGDState:
    count: int
    trace: List[torch.Tensor]


class SGD:
    """``optax.chain(add_decayed_weights(weight_decay, p.ndim > 1),
    sgd(schedule, momentum, nesterov))`` behind an optional global-norm clip,
    updating the parameters in place: g += weight_decay * p where p.ndim > 1;
    trace = g + momentum * trace; the direction is g + momentum * trace
    (Nesterov) or the trace; p -= schedule(count) * direction."""

    def __init__(self, schedule: Callable[[int], float], momentum: float, nesterov: bool,
                 weight_decay: float, clip_grad: Optional[float]):
        self.schedule = schedule
        self.momentum, self.nesterov = momentum, nesterov
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad

    def init(self, params: Sequence[torch.Tensor]) -> SGDState:
        return SGDState(0, [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: SGDState) -> Optional[torch.Tensor]:
        """One update of ``params`` and ``state`` in place (``grads`` is
        scratch). Returns the gradients' global norm before clipping when the
        clip is on."""
        params, grads = list(params), list(grads)
        norm = None
        if self.clip_grad is not None:
            norm = clip_by_global_norm(grads, self.clip_grad)
        decayed = [(g, p) for g, p in zip(grads, params) if p.ndim > 1]
        if self.weight_decay and decayed:
            torch._foreach_add_([g for g, _ in decayed], [p for _, p in decayed],
                                alpha=self.weight_decay)
        lr = self.schedule(state.count)
        state.count += 1
        torch._foreach_mul_(state.trace, self.momentum)
        torch._foreach_add_(state.trace, grads)
        if self.nesterov:
            update = torch._foreach_add(grads, state.trace, alpha=self.momentum)
        else:
            update = state.trace
        torch._foreach_add_(params, update, alpha=-lr)
        return norm


def opt_state_dict(state) -> dict:
    """An optimizer state (``AdamWState``, ``SGDState``) as a dict of its
    count and its tensor lists (the state's own tensors)."""
    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        out[f.name] = int(value) if f.name == "count" else list(value)
    return out


@torch.no_grad()
def load_opt_state(state, sd: dict) -> None:
    """Copy an ``opt_state_dict`` into ``state`` in place."""
    for f in dataclasses.fields(state):
        if f.name == "count":
            state.count = int(sd["count"])
            continue
        dst, src = getattr(state, f.name), sd[f.name]
        if len(dst) != len(src):
            raise ValueError(f"{f.name}: {len(src)} tensors saved, {len(dst)} here")
        for d, s in zip(dst, src):
            if d.shape != s.shape:
                raise ValueError(f"{f.name}: a saved {tuple(s.shape)} for {tuple(d.shape)}")
            d.copy_(s)


def freeze_non_head(model: torch.nn.Module, head_key: str = "head") -> None:
    """--no-grad: every parameter whose name does not hold ``head_key`` stops
    taking gradients, so it stays bit for bit what it was (the reference
    masks those updates to zero)."""
    for name, p in model.named_parameters():
        p.requires_grad_(head_key in name)


def make_optimizer(cfg: OptimConfig, global_batch_size: int):
    """→ ``(optimizer, schedule)`` for ``cfg``; the peak LR follows the
    batch-size scaling rule."""
    name = cfg.opt.lower()
    if name not in ("adamw", "sgd", "momentum", "nesterov"):
        raise _not_ported(f"optimizer {cfg.opt!r}")
    if cfg.weight_decay_end is not None:
        raise _not_ported("the cosine weight-decay schedule")
    if cfg.layer_decay is not None:
        raise _not_ported("layer-wise LR decay")
    if cfg.clip_grad is not None and cfg.clip_mode != "norm":
        raise _not_ported(f"clip mode {cfg.clip_mode!r}")
    schedule = make_schedule(cfg, cfg.resolved_lr(global_batch_size))
    if name == "adamw":
        return AdamW(schedule, cfg.betas[0], cfg.betas[1], cfg.eps, cfg.weight_decay,
                     cfg.clip_grad), schedule
    return SGD(schedule, cfg.momentum, name != "momentum", cfg.weight_decay,
               cfg.clip_grad), schedule
