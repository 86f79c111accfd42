"""The supervised tile-classification step and its eval step
(``tpuwsi/train/supervised.py``).

The train step takes raw uint8 tiles and augments them on the device, then
forward, loss, backward, the optimizer and the EMA update. Its metrics
(loss, accuracy, AUC of the batch) stay on the device: the caller reads
them on the host at --log-interval and at the end of an epoch. Mixing
(Mixup/CutMix) and BatchNorm statistics are not ported (ROADMAP.md, M3b,
M6).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from tpuwsi_torch.train.ema import ema_update
from tpuwsi_torch.train.losses import cross_entropy
from tpuwsi_torch.train.metrics import accuracy_topk, auc_score
from tpuwsi_torch.train.state import TrainState


def step_metrics(logits: torch.Tensor, labels: torch.Tensor, loss: torch.Tensor) -> dict:
    """Loss, top-1 accuracy and AUC of the batch, as tensors on the device.
    Multi-target labels (B, T) score the first target's head, with -1
    (unknown) masked out."""
    if labels.dim() == 2:
        lm = labels[:, 0]
        mask = lm >= 0
        labels = torch.clamp(lm, min=0)
        logits = logits[:, :2]
    else:
        mask = None
    metrics = {"loss": loss.detach(),
               "acc": accuracy_topk(logits.detach(), labels, k=1, mask=mask)}
    if logits.shape[-1] >= 2:
        probs = torch.softmax(logits.detach().float(), dim=-1)
        metrics["auc"] = auc_score(probs[:, 1], labels, mask=mask)
    return metrics


def make_train_step(
    model: nn.Module,
    optimizer,
    augment_fn: Optional[Callable] = None,
    loss_fn: Callable = cross_entropy,
    ema_decay: Optional[float] = None,
):
    """Return ``step(state, batch, generator=None) → (state, metrics)``.

    ``model`` is the module ``state.model`` refers to; the optimizer updates
    its parameters that take gradients (all of them, or the head's under
    ``optim.freeze_non_head``), in ``model.parameters()`` order.
    ``augment_fn(images, generator)`` maps ``batch["images"]`` (uint8) to
    normalised float images; ``loss_fn(logits, labels)``. The augmentation
    draws from ``generator`` first, then the model's dropout and stochastic
    depth. With ``ema_decay`` and an EMA copy in the state, the copy takes
    ``decay * ema + (1 - decay) * params`` after the update. ``state`` is
    updated in place and returned.
    """
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, batch, generator=None):
        if state.model is not model:
            raise ValueError("the step was built for another model")
        images, labels = batch["images"], batch["labels"]
        if augment_fn is not None:
            with torch.no_grad():
                images = augment_fn(images, generator)
        logits = model(images, deterministic=False, generator=generator)
        loss = loss_fn(logits, labels)
        grads = torch.autograd.grad(loss, params)
        optimizer.step(params, grads, state.opt_state)
        if state.ema is not None and ema_decay is not None:
            ema_update(state.ema.parameters(), model.parameters(), ema_decay)
        state.step += 1
        return state, step_metrics(logits, labels, loss)

    return step


def eval_module(state: TrainState, use_ema: bool) -> nn.Module:
    """The module an evaluation scores (the reference's
    ``make_eval_step(use_ema=)``): the EMA copy where ``use_ema`` is set and
    the state has one (timm ranks checkpoints on the EMA copy's metrics when
    EMA is on), else the model."""
    return state.ema if use_ema and state.ema is not None else state.model


def make_eval_step(model: nn.Module, preprocess_fn: Optional[Callable] = None):
    """Return step(images) → (logits, fp32 softmax probs) for a tile batch."""

    def step(images: torch.Tensor):
        if preprocess_fn is not None:
            images = preprocess_fn(images)
        logits = model(images)
        return logits, torch.softmax(logits.float(), dim=-1)

    return step
