"""The survival training step (``tpuwsi/train/survival.py``).

Two objectives over the survival slide table's targets:

- ``mode="cox"`` (``-tar Survival_Time``): the negative Cox partial
  likelihood of the batch (``losses.cox_partial_likelihood``) on the head's
  first output as the risk, with the events ``1 - censored``;
- ``mode="binary"`` (``-tar Survival_Binary``): cross-entropy on the 5-year
  status, unknown (-1) targets masked out.

The step takes raw uint8 tiles and augments them on the device, as
``train.supervised.make_train_step`` does; its metrics (the loss, and the
C-index of the batch or its masked AUC) stay on the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from tpuwsi_torch.train.losses import cox_partial_likelihood
from tpuwsi_torch.train.metrics import auc_score
from tpuwsi_torch.train.state import TrainState


def concordance_index(risk, times, events) -> torch.Tensor:
    """Harrell's C-index on the device: the share of comparable pairs (t_i <
    t_j, i an event) that the risk orders right (higher risk, shorter
    survival), ties in risk counting a half; 0.5 with no comparable pair."""
    t_i, t_j = times[:, None], times[None, :]
    comparable = (t_i < t_j) & (events[:, None] > 0)
    correct = (risk[:, None] > risk[None, :]) & comparable
    ties = (risk[:, None] == risk[None, :]) & comparable
    n = comparable.sum()
    c = (correct.sum() + 0.5 * ties.sum()) / torch.clamp(n, min=1)
    return torch.where(n > 0, c, torch.full_like(c, 0.5))


def make_survival_train_step(model: nn.Module, optimizer, mode: str = "cox",
                             augment_fn: Optional[Callable] = None):
    """Return ``step(state, batch, generator=None) → (state, metrics)``.

    ``batch`` holds ``images`` (uint8), ``censored`` (bool) and
    ``time_targets`` (float) for ``mode="cox"``, ``binary_targets`` (int,
    -1 unknown) for ``mode="binary"``. The augmentation draws from
    ``generator`` first, then the model's dropout and stochastic depth. The
    optimizer updates the parameters of ``model`` that take gradients;
    ``state`` is updated in place and returned."""
    if mode not in ("cox", "binary"):
        raise ValueError(f"mode must be 'cox' or 'binary', got {mode!r}")
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, batch, generator=None):
        if state.model is not model:
            raise ValueError("the step was built for another model")
        images = batch["images"]
        if augment_fn is not None:
            with torch.no_grad():
                images = augment_fn(images, generator)
        out = model(images, deterministic=False, generator=generator)
        if mode == "cox":
            out = out[:, 0] if out.dim() > 1 else out
            events = 1.0 - batch["censored"].to(torch.float32)
            loss = cox_partial_likelihood(out.float(), batch["time_targets"], events)
        else:
            labels = batch["binary_targets"]
            mask = labels >= 0
            logp = torch.log_softmax(out.float(), dim=-1)
            nll = -logp.gather(-1, torch.clamp(labels, min=0).long()[:, None])[:, 0]
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
        grads = torch.autograd.grad(loss, params)
        optimizer.step(params, grads, state.opt_state)
        state.step += 1
        out = out.detach().float()
        metrics = {"loss": loss.detach()}
        if mode == "cox":
            metrics["c_index"] = concordance_index(out, batch["time_targets"], events)
        else:
            metrics["auc"] = auc_score(torch.softmax(out, dim=-1)[:, 1], labels, mask=mask)
        return state, metrics

    return step
