"""The MIL head's training over frozen tile features and the score export
(``tpuwsi/mil/train.py``).

Parity: the downstream MIL workflow that the reference's datasets feed, and
``save_all_slides_and_models_data`` (utils_MIL.py:1502-1600): per slide the
tile scores and the attention weights before and after the softmax, written
to xlsx.

The head is tiny (384 → 128 products a tile), so the host's bag draws set
the pace more than the card. The step's metrics stay on the device; the
loop reads them once an epoch.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from tpuwsi_torch.infer.aggregate import roc_auc
from tpuwsi_torch.infer.pipeline import eval_stream
from tpuwsi_torch.models.mil import GatedAttentionMIL, init_mil_weights
from tpuwsi_torch.train.losses import cross_entropy
from tpuwsi_torch.train.metrics import accuracy_topk, auc_score
from tpuwsi_torch.train.optim import AdamW
from tpuwsi_torch.train.state import TrainState, create_train_state


def make_mil_train_step(model: torch.nn.Module, optimizer):
    """Return ``step(state, batch) → (state, metrics)`` over a batch of bags
    (``features`` (B, N, D), ``mask`` (B, N), ``labels`` (B,) on the
    model's device): cross-entropy, the update, and the loss, top-1 accuracy
    and AUC of the batch as tensors on the device."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, batch):
        logits = model(batch["features"], batch["mask"])
        loss = cross_entropy(logits, batch["labels"])
        grads = torch.autograd.grad(loss, params)
        optimizer.step(params, grads, state.opt_state)
        state.step += 1
        logits = logits.detach()
        probs = torch.softmax(logits.float(), dim=-1)
        # in key order, as the reference's jitted step hands its dict back
        return state, {"acc": accuracy_topk(logits, batch["labels"]),
                       "auc": auc_score(probs[:, 1], batch["labels"]), "loss": loss.detach()}

    return step


def bags_on(batch: dict, device: torch.device, keys=("features", "mask", "labels")) -> dict:
    """A batch of bags as tensors on ``device`` (staged through pinned memory
    on a CUDA device)."""
    out = {k: torch.from_numpy(batch[k]) for k in keys if k in batch}
    if device.type == "cpu":
        return out
    return {k: v.pin_memory().to(device, non_blocking=True) for k, v in out.items()}


def evaluate_mil(model, dataset, batch_size: int = 16, seed: int = 0) -> dict:
    """Slide-level evaluation over a ``FeaturesMILDataset`` on the model's
    device: one pass in the dataset's order (bags drawn from
    ``default_rng(seed)``), the class-1 probability of each bag →
    ``eval_acc`` at 0.5, ``eval_n_slides``, and ``eval_auc`` where both
    classes are present (the MIL analogue of the reference's slide-level
    validate, train.py:1334-1338)."""
    device = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    probs, labels = [], []

    def fwd(batch):
        b = bags_on(batch, device, ("features", "mask"))
        return torch.softmax(model(b["features"], b["mask"]).float(), dim=-1)

    with torch.inference_mode():
        for batch, p in eval_stream(dataset.bags(rng, batch_size, shuffle=False),
                                    lambda b: b, fwd):
            probs.extend(p[:, 1].tolist())
            labels.extend(np.asarray(batch["labels"]).tolist())
    out = {"eval_acc": float(np.mean((np.asarray(probs) > 0.5) == np.asarray(labels))),
           "eval_n_slides": len(labels)}
    if len(set(labels)) == 2:
        out["eval_auc"] = roc_auc(probs, labels)
    return out


def train_mil_head(
    dataset,
    num_classes: int = 2,
    hidden_dim: int = 128,
    epochs: int = 20,
    batch_size: int = 16,
    lr: float = 1e-3,
    seed: int = 0,
    eval_dataset=None,
    log_fn: Optional[Callable] = None,
    steps_per_dispatch: int = 1,
    device: Optional[torch.device] = None,
):
    """Train a ``GatedAttentionMIL`` head over a ``FeaturesMILDataset`` with
    ``optax.adamw(lr)``'s update (b1 0.9, b2 0.999, eps 1e-8, weight decay
    1e-4 on every parameter). The bags come from one
    ``np.random.default_rng(seed)``, in the JAX loop's order: first one
    batch drawn only to size the model, then each epoch's shuffle and
    bags. The initial weights come from a CPU generator seeded with
    ``seed``. ``eval_dataset``: evaluated after every epoch, its metrics
    merged into the logged ones. ``steps_per_dispatch`` is the reference's
    grouping of full batches, whose ragged batch comes last either way: the
    steps run one after another in the same order. ``device`` None means the
    CUDA device, and raises where there is none. → (model, state)."""
    from tpuwsi_torch.core.device import require_cuda

    del steps_per_dispatch
    if device is None:
        device = require_cuda()
    rng = np.random.default_rng(seed)
    first = next(dataset.bags(rng, batch_size))
    model = GatedAttentionMIL(first["features"].shape[-1], hidden_dim=hidden_dim,
                              num_classes=num_classes)
    init_mil_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    optimizer = AdamW(lambda count: lr, 0.9, 0.999, 1e-8, 1e-4, None, decay_1d=True)
    state = create_train_state(model, optimizer)
    step = make_mil_train_step(model, optimizer)
    for epoch in range(epochs):
        metrics = {}
        for batch in dataset.bags(rng, batch_size):
            state, metrics = step(state, bags_on(batch, device))
        metrics = {k: float(v) for k, v in metrics.items()}
        if eval_dataset is not None:
            metrics.update(evaluate_mil(model, eval_dataset, batch_size, seed))
        if log_fn:
            log_fn(epoch, metrics)
    return model, state


def export_slide_scores_xlsx(out_path: str, slide_names, slide_scores, targets,
                             tile_scores_list, attention_before_list=None,
                             attention_after_list=None):
    """``save_all_slides_and_models_data`` (utils_MIL.py:1502-1600): one sheet
    of a row per slide (``slide_name``, ``slide_score``, ``target``), the
    tile scores and the attention weights before and after the softmax in
    numbered columns, blank past a slide's tiles."""
    from tpuwsi_torch.utils.minixlsx import typed_column, write_xlsx

    max_tiles = max(len(t) for t in tile_scores_list)
    columns = {"slide_name": list(slide_names),
               "slide_score": [float(s) for s in slide_scores],
               "target": [int(t) for t in targets]}
    for prefix, lists in (("tile_score", tile_scores_list),
                          ("attn_before", attention_before_list),
                          ("attn_after", attention_after_list)):
        if lists is None:
            continue
        for j in range(max_tiles):
            columns[f"{prefix}_{j}"] = typed_column(
                float(v[j]) if j < len(v) else None for v in lists)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_xlsx(out_path, columns)
