"""The MIL head's trainer over feature bags: ``python -m
tpuwsi_torch.cli.mil_train ...`` (``tpuwsi/cli/mil_train.py``).

    python -m tpuwsi_torch.cli.mil_train --features runs/Exp_1/features \\
        --test-features runs/Exp_2/features --bag-size 100 --epochs 30 \\
        --output runs/mil --export-xlsx

or through the feature registry (``$TPUWSI_FEATURE_REGISTRY``):

    python -m tpuwsi_torch.cli.mil_train --dataset CAT -tar ER -tf 1 [--paired-is-tumor]

It trains the gated-attention MIL head (``models.mil.GatedAttentionMIL``)
over the reference's 6-, 7- or 8-tuple ``inference.data`` pickles (the
port's ``-ef`` writes the 8-tuple), evaluates the slide-level AUC after
every epoch, checkpoints the head (ranked by ``eval_auc``) and with
--export-xlsx writes each slide's tile scores and attention weights before
and after the softmax to ``slide_scores.xlsx``, as
``save_all_slides_and_models_data`` does. It runs on the CUDA device unless
``main`` is given ``device=torch.device("cpu")``.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    """The JAX trainer's arguments (``tpuwsi/cli/mil_train.py:34``)."""
    p = argparse.ArgumentParser("tpuwsi_torch MIL head trainer")
    src = p.add_argument_group("feature source")
    src.add_argument("--features", default=None,
                     help="train feature dir / .data file (skips the registry)")
    src.add_argument("--test-features", default=None, help="held-out feature dir / .data file")
    src.add_argument("--dataset", default="CAT",
                     help="registry dataset name (with --features unset)")
    src.add_argument("-tar", "--target", dest="target", default="ER")
    src.add_argument("-tf", "--test_fold", dest="test_fold", default=1, type=int)
    src.add_argument("--paired-is-tumor", action="store_true",
                     help="load the registered Receptor+is_Tumor paired set (per-tile "
                          "concatenated features, datasets.py:876-882)")
    bag = p.add_argument_group("bags")
    bag.add_argument("--bag-size", default=100, type=int)
    bag.add_argument("--per-patient", action="store_true",
                     help="group bags per patient (datasets.py:1117-1148)")
    bag.add_argument("--fixed-tile-num", default=None, type=int)
    bag.add_argument("--minimum-tiles", default=50, type=int,
                     help="drop slides with fewer tiles (reference default)")
    tr = p.add_argument_group("training")
    tr.add_argument("--epochs", default=30, type=int)
    tr.add_argument("-b", "--batch-size", dest="batch_size", default=16, type=int)
    tr.add_argument("--lr", default=1e-3, type=float)
    tr.add_argument("--hidden-dim", default=128, type=int)
    tr.add_argument("--seed", default=0, type=int)
    tr.add_argument("--steps-per-dispatch", default=8, type=int,
                    help="the reference's steps per device dispatch; here the steps run "
                         "one after another in the same order")
    out = p.add_argument_group("output")
    out.add_argument("--output", default="runs/mil")
    out.add_argument("--export-xlsx", action="store_true",
                     help="per-slide tile scores + attention weights "
                          "(save_all_slides_and_models_data parity)")
    return p


def _resolve_locations(args):
    """→ (train location, test location): --features / --test-features, or
    the registry's entry for (--dataset, --target, --test_fold), paired with
    its is_Tumor set under --paired-is-tumor."""
    if args.features:
        return args.features, args.test_features
    from tpuwsi_torch.mil.locator import FeatureLocator

    loc = FeatureLocator()
    if args.paired_is_tumor:
        return tuple(loc.paired_locations(args.dataset, args.target, args.test_fold,
                                          is_train=is_train) for is_train in (True, False))
    return tuple(loc.dataset_properties_to_location(args.dataset, args.target, args.test_fold,
                                                    is_train=is_train)[0]
                 for is_train in (True, False))


def export_scores(model, dataset, out_path: str) -> str:
    """Per-slide export over ALL tiles of each bag entry, each bag at its own
    length on the model's device: the slide score from the pooled head, the
    tile scores from the ``(w1 - w0)ᵀ f`` readout of the classifier
    (utils_MIL.py:1603-1630; paired features slice back to the receptor
    half), the attention before and after the softmax."""
    from tpuwsi_torch.mil.train import export_slide_scores_xlsx
    from tpuwsi_torch.models.mil import tile_scores_from_head

    device = next(model.parameters()).device
    weight = model.classifier.weight.detach().cpu().numpy()  # (classes, D)
    receptor_slice = weight.shape[1] // 2 if getattr(dataset, "paired_is_tumor", False) else None
    names, slide_scores, targets, tile_scores, befores, afters = [], [], [], [], [], []
    with torch.inference_mode():
        for i in range(len(dataset)):
            feats, target, _, name = dataset._entry(i)
            f = torch.from_numpy(np.ascontiguousarray(feats, np.float32))[None].to(device)
            logits, before, after = model(f, return_attention=True)
            names.append(name)
            slide_scores.append(float(torch.softmax(logits.float(), dim=-1)[0, 1]))
            targets.append(int(target))
            tile_scores.append(tile_scores_from_head(feats, weight, receptor_slice).tolist())
            befores.append(before[0].cpu().tolist())
            afters.append(after[0].cpu().tolist())
    export_slide_scores_xlsx(out_path, names, slide_scores, targets, tile_scores, befores,
                             afters)
    return out_path


def main(argv=None, device: Optional[torch.device] = None):
    """Train, evaluate, checkpoint and (--export-xlsx) export, as the JAX
    ``main`` does. ``device`` None means the CUDA device, and raises where
    there is none. → (model, state, the final evaluation's metrics)."""
    from tpuwsi_torch.core.device import require_cuda
    from tpuwsi_torch.mil.features import FeaturesMILDataset
    from tpuwsi_torch.mil.train import evaluate_mil, train_mil_head
    from tpuwsi_torch.train.checkpoint import CheckpointManager

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if device is None:
        device = require_cuda()
    train_loc, test_loc = _resolve_locations(args)

    def make_ds(loc, is_train):
        return FeaturesMILDataset(
            loc, bag_size=args.bag_size, target=args.target.split("+")[0], is_train=is_train,
            is_per_patient=args.per_patient, fixed_tile_num=args.fixed_tile_num,
            minimum_tiles_in_slide=args.minimum_tiles)

    train_ds = make_ds(train_loc, True)
    eval_ds = make_ds(test_loc, False) if test_loc else None
    logging.info("MIL: %d train bags%s, bag_size=%d%s", len(train_ds),
                 f", {len(eval_ds)} eval bags" if eval_ds else "", args.bag_size,
                 " (paired Receptor+is_Tumor)" if train_ds.paired_is_tumor else "")

    model, state = train_mil_head(
        train_ds, hidden_dim=args.hidden_dim, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, seed=args.seed, eval_dataset=eval_ds,
        steps_per_dispatch=args.steps_per_dispatch, device=device,
        log_fn=lambda e, m: logging.info("epoch %d %s", e,
                                         " ".join(f"{k}={v:.4f}" for k, v in m.items())))

    os.makedirs(args.output, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(args.output, "checkpoints"), metric_name="eval_auc")
    final = (evaluate_mil(model, eval_ds, args.batch_size, args.seed)
             if eval_ds is not None else {})
    ckpt.save(state.step, state, final or {"eval_auc": 0.0})
    ckpt.close()
    if final:
        logging.info("final eval: %s", final)
    if args.export_xlsx:
        path = export_scores(model, eval_ds if eval_ds is not None else train_ds,
                             os.path.join(args.output, "slide_scores.xlsx"))
        logging.info("slide scores → %s", path)
    return model, state, final


if __name__ == "__main__":
    main()
