"""The survival slide table and its batches (``tpuwsi/io/survival.py``), on
column tables (``utils.minixlsx``) in place of pandas frames.

Parity: the survival datasets (datasets.py:2354-3461):
- the survival columns 'Censored', 'Follow-up Months Since Diagnosis',
  'survival status', 'Exclude for time prediction?' (:2440-2443);
- a slide is valid when it is not excluded and its censor flag and
  follow-up time are present (:2452-2459);
- the censor filters ``is_all_censored`` / ``is_all_not_censored``
  (:3039-3046);
- per slide the Binary Target, Time Target and Censored flag (:2709-2719);
- the censor-balanced training subset (utils.py:605-641).

The filters keep pandas' semantics on the JAX package's frames, as
``io/metadata.py`` does: the inner merge suffixes shared columns with
'_x' and '_y', a comparison with a blank is false.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np

from tpuwsi_torch.io.cohorts import get_datasets_dir_dict
from tpuwsi_torch.io.grids import grid_data_columns
from tpuwsi_torch.io.metadata import SlideTable, _concat, _merge_inner, _same, _unique, _where
from tpuwsi_torch.utils.labels import get_label
from tpuwsi_torch.utils.minixlsx import read_table

SURVIVAL_COLUMNS = (
    "Censored",
    "Follow-up Months Since Diagnosis",
    "survival status",
    "Exclude for time prediction?",
)


def load_survival_slide_table(
    dataset: str = "ABCTB",
    tile_size: int = 256,
    test_fold=1,
    infer_folds=(None,),
    train: bool = True,
    train_type: str = "REG",
    n_tiles: int = 10,
    bag_size: int = 50,
    desired_magnification: int = 10,
    is_all_censored: bool = False,
    is_all_not_censored: bool = False,
    censor_balance: bool = False,
    data_root: Optional[str] = None,
    dir_dict: Optional[Dict[str, str]] = None,
    rng: Optional[np.random.Generator] = None,
) -> SlideTable:
    dir_dict = dir_dict or get_datasets_dir_dict(dataset, data_root=data_root)
    frames = []
    for cohort_id, cohort_dir in dir_dict.items():
        slides = read_table(os.path.join(cohort_dir, f"slides_data_{cohort_id}"))
        grids = read_table(
            os.path.join(cohort_dir, f"Grids_{desired_magnification}", "Grid_data"))
        frames.append(_merge_inner(slides, grids, "file", suffixes=("_x", "_y")))
    df = _concat(frames)

    censored = np.asarray(df["Censored"], dtype=float)
    time_target = np.asarray(df["Follow-up Months Since Diagnosis"], dtype=float)
    binary_target = list(df["survival status"])
    excluded = np.asarray(df["Exclude for time prediction?"], dtype=object)

    # a NaN follow-up time is dropped too: an uncensored NaN-time slide would
    # give the Cox loss an empty risk set and the run an infinite loss
    valid = np.where(
        (excluded != "Exclude") & ~np.isnan(censored) & ~np.isnan(time_target))[0]

    total_col, legit_col = grid_data_columns(tile_size, desired_magnification)
    bad = (set(_where(df[total_col], lambda v: v == -1))
           | set(_where(df[legit_col], lambda v: v == 0))
           | (set(_where(df["bad segmentation"], lambda v: v == 1))
              if "bad segmentation" in df else set()))
    n_minimal = n_tiles if train_type == "REG" else (bag_size or 0)
    bad |= set(_where(df[legit_col], lambda v: v < n_minimal))
    valid = sorted(set(valid.tolist()) - bad)

    fold_col = "test fold idx breast" if dataset in ("CAT", "ABCTB_TCGA") else "test fold idx"
    test_fold_val = "test" if test_fold == 0 else test_fold
    if train_type in ("REG", "MIL"):
        if train:
            folds = _unique(df[fold_col])
            for f in (test_fold_val, "test", "val"):
                if f in folds:
                    folds.remove(f)
        else:
            folds = [test_fold_val, "val"]
    elif train_type == "Infer":
        # fold 0 is stored as the string 'test' in the fold column
        folds = ["test" if f == 0 else f for f in infer_folds]
    else:  # Infer_All_Folds
        folds = _unique(df[fold_col])
    fold_values = df[fold_col]
    valid = [i for i in valid if any(_same(fold_values[i], f) for f in folds)]

    # the censor filters (datasets.py:3039-3046)
    valid = [i for i in valid
             if not ((is_all_not_censored and censored[i] == 1)
                     or (is_all_censored and censored[i] != 1))]

    if censor_balance and train:
        # every uncensored slide and as many censored ones, drawn at random
        rng = rng or np.random.default_rng(2021)
        nc = [i for i in valid if censored[i] == 0]
        cc = [i for i in valid if censored[i] == 1]
        take = rng.choice(cc, size=min(len(nc), len(cc)), replace=False)
        valid = sorted(nc + [int(i) for i in take])

    pick = lambda col: [col[i] for i in valid]  # noqa: E731
    return SlideTable(
        dataset=dataset,
        tile_size=tile_size,
        desired_magnification=desired_magnification,
        file_names=pick(df["file"]),
        path_names=[dir_dict[i] for i in pick(df["id"])],
        cohort_ids=pick(df["id"]),
        folds=folds,
        tissue_tiles=pick(df[legit_col]),
        targets=[-1] * len(valid),  # survival: the class target is unused (:3055-3058)
        magnifications=pick(df["Manipulated Objective Power"]),
        patient_barcodes=pick(df["patient barcode"]),
        target_kind="survival",
        censored=[bool(censored[i]) for i in valid],
        target_binary=pick(binary_target),
        target_cont=[float(time_target[i]) for i in valid],
    )


def survival_batches(sampler, rng: np.random.Generator, batch_size: int,
                     **kw) -> Iterator[Dict[str, np.ndarray]]:
    """``WSITileSampler.batches`` with each tile's survival targets:
    ``binary_targets`` (int64, -1 unknown), ``time_targets`` (float32) and
    ``censored`` (bool) (datasets.py:2709-2719)."""
    table = sampler.table
    binary = np.asarray([get_label(t)[0] for t in table.target_binary], dtype=np.int64)
    times = np.asarray(table.target_cont, dtype=np.float32)
    cens = np.asarray(table.censored, dtype=bool)
    for batch in sampler.batches(rng, batch_size, **kw):
        idx = batch["slide_indices"]
        batch["binary_targets"] = binary[idx]
        batch["time_targets"] = times[idx]
        batch["censored"] = cens[idx]
        yield batch
