"""Slide metadata: load, merge, filter, and fold-split cohort tables
(``tpuwsi/io/metadata.py``), on column tables (``utils.minixlsx``) in place
of pandas frames.

Parity: WSI_Master_Dataset.__init__ (datasets.py:28-443) — merging per-cohort
``slides_data_<id>.xlsx`` with ``Grids_<mag>/Grid_data.xlsx`` on 'file'
(:98-115), dropping null ids (:117-119), PORTO lung-origin filter (:125-128),
ER balancing hook (:130-134), the 'OR' composite target (:136-144), survival
targets (:146-157), multi-target '+' kinds (:55-61, :159-164), LEUKEMIA day
filters (:182-188), valid-label selection incl. numeric multiclass
(:192-213), no-grid/zero-tile/few-tile/bad-seg/er≠pr exclusions (:220-258),
RAM_saver subsampling (:260-264), and fold selection for
REG/MIL/Infer/Infer_All_Folds incl. the CAT breast fold column (:266-304).

Every filter keeps pandas' semantics on the JAX package's frames: the inner
merge keeps the slide table's row order, a comparison with a blank is false
(``!=`` true), ``isin`` and ``unique`` compare by value with NaN equal to
NaN, and ``unique`` keeps the order of first appearance.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from tpuwsi_torch.io.cohorts import get_datasets_dir_dict
from tpuwsi_torch.io.grids import grid_data_columns
from tpuwsi_torch.utils.labels import assert_dataset_target, cohort_to_int, get_label
from tpuwsi_torch.utils.minixlsx import (
    Table,
    is_null,
    n_rows,
    read_table,
    scalar,
    typed_column,
)


@dataclasses.dataclass
class SlideTable:
    """Filtered, fold-selected slide list ready for samplers."""

    dataset: str
    tile_size: int
    desired_magnification: int
    file_names: List[str]
    path_names: List[str]  # cohort directory per slide
    cohort_ids: List[str]
    folds: List
    tissue_tiles: List[int]
    targets: List  # raw target strings/values
    magnifications: List[float]
    patient_barcodes: List[str]
    multi_target: bool = False
    target_kind: object = "ER"
    # survival extras
    censored: Optional[List] = None
    target_binary: Optional[List] = None
    target_cont: Optional[List] = None
    cohort_ints: Optional[List[int]] = None

    def __len__(self):
        return len(self.file_names)

    def labels(self) -> np.ndarray:
        out = [get_label(t, self.multi_target) for t in self.targets]
        return np.asarray(out, dtype=np.int64)

    def slide_path(self, idx: int) -> str:
        return os.path.join(self.path_names[idx], self.file_names[idx])


def split_table(
    table: SlideTable, train_fraction: float = 0.8,
    rng: Optional[np.random.Generator] = None,
) -> tuple:
    """--supervised 80/20 random split parity (train.py:715-717): partition
    one table's slides into train/val subsets."""
    rng = rng or np.random.default_rng(0)
    n = len(table)
    order = rng.permutation(n)
    n_train = int(round(n * train_fraction))
    per_slide = ("file_names", "path_names", "cohort_ids", "tissue_tiles", "targets",
                 "magnifications", "patient_barcodes")
    optional = ("censored", "target_binary", "target_cont", "cohort_ints")

    def take(idxs):
        idxs = sorted(int(i) for i in idxs)
        fields = {f: [getattr(table, f)[i] for i in idxs] for f in per_slide}
        for f in optional:
            col = getattr(table, f)
            fields[f] = [col[i] for i in idxs] if col else None
        return dataclasses.replace(table, **fields)

    return take(order[:n_train]), take(order[n_train:])


# -- column tables as pandas treats them -----------------------------------------

def _same(a, b) -> bool:
    """Equality of two cells as pandas' ``isin``/``unique`` match them."""
    if is_null(a) or is_null(b):
        return is_null(a) and is_null(b)
    return bool(a == b)


def _unique(values: list) -> list:
    """``Series.unique()``: first appearances, in order (numpy scalars in a
    numeric column, as pandas hands them back)."""
    out, first = [], []
    for i, v in enumerate(values):
        if not any(_same(v, u) for u in out):
            out.append(v)
            first.append(i)
    return [scalar(values, i) for i in first]


def _take(table: Table, rows: Sequence[int]) -> Table:
    return {name: [col[i] for i in rows] for name, col in table.items()}


def _where(values: list, pred) -> List[int]:
    """Row positions where ``pred`` holds; a blank cell never matches."""
    return [i for i, v in enumerate(values) if not is_null(v) and pred(v)]


def _not_equal(a: list, b: list) -> List[int]:
    """Rows of ``a != b``: true where either is blank."""
    return [i for i, (x, y) in enumerate(zip(a, b))
            if is_null(x) or is_null(y) or bool(x != y)]


def _merge_inner(left: Table, right: Table, on: str, suffix: str = "_grid") -> Table:
    """``pd.merge(left, right, on=on, how="inner", suffixes=("", suffix))``:
    each left row in order, with every matching right row in order; blank
    keys match blank keys."""
    pairs = [(i, j) for i, key in enumerate(left[on])
             for j, other in enumerate(right[on]) if _same(key, other)]
    out = {name: [col[i] for i, _ in pairs] for name, col in left.items()}
    for name, col in right.items():
        if name == on:
            continue
        out[name + suffix if name in left else name] = [col[j] for _, j in pairs]
    return out


def _concat(tables: List[Table]) -> Table:
    """``pd.concat(tables, ignore_index=True)``: the columns in order of first
    appearance, NaN where a table lacks one, each column typed anew."""
    names = list(dict.fromkeys(name for t in tables for name in t))
    return {name: typed_column(v for t in tables
                               for v in t.get(name, [math.nan] * n_rows(t)))
            for name in names}


# -- the slide table ----------------------------------------------------------------

def load_slide_table(
    dataset: str = "TCGA",
    tile_size: int = 256,
    target_kind="ER",
    test_fold=1,
    infer_folds: Sequence = (None,),
    train: bool = True,
    train_type: str = "REG",
    n_tiles: int = 10,
    bag_size: int = 50,
    desired_magnification: int = 10,
    dx: bool = False,
    er_eq_pr: bool = False,
    ram_saver: bool = False,
    balanced_dataset: bool = False,
    slide_per_block: bool = False,
    data_root: Optional[str] = None,
    dir_dict: Optional[Dict[str, str]] = None,
    rng: Optional[np.random.Generator] = None,
) -> SlideTable:
    multi_target = isinstance(target_kind, str) and "+" in target_kind
    if multi_target:
        target_kind = target_kind.split("+")
    assert_dataset_target(dataset, target_kind)

    dir_dict = dir_dict or get_datasets_dir_dict(dataset, data_root=data_root)
    frames = []
    for cohort_id, cohort_dir in dir_dict.items():
        slides = read_table(os.path.join(cohort_dir, f"slides_data_{cohort_id}"))
        grids = read_table(
            os.path.join(cohort_dir, f"Grids_{desired_magnification}", "Grid_data"))
        frames.append(_merge_inner(slides, grids, "file"))
    df = _concat(frames)

    if any(is_null(v) for v in df["id"]):
        df = _take(df, [i for i, v in enumerate(df["id"]) if not is_null(v)])

    if dataset in ("PORTO_HE", "PORTO_PDL1"):
        df = _take(df, _where(df["Origin"], lambda v: v == "lung"))

    if balanced_dataset and target_kind in ("ER", "ER100"):
        # patient-level ER balancing (datasets.py:130-134, utils.py:605-665)
        from tpuwsi_torch.utils.balance import balance_dataset_er

        df = balance_dataset_er(df, rng)
        df = _take(df, _where(df["use_in_balanced_data_ER"], lambda v: v == 1))
    n = n_rows(df)

    # Targets
    survival = target_kind in ("Survival_Time", "Survival_Binary")
    all_censored = all_cont = all_binary = all_cohorts = None
    if survival:
        all_censored = list(df["Censored"])
        all_cont = list(df["Time (months)"])
        all_binary = list(df["Survival Binary (5 Yr)"])
        all_cohorts = cohort_to_int(list(df["id"]))
        all_targets = all_binary if target_kind == "Survival_Binary" else all_cont
    elif target_kind == "OR":
        all_targets = []
        for p, e in zip(df["PR status"], df["ER status"]):
            if p == "Positive" or e == "Positive":
                all_targets.append("Positive")
            elif p == "Negative" or e == "Negative":
                all_targets.append("Negative")
            else:
                all_targets.append("Missing Data")
    elif multi_target:
        cols = [df[f"{t} status"] for t in target_kind]
        all_targets = [tuple(scalar(c, i) for c in cols) for i in range(n)]
    else:
        all_targets = list(df[f"{target_kind} status"])

    # --slide_per_block (datasets.py:167-181): CARMEL-only — a patient
    # barcode's last two characters index the slide within its tissue block;
    # keep only the first slide per block.
    excess = set()
    if slide_per_block:
        if dataset == "CARMEL":
            blocks = [b[:-2] if isinstance(b, str) else str(b) for b in df["patient barcode"]]
            first = {}
            for i, b in enumerate(blocks):
                first.setdefault(b, i)
            excess |= set(range(n)) - set(first.values())
        else:
            raise ValueError("slide_per_block only implemented for CARMEL dataset")

    # LEUKEMIA day filters (datasets.py:182-188)
    if dataset in ("LEUKEMIA", "ALL"):
        want = {"MRD_day33": 33, "MRD_day15": 15}.get(
            target_kind if isinstance(target_kind, str) else "", 0)
        excess |= set(_not_equal(df["Day_0/15/33_fixed"], [want] * n))

    # Valid labels (datasets.py:192-213)
    if target_kind == "Survival_Time":
        valid = np.where(~np.isnan(np.asarray(all_targets, dtype=float)))[0]
    elif multi_target:
        valid = np.asarray([i for i, t in enumerate(all_targets)
                            if any(isinstance(v, str) and v in ("Positive", "Negative")
                                   for v in t)], dtype=np.int64)
    else:
        ok = {"Positive", "Negative", *(str(d) for d in range(10))}
        as_str = []
        for t in all_targets:
            if isinstance(t, (int, float)) and not (isinstance(t, float) and np.isnan(t)):
                as_str.append(str(int(t)))
            else:
                as_str.append(str(t))
        valid = np.asarray([i for i, s in enumerate(as_str) if s in ok], dtype=np.int64)

    if len(valid) == 0 or train_type == "Infer_All_Folds":
        valid = np.arange(len(all_targets))

    total_col, legit_col = grid_data_columns(tile_size, desired_magnification)
    no_grid = set(_where(df[total_col], lambda v: v == -1))
    zero_tiles = set(_where(df[legit_col], lambda v: v == 0))
    bad_seg = (set(_where(df["bad segmentation"], lambda v: v == 1))
               if "bad segmentation" in df else set())
    er_not_pr = (set(_not_equal(df["ER status"], df["PR status"]))
                 if er_eq_pr and train else set())
    # few-tiles minimum: REG→n_tiles, MIL→bag_size, Infer→none (the reference
    # passes bag_size=None on the Infer path, datasets.py:649, so the < filter
    # is vacuous there).
    if train_type == "REG":
        n_minimal = n_tiles
    elif train_type == "MIL":
        n_minimal = bag_size
    else:
        n_minimal = 0
    few_tiles = set(_where(df[legit_col], lambda v: v < n_minimal))

    valid = np.array(sorted(
        set(valid.tolist()) - no_grid - zero_tiles - bad_seg - er_not_pr - few_tiles - excess
    ))

    if ram_saver and len(valid) > 0:
        rng = rng or np.random.default_rng()
        valid = rng.choice(valid, size=round(len(valid) / 4), replace=False)

    # Fold selection (datasets.py:266-304)
    if dataset in ("CAT", "ABCTB_TCGA"):
        fold_col = "test fold idx breast"
    elif target_kind in ("is_tel_aml_B", "is_tel_aml_non_hr_B"):
        fold_col = "test fold idx for is_tel_aml_B"
    else:
        fold_col = "test fold idx"
    test_fold_val = "test" if test_fold == 0 else test_fold

    if train_type in ("REG", "MIL"):
        if train:
            folds = _unique(df[fold_col])
            if test_fold != -1 and test_fold_val in folds:
                folds.remove(test_fold_val)
            for special in ("test", "val"):
                if special in folds:
                    folds.remove(special)
        else:
            folds = [test_fold_val, "val"] if test_fold != -1 else []
    elif train_type == "Infer":
        folds = ["test" if f == 0 else f for f in infer_folds]
    elif train_type == "Infer_All_Folds":
        folds = _unique(df[fold_col])
    else:
        raise ValueError(f"train_type {train_type!r} is not defined")

    fold_values = df[fold_col]
    valid = np.asarray([int(i) for i in valid
                        if any(_same(fold_values[int(i)], f) for f in folds)], dtype=np.int64)

    # DX filter (TCGA-only, datasets.py:313-316, 369-370)
    if "TCGA" not in dir_dict:
        dx = False
    if dx:
        valid = np.asarray([i for i in valid if bool(df["DX"][i])], dtype=np.int64)

    sel = _take(df, [int(i) for i in valid])
    pick = lambda col: [col[int(i)] for i in valid]  # noqa: E731
    return SlideTable(
        dataset=dataset,
        tile_size=tile_size,
        desired_magnification=desired_magnification,
        file_names=sel["file"],
        path_names=[dir_dict[i] for i in sel["id"]],
        cohort_ids=sel["id"],
        folds=folds,
        tissue_tiles=sel[legit_col],
        targets=pick(all_targets),
        magnifications=sel["Manipulated Objective Power"],
        patient_barcodes=sel["patient barcode"],
        multi_target=multi_target,
        target_kind=target_kind,
        censored=pick(all_censored) if survival else None,
        target_binary=pick(all_binary) if survival else None,
        target_cont=pick(all_cont) if survival else None,
        cohort_ints=pick(all_cohorts) if survival else None,
    )
