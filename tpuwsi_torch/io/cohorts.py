"""Cohort registry: dataset name → {cohort id: directory} (``tpuwsi/io/cohorts.py``).

Parity: Dataset_Maker/dataset_utils.py:115-324 ``get_datasets_dir_dict`` and
the group helpers (:16-51). The reference hardcodes absolute paths per
platform/hostname; here the layout templates are data (relative to a
configurable ``data_root``, overridable via a YAML/JSON file or the
``TPUWSI_DATA_ROOT`` env var) while every cohort name, batch structure, and
composite dataset (CAT = CARMEL1-8 + TCGA + ABCTB, etc.) is preserved.
"""

from __future__ import annotations

import json
import os
import re
from enum import Enum
from typing import Dict

DEFAULT_DATA_ROOT = os.environ.get("TPUWSI_DATA_ROOT", "/mnt/gipmed_new/Data")


class DatasetGroup(Enum):
    CARMEL = 0
    HAEMEK = 1
    BENIGN = 2
    HER2 = 3
    TMA = 4
    ABCTB = 5
    TCGA = 6
    SHEBA = 7
    IPATIMUP = 8
    COVILHA = 9
    HEROHE = 10
    HAEMEK_ONCO = 11
    TCGA_LUNG = 12


def get_dataset_group(dataset: str) -> DatasetGroup:
    """dataset_utils.py:32-41 parity: strip digits/underscores to the group."""
    stripped = re.sub(r"[0-9_]+", "", dataset)
    if stripped == "HER":
        stripped = "HER2"
    elif stripped == "HAEMEKONCO":
        stripped = "HAEMEK_ONCO"
    elif stripped == "TCGALUNG":
        stripped = "TCGA_LUNG"
    return DatasetGroup[stripped]


def get_dataset_batch_num(dataset: str) -> str:
    """dataset_utils.py:44-51 parity (up to 100 batches)."""
    if not dataset[-1].isdigit():
        return ""
    if dataset[-2].isdigit():
        return dataset[-2:]
    return dataset[-1]


def _relative_layout(root: str) -> Dict[str, str]:
    j = os.path.join
    return {
        "TCGA": j(root, "Breast", "TCGA"),
        "ABCTB": j(root, "Breast", "ABCTB_ndpi", "ABCTB"),
        "ABCTB_TIF": j(root, "Breast", "ABCTB_TIF"),
        "HEROHE": j(root, "Breast", "HEROHE"),
        "SHEBA": j(root, "Breast", "Sheba"),
        "CARMEL": j(root, "Breast", "Carmel"),
        "CARMEL_BENIGN": j(root, "Breast", "Carmel", "Benign"),
        "TCGA_LUNG": j(root, "Lung", "TCGA_Lung", "TCGA_LUNG"),
        "ALL": j(root, "BoneMarrow", "ALL"),
        "AML": j(root, "BoneMarrow", "AML", "AML"),
        "Ipatimup": j(root, "Breast", "Ipatimup"),
        "Covilha": j(root, "Breast", "Covilha"),
        "TMA_HE_02_008": j(
            root, "Breast", "TMA", "bliss_data", "02-008", "HE", "TMA_HE_02-008"
        ),
        "TMA_HE_01_011": j(
            root, "Breast", "TMA", "bliss_data", "01-011", "HE", "TMA_HE_01-011"
        ),
        "HAEMEK": j(root, "Breast", "Haemek"),
        "PORTO_HE": j(root, "Lung", "PORTO_HE"),
        "PORTO_PDL1": j(root, "Lung", "sgils", "LUNG", "PORTO_PDL1"),
        "ABCTB_TILES": j(root, "ABCTB_TILES"),
    }


def load_registry_overrides(path: str | None = None) -> Dict[str, str]:
    """Optional JSON file {base name: absolute dir} overriding the layout."""
    path = path or os.environ.get("TPUWSI_COHORT_REGISTRY", "")
    if path and os.path.isfile(path):
        with open(path) as f:
            return json.load(f)
    return {}


def get_datasets_dir_dict(
    dataset: str,
    data_root: str | None = None,
    overrides: Dict[str, str] | None = None,
) -> Dict[str, str]:
    """Name → {cohort id: slide directory}; dataset_utils.py:115-324 parity."""
    root = data_root or DEFAULT_DATA_ROOT
    base = _relative_layout(root)
    base.update(overrides or load_registry_overrides())
    j = os.path.join
    d: Dict[str, str] = {}

    def carmel(ii: int) -> str:
        shelf = "1-8" if ii < 9 else "9-11"
        return j(base["CARMEL"], shelf, f"Batch_{ii}", f"CARMEL{ii}")

    def benign(ii: int) -> str:
        return j(base["CARMEL_BENIGN"], f"Batch_{ii}", f"BENIGN{ii}")

    if dataset == "ABCTB_TCGA":
        d["TCGA"] = base["TCGA"]
        d["ABCTB"] = base["ABCTB_TIF"]
    elif dataset == "CARMEL":
        for ii in range(1, 9):
            d[f"CARMEL{ii}"] = carmel(ii)
    elif dataset == "CARMEL+BENIGN":
        for ii in range(1, 9):
            d[f"CARMEL{ii}"] = carmel(ii)
        for ii in range(1, 4):
            d[f"BENIGN{ii}"] = benign(ii)
    elif dataset == "Carmel 9-11":
        for ii in range(9, 12):
            d[f"CARMEL{ii}"] = carmel(ii)
    elif dataset.startswith("CARMEL") and len(dataset) > 6:
        d[dataset] = carmel(int(dataset[6:]))
    elif dataset.startswith("BENIGN") and len(dataset) > 6:
        d[dataset] = benign(int(dataset[6:]))
    elif dataset == "CAT":
        for ii in range(1, 9):
            d[f"CARMEL{ii}"] = carmel(ii)
        d["TCGA"] = base["TCGA"]
        d["ABCTB"] = base["ABCTB_TIF"]
    elif dataset in ("TCGA", "TCGA_LUNG", "HEROHE", "ABCTB_TIF", "ABCTB_TILES",
                     "PORTO_HE", "PORTO_PDL1"):
        d[dataset] = base[dataset]
    elif dataset == "ABCTB":
        d["ABCTB"] = base["ABCTB_TIF"]
    elif dataset == "SHEBA":
        for ii in range(2, 7):
            d[f"SHEBA{ii}"] = j(base["SHEBA"], f"Batch_{ii}", f"SHEBA{ii}")
    elif dataset.startswith("SHEBA") and len(dataset) > 5:
        ii = int(dataset[5:])
        d[dataset] = j(base["SHEBA"], f"Batch_{ii}", f"SHEBA{ii}")
    elif dataset == "LEUKEMIA":
        d["ALL"] = base["ALL"]
        d["AML"] = base["AML"]
    elif dataset == "AML":
        d["AML"] = base["ALL"]  # (sic — mirrors dataset_utils.py:290)
    elif dataset == "ALL":
        d["ALL"] = base["ALL"]
    elif dataset == "IC":
        d["Ipatimup"] = base["Ipatimup"]
        d["Covilha"] = base["Covilha"]
    elif dataset == "HIC":
        d["Ipatimup"] = base["Ipatimup"]
        d["Covilha"] = base["Covilha"]
        d["HEROHE"] = base["HEROHE"]
    elif dataset in ("TMA_HE_02_008", "TMA_HE_01_011"):
        d[dataset] = base[dataset]
    elif dataset == "HAEMEK":
        d["HAEMEK1"] = j(base["HAEMEK"], "Batch_1", "HAEMEK1")
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    return d


def slides_data_file(dataset_dir: str, dataset_name: str, extension: str = "") -> str:
    """dataset_utils.py:54-55 parity."""
    return os.path.join(
        dataset_dir, f"slides_data_{dataset_name}{extension}.xlsx"
    )
