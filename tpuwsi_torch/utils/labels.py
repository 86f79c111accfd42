"""Label parsing and target/dataset validation (``tpuwsi/utils/labels.py``).

Parity: utils.py:770-785 ``get_label``, :506-545 ``assert_dataset_target``,
:874-889 ``cohort_to_int``, :788-794 ``num_2_bool``.
"""

from __future__ import annotations

import math
from typing import List

VALID_TARGETS = {
    "TMA_HE_02_008": {"ER", "temp", "binary_dist", "binary_live", "binary_any"},
    "TMA_HE_01_011": {"binary_live", "ER"},
    "PORTO_HE": {"PDL1", "EGFR", "is_full_cancer"},
    "PORTO_PDL1": {"PDL1"},
    "TCGA": {"ER", "PR", "Her2", "OR", "is_cancer", "Ki67"},
    "CAT": {"ER", "PR", "Her2", "OR", "is_cancer", "Ki67"},
    "ABCTB_TCGA": {"ER", "PR", "Her2", "OR", "is_cancer", "Ki67"},
    "IC": {"ER", "PR", "Her2", "OR", "Ki67"},
    "HIC": {"ER", "PR", "Her2", "OR", "Ki67"},
    "HEROHE": {"ER", "PR", "Her2", "OR", "Ki67"},
    "HAEMEK": {"ER", "PR", "Her2", "OR", "Ki67"},
    "CARMEL": {"ER", "PR", "Her2", "OR", "Ki67", "ER100"},
    "RedSquares": {"RedSquares"},
    "SHEBA": {
        "Onco",
        "onco_score_11",
        "onco_score_18",
        "onco_score_26",
        "onco_score_31",
        "onco_score_all",
    },
    "TCGA_LUNG": {"is_cancer", "is_LUAD", "is_full_cancer"},
    "LEUKEMIA": {
        "ALL", "is_B", "is_HR", "is_over_6", "is_over_10", "is_over_15",
        "WBC_over_20", "WBC_over_50", "is_HR_B", "is_tel_aml_B",
        "is_tel_aml_non_hr_B", "MRD_day0", "MRD_day15", "MRD_day33",
        "MRD_all_days", "AML", "provisional risk", "provisional risk 10",
    },
    "ABCTB": {"ER", "PR", "Her2", "survival", "Survival_Time", "Survival_Binary"},
    "ABCTB_TIF": {"ER", "PR", "Her2", "survival", "Survival_Time", "Survival_Binary"},
    "CARMEL+BENIGN": {"is_cancer"},
}
VALID_TARGETS["ALL"] = VALID_TARGETS["LEUKEMIA"]
VALID_TARGETS["AML"] = VALID_TARGETS["LEUKEMIA"]


def assert_dataset_target(dataset: str, target_kind):
    """utils.py:506-545 parity; raises ValueError on invalid combinations."""
    targets = set(target_kind if isinstance(target_kind, (list, tuple)) else [target_kind])
    key = dataset
    if key.startswith("CARMEL") and key not in VALID_TARGETS:
        key = "CARMEL"
    if key.startswith("SHEBA") and key not in VALID_TARGETS:
        key = "SHEBA"
    if key not in VALID_TARGETS:
        return  # datasets without a constraint table pass through
    if not targets <= VALID_TARGETS[key]:
        raise ValueError(
            f"invalid target(s) {sorted(targets)} for dataset {dataset}; "
            f"valid: {sorted(VALID_TARGETS[key])}"
        )


def get_label(target, multi_target: bool = False) -> List[int]:
    """utils.py:770-785 parity: 'Positive'→1, 'Negative'→0, numeric→int,
    anything else→-1 (unknown)."""
    if multi_target:
        out: List[int] = []
        for t in target:
            out.extend(get_label(t))
        return out
    if target == "Positive":
        return [1]
    if target == "Negative":
        return [0]
    if isinstance(target, (int, float)) and not (
        isinstance(target, float) and math.isnan(target)
    ):
        return [int(target)]
    if isinstance(target, str) and target.isnumeric():
        return [int(target)]
    return [-1]


COHORT_DICTIONARY = {
    "ABCTB": 0,
    **{f"CARMEL{i}": 1 for i in range(1, 9)},
    "TCGA": 2,
    "HAEMEK": 3,
    "HAEMEK1": 3,
}


def cohort_to_int(cohort_list: list) -> list:
    return [COHORT_DICTIONARY[key] for key in cohort_list]


def num_2_bool(num):
    if num == 1:
        return True
    if num == 0:
        return False
    return -1
