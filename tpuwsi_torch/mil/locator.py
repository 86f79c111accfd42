"""Feature-location registry: a copy of ``tpuwsi/mil/locator.py``.

Parity: utils_MIL.py:10-1366 ``get_RegModel_Features_location_dict`` and
:1367-1499 ``dataset_properties_to_location`` — a ~1,350-line hardcoded
nested dict mapping (platform, train set, fold, target) → feature dirs and
REG-model checkpoints. The rebuild externalizes this environment-specific
data into a JSON registry file while keeping the exact lookup API, including
the paired ``Receptor + is_Tumor`` entries (utils_MIL.py:876-882 semantics).

Registry schema (JSON):
{
  "CAT": {"ER": {"1": {
      "TrainSet Location": {"train": "...", "test": "..."},
      "REG Model Location": "...ckpt",
      "is_Tumor": {"TrainSet Location": {...}}   # optional paired set
  }}}
}
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

DEFAULT_REGISTRY_ENV = "TPUWSI_FEATURE_REGISTRY"


class FeatureLocator:
    def __init__(self, registry: Optional[Dict] = None, path: Optional[str] = None):
        if registry is None:
            path = path or os.environ.get(DEFAULT_REGISTRY_ENV, "")
            if path and os.path.isfile(path):
                with open(path) as f:
                    registry = json.load(f)
            else:
                registry = {}
        self.registry = registry

    def dataset_properties_to_location(
        self,
        dataset_name: str,
        target: str,
        test_fold,
        is_train: bool = False,
    ):
        """utils_MIL.py:1367 parity: → (feature dir, REG ckpt, dataset name,
        target). Raises KeyError with a helpful message when unregistered."""
        try:
            entry = self.registry[dataset_name][target][str(test_fold)]
        except KeyError as e:
            raise KeyError(
                f"no feature registry entry for (dataset={dataset_name}, "
                f"target={target}, fold={test_fold}); register it in the JSON "
                f"registry (${DEFAULT_REGISTRY_ENV})"
            ) from e
        split = "train" if is_train else "test"
        loc = entry["TrainSet Location"]
        feature_dir = loc[split] if isinstance(loc, dict) else loc
        return (
            feature_dir,
            entry.get("REG Model Location"),
            dataset_name,
            target,
        )

    def paired_is_tumor_location(self, dataset_name: str, target: str, test_fold,
                                 is_train: bool = False):
        """The '+is_Tumor' paired feature set, when registered."""
        entry = self.registry[dataset_name][target][str(test_fold)]
        tumor = entry.get("is_Tumor")
        if tumor is None:
            raise KeyError(f"no is_Tumor pairing for {dataset_name}/{target}")
        split = "train" if is_train else "test"
        loc = tumor["TrainSet Location"]
        return loc[split] if isinstance(loc, dict) else loc

    def paired_locations(self, dataset_name: str, target: str, test_fold,
                         is_train: bool = False) -> tuple:
        """(receptor_dir, is_tumor_dir) — pass directly to
        ``FeaturesMILDataset(data_location=...)`` for the paired
        Receptor+is_Tumor bag mode (datasets.py:876-882)."""
        receptor, _, _, _ = self.dataset_properties_to_location(
            dataset_name, target, test_fold, is_train
        )
        tumor = self.paired_is_tumor_location(
            dataset_name, target, test_fold, is_train
        )
        return receptor, tumor

    def register(self, dataset_name: str, target: str, test_fold, locations: Dict):
        self.registry.setdefault(dataset_name, {}).setdefault(target, {})[
            str(test_fold)
        ] = locations

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.registry, f, indent=2)
