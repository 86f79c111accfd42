"""Combined two-feature-set MIL dataset: a copy of ``tpuwsi/mil/combined.py``.

Parity: ``Combined_Features_for_MIL_Training_dataset`` (datasets.py:1556-2040)
— joins two precomputed feature sets (e.g. CAT + CARMEL, or multi-resolution
CARMEL_10 + CARMEL_40) per slide or per patient, keeping only keys present in
BOTH sets, and returns per-dataset dicts keyed by dataset name (:1991-2040).
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from tpuwsi_torch.mil.features import FeaturesMILDataset


class CombinedFeaturesMILDataset:
    def __init__(
        self,
        datasets: Dict[str, FeaturesMILDataset],
        bag_size: int = 100,
    ):
        if len(datasets) < 2:
            raise ValueError("combined dataset needs at least two feature sets")
        self.datasets = datasets
        self.bag_size = bag_size

        def keys(ds: FeaturesMILDataset):
            if ds.is_per_patient:
                return set(ds._patients)
            return set(ds.slide_names)

        common = None
        for ds in datasets.values():
            common = keys(ds) if common is None else (common & keys(ds))
        self.keys: List[str] = sorted(common)
        # key→index maps: slide_names.index() per access is an O(N) string
        # scan (O(K·N·D) for the consistency check alone)
        self._index = {
            name: (
                None if ds.is_per_patient
                else {k: i for i, k in enumerate(ds.slide_names)}
            )
            for name, ds in datasets.items()
        }
        # target consistency across sets
        self._targets = {}
        for k in self.keys:
            ts = {
                self._target_of(name, ds, k)
                for name, ds in datasets.items()
            }
            if len(ts) != 1:
                raise ValueError(f"target mismatch across feature sets for {k}")
            self._targets[k] = ts.pop()

    def _target_of(self, name: str, ds: FeaturesMILDataset, key: str) -> int:
        if ds.is_per_patient:
            return ds.patient_data[key]["target"]
        return ds.targets[self._index[name][key]]

    def _features_of(self, name: str, ds: FeaturesMILDataset, key: str) -> np.ndarray:
        if ds.is_per_patient:
            return ds.patient_data[key]["features"]
        return ds.features[self._index[name][key]]

    def __len__(self):
        return len(self.keys)

    def sample(self, idx: int, rng: np.random.Generator) -> Dict:
        key = self.keys[idx]
        out = {"key": key, "target": self._targets[key]}
        for name, ds in self.datasets.items():
            feats = self._features_of(name, ds, key)
            n = feats.shape[0]
            pick = rng.choice(n, size=self.bag_size, replace=n < self.bag_size)
            out[name] = feats[pick]
        return out

    def bags(
        self, rng: np.random.Generator, batch_size: int, shuffle: bool = True
    ) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        names = list(self.datasets)
        for start in range(0, len(order), batch_size):
            chunk = order[start : start + batch_size]
            # ONE sample() per item (it draws every dataset's bag) — the
            # previous per-name comprehension re-sampled and discarded
            # D-1 of every D bags drawn
            samples = [self.sample(int(i), rng) for i in chunk]
            batch = {
                name: np.stack([s[name] for s in samples]) for name in names
            }
            batch["labels"] = np.asarray(
                [s["target"] for s in samples], np.int64
            )
            yield batch
