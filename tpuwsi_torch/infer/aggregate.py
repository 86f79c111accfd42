"""Slide-level aggregation, AUC, and feature export.

A copy of ``tpuwsi/infer/aggregate.py``, which is itself free of jax, but
whose package ``tpuwsi.infer`` imports jax. The exports write the same bytes.

Parity: ``validate()`` (train.py:1146-1345) — accumulate per-tile softmax
over chunks, on 'Is Last Batch' compute slide score = mean tile softmax
(train.py:1288), slide target = first tile target (:1289), report per-patch
and per-slide AUC (:1334-1338); ``--extract_features`` saves per-slide
feature tensors (:1281-1282, 384-dim for ViT-S per :1203).

The exported inference ``.data`` pickle matches the reference MIL consumer's
8-tuple layout exactly (datasets.py:1048-1055):
  (labels, targets, scores, patch_scores, slide_names, features,
   batch_number, tile_locations)
with features (num_slides, 1, max_tiles, D) NaN-padded past each slide's
tile count (NaN is the slide-length signal, datasets.py:1089-1092).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Optional

import numpy as np


def roc_auc(scores, labels) -> float:
    """Host-side AUC (rank statistic, average-rank ties). Returns 0.5 when a
    single class is present (the reference try/excepts sklearn)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return 0.5
    from scipy.stats import rankdata  # scipy ships with sklearn dep tree

    ranks = rankdata(scores)
    rank_sum_pos = ranks[labels == 1].sum()
    u = rank_sum_pos - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


@dataclasses.dataclass
class SlideResult:
    slide_name: str
    slide_dataset: str
    patient_barcode: str
    label: int
    tile_probs: np.ndarray  # (n_tiles,) class-1 probability
    tile_locations: List
    features: Optional[np.ndarray] = None  # (n_tiles, D)
    # Raw slide target, -1 allowed for unknown; kept distinct from `label`
    # (reference MIL pickle layout, datasets.py:1048-1055 / :1195-1196).
    target: Optional[int] = None

    @property
    def resolved_target(self) -> int:
        return self.label if self.target is None else self.target

    @property
    def slide_score(self) -> float:
        return float(self.tile_probs.mean()) if len(self.tile_probs) else 0.5


class SlideAggregator:
    """Accumulates masked tile outputs chunk by chunk; finalizes per slide."""

    def __init__(self, extract_features: bool = False):
        self.extract_features = extract_features
        self._probs: List[np.ndarray] = []
        self._feats: List[np.ndarray] = []
        self._locs: List = []
        self.results: List[SlideResult] = []

    def add_chunk(self, chunk, probs: np.ndarray, features: Optional[np.ndarray] = None):
        """probs: (tiles_per_iter, n_classes) softmax (padded); features:
        (tiles_per_iter, D) or None. Padding removed via chunk.mask."""
        m = chunk.mask
        self._probs.append(np.asarray(probs)[m, 1])
        self._locs.extend(chunk.locations)
        if features is not None:
            self._feats.append(np.asarray(features)[m])
        if chunk.is_last_batch:
            self.results.append(
                SlideResult(
                    slide_name=chunk.slide_name,
                    slide_dataset=chunk.slide_dataset,
                    patient_barcode=chunk.patient_barcode,
                    label=int(np.asarray(chunk.label).ravel()[0]),
                    tile_probs=np.concatenate(self._probs),
                    tile_locations=list(self._locs),
                    features=np.concatenate(self._feats) if self._feats else None,
                    target=getattr(chunk, "target", None),
                )
            )
            self._probs, self._feats, self._locs = [], [], []

    # -- metrics ----------------------------------------------------------------
    def slide_auc(self) -> float:
        scores = [r.slide_score for r in self.results]
        labels = [r.label for r in self.results]
        return roc_auc(scores, labels)

    def patch_auc(self) -> float:
        scores = np.concatenate([r.tile_probs for r in self.results])
        labels = np.concatenate(
            [np.full(len(r.tile_probs), r.label) for r in self.results]
        )
        return roc_auc(scores, labels)

    def bootstrap_slide_auc(self, n_boot: int = 1000, seed: int = 0):
        """--bootstrap parity (train.py:366): slide-AUC mean ± std over
        resampled slide sets."""
        rng = np.random.default_rng(seed)
        scores = np.asarray([r.slide_score for r in self.results])
        labels = np.asarray([r.label for r in self.results])
        n = len(scores)
        aucs = []
        for _ in range(n_boot):
            pick = rng.integers(0, n, size=n)
            aucs.append(roc_auc(scores[pick], labels[pick]))
        return float(np.mean(aucs)), float(np.std(aucs))

    # -- exports ----------------------------------------------------------------
    def save_features_pt(self, out_dir: str):
        """Per-slide '<name>_features.pt' (train.py:1281-1282 parity)."""
        import torch

        os.makedirs(out_dir, exist_ok=True)
        for r in self.results:
            if r.features is None:
                continue
            base = ".".join(r.slide_name.split(".")[:-1])
            torch.save(
                torch.from_numpy(r.features),
                os.path.join(out_dir, f"{base}_features.pt"),
            )

    def save_inference_data(self, path: str, batch_number: int = 0):
        """Reference MIL 8-tuple pickle (datasets.py:1054-1055 layout)."""
        n = len(self.results)
        max_tiles = max((len(r.tile_probs) for r in self.results), default=0)
        dim = next(
            (r.features.shape[1] for r in self.results if r.features is not None),
            0,
        )
        labels = np.array([r.label for r in self.results])
        targets = np.array([r.resolved_target for r in self.results])
        scores = np.array([r.slide_score for r in self.results])
        patch_scores = np.full((n, max_tiles), np.nan, dtype=np.float32)
        features = np.full((n, 1, max_tiles, dim), np.nan, dtype=np.float32)
        tile_locations = np.full((n, max_tiles, 2), np.nan, dtype=np.float32)
        slide_names = [r.slide_name for r in self.results]
        for i, r in enumerate(self.results):
            k = len(r.tile_probs)
            patch_scores[i, :k] = r.tile_probs
            if r.features is not None:
                features[i, 0, :k, :] = r.features
            if r.tile_locations:
                tile_locations[i, :k] = np.asarray(r.tile_locations, dtype=np.float32)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(
                (
                    labels,
                    targets,
                    scores,
                    patch_scores,
                    slide_names,
                    features,
                    batch_number,
                    tile_locations,
                ),
                f,
            )
