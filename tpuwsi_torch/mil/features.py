"""MIL over precomputed feature bags: a copy of ``tpuwsi/mil/features.py``,
which is plain numpy, but whose package ``tpuwsi.mil`` imports jax.

Parity: ``Features_MILdataset`` (datasets.py:820-1553):
- reads inference ``.data`` pickles in the 6/7/8-tuple layout (:1043-1055),
  detecting each slide's true tile count from the first NaN in feature
  channel 0 (:1089-1092);
- slide-name fixups (:1067-1072: the renamed Carmel-9 slide, .ndpi→.tif);
- ``carmel_only`` mrxs filter (:1083-1086);
- minimum-tiles filter (:1113-1115), ``data_limit`` (:1110-1111),
  ``fixed_tile_num`` (:1160-1162);
- per-patient grouping (TCGA barcode = first 3 dash-fields of the name,
  :1117-1124) with rejection of patients whose slides disagree on the target
  (:1129-1148);
- bag sampling without replacement when possible, with replacement when the
  slide has fewer tiles than the bag (:1489-1494).

``bags()`` yields fixed-size padded arrays and masks for the MIL train
step.
"""

from __future__ import annotations

import os
import pickle
from glob import glob
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def _fix_slide_name(name: str) -> str:
    if name == "10-14248_1_1_a.mrxs":
        return "20-14248_1_1_a.mrxs"
    if name.split(".")[-1] == "ndpi":
        return ".".join(name.split(".")[:-1] + ["tif"])
    return name


def patient_of_slide(slide_name: str, barcode_lookup: Optional[Dict[str, str]] = None) -> str:
    base = slide_name.split(".")[0]
    if base.split("-")[0] == "TCGA":
        return "-".join(base.split("-")[:3])
    if barcode_lookup and slide_name in barcode_lookup:
        return str(barcode_lookup[slide_name])
    return base


def load_inference_file(path: str):
    """Returns (labels, targets, scores, patch_scores, slide_names, features,
    tile_locations) with features (n, 1, max_tiles, D)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    if len(data) == 6:
        labels, targets, scores, patch_scores, slide_names, features = data
        tile_location = np.full(
            (patch_scores.shape[0], patch_scores.shape[1], 2), np.nan
        )
    elif len(data) == 7:
        labels, targets, scores, patch_scores, slide_names, features, _ = data
        tile_location = np.full(
            (patch_scores.shape[0], patch_scores.shape[1], 2), np.nan
        )
    elif len(data) == 8:
        (labels, targets, scores, patch_scores, slide_names, features, _,
         tile_location) = data
    else:
        raise IOError(f"malformed inference file ({len(data)} fields): {path}")
    return labels, targets, scores, patch_scores, slide_names, features, tile_location


def _load_feature_records(
    files: Sequence[str], carmel_only: bool = False,
) -> Dict[str, dict]:
    """Light per-slide record loader for the paired (is_Tumor) feature set:
    {slide_name: {features, tile_locations, num_tiles}} — the secondary set
    carries no targets of its own (datasets.py:1229-1399: only features and
    alignment metadata are consumed).

    NOTE: the name-fixup / carmel filter / NaN-tile-count extraction here
    must stay in lockstep with FeaturesMILDataset.__init__'s main loop — a
    boundary-detection change applied to one side only would silently
    desynchronize the two sets the paired mode aligns by tile location."""
    records: Dict[str, dict] = {}
    for path in files:
        (_labels, _targets, _scores, patch_scores, slide_names, features,
         tile_location) = load_inference_file(path)
        n_slides, max_tiles = features.shape[0], features.shape[2]
        for i in range(n_slides):
            name = _fix_slide_name(slide_names[i])
            if carmel_only and name.split(".")[-1] != "mrxs":
                continue
            feat1 = features[i, :, :, 0]
            nan_idx = np.argwhere(np.isnan(feat1)).tolist()
            tiles_in_slide = nan_idx[0][1] if nan_idx else max_tiles
            records[name] = {
                "features": features[i, 0, :tiles_in_slide, :].astype(np.float32),
                "tile_locations": np.asarray(tile_location[i][:tiles_in_slide]),
                "num_tiles": tiles_in_slide,
            }
    return records


class FeaturesMILDataset:
    def __init__(
        self,
        data_location: str | Sequence[str],
        bag_size: int = 100,
        target: str = "ER",
        is_train: bool = False,
        is_per_patient: bool = False,
        is_all_tiles: bool = False,
        fixed_tile_num: Optional[int] = None,
        minimum_tiles_in_slide: int = 50,
        carmel_only: bool = False,
        data_limit: Optional[int] = None,
        sample_tiles: bool = True,
        barcode_lookup: Optional[Dict[str, str]] = None,
        slide_target_lookup: Optional[Dict[str, int]] = None,
    ):
        self.bag_size = bag_size
        self.is_per_patient = is_per_patient
        self.is_all_tiles = is_all_tiles
        self.sample_tiles = sample_tiles
        self.target = target

        # Paired Receptor+is_Tumor mode (datasets.py:876-882): a TUPLE
        # (receptor_location, is_tumor_location) loads both sets; bags carry
        # 512+512 per-tile concatenated features with enforced tile-location
        # alignment (datasets.py:1229-1399, __organize_dsets__).
        self.paired_is_tumor = (
            isinstance(data_location, tuple) and len(data_location) == 2
        )
        tumor_files: List[str] = []
        if self.paired_is_tumor:
            receptor_loc, tumor_loc = data_location
            data_location = receptor_loc
            if isinstance(tumor_loc, str) and os.path.isdir(tumor_loc):
                tumor_files = sorted(glob(os.path.join(tumor_loc, "*.data")))
            elif isinstance(tumor_loc, str):
                tumor_files = [tumor_loc]
            else:
                tumor_files = list(tumor_loc)
            if not tumor_files:
                raise IOError(f"no is_Tumor .data files at {tumor_loc}")

        if isinstance(data_location, str):
            if os.path.isdir(data_location):
                files = sorted(glob(os.path.join(data_location, "*.data")))
            else:
                files = [data_location]
        else:
            files = list(data_location)
        if not files:
            raise IOError(f"no inference .data files at {data_location}")

        self.slide_names: List[str] = []
        self.labels: List[int] = []
        self.targets: List[int] = []
        self.scores: List[float] = []
        self.tile_scores: List[np.ndarray] = []
        self.features: List[np.ndarray] = []
        self.num_tiles: List[int] = []
        self.tile_locations: List[np.ndarray] = []
        self.patient_data: Dict[str, dict] = {}
        self.bad_patient_list: List[str] = []
        skipped_few_tiles = 0
        bad_num_of_good_tiles = 0

        for path in files:
            (labels, targets, scores, patch_scores, slide_names, features,
             tile_location) = load_inference_file(path)
            n_slides, max_tiles = features.shape[0], features.shape[2]
            for i in range(n_slides):
                name = _fix_slide_name(slide_names[i])
                if carmel_only and name.split(".")[-1] != "mrxs":
                    continue
                feat1 = features[i, :, :, 0]
                nan_idx = np.argwhere(np.isnan(feat1)).tolist()
                tiles_in_slide = nan_idx[0][1] if nan_idx else max_tiles
                if slide_target_lookup is not None and name in slide_target_lookup:
                    if slide_target_lookup[name] != int(targets[i]):
                        raise ValueError(
                            "Found inconsistency between targets in feature "
                            f"files and slide metadata for {name}"
                        )
                if data_limit is not None and is_train and tiles_in_slide > data_limit:
                    tiles_in_slide = data_limit
                if tiles_in_slide < minimum_tiles_in_slide:
                    skipped_few_tiles += 1
                    continue

                feats = features[i, 0, :tiles_in_slide, :].astype(np.float32)
                pscores = np.asarray(patch_scores[i][:tiles_in_slide])
                locs = np.asarray(tile_location[i][:tiles_in_slide])

                if is_per_patient:
                    patient = patient_of_slide(name, barcode_lookup)
                    if patient in self.bad_patient_list:
                        continue
                    if patient in self.patient_data:
                        pdct = self.patient_data[patient]
                        if int(targets[i]) != pdct["target"]:
                            self.patient_data.pop(patient)
                            self.bad_patient_list.append(patient)
                            continue
                        if fixed_tile_num is not None:
                            # truncate scores/locations WITH the features —
                            # concatenating untruncated pscores would shift
                            # every later slide's scores against its features
                            feats = feats[: fixed_tile_num]
                            pscores = pscores[: fixed_tile_num]
                            tiles_in_slide = min(tiles_in_slide, fixed_tile_num)
                        pdct["num tiles"].append(tiles_in_slide)
                        pdct["features"] = np.concatenate(
                            [pdct["features"], feats], axis=0
                        )
                        pdct["tile scores"] = np.concatenate(
                            [pdct["tile scores"], pscores], axis=0
                        )
                        pdct["labels"].append(int(labels[i]))
                        pdct["slides"].append(name)
                        pdct["scores"].append(float(scores[i]))
                        pdct["tile_locations"] = np.concatenate(
                            [pdct["tile_locations"], locs[: feats.shape[0]]],
                            axis=0,
                        )
                    else:
                        if fixed_tile_num is not None:
                            feats = feats[: fixed_tile_num]
                            pscores = pscores[: fixed_tile_num]
                            tiles_in_slide = min(tiles_in_slide, fixed_tile_num)
                        self.patient_data[patient] = {
                            "num tiles": [tiles_in_slide],
                            "features": feats,
                            "tile scores": pscores,
                            "labels": [int(labels[i])],
                            "target": int(targets[i]),
                            "slides": [name],
                            "scores": [float(scores[i])],
                            "tile_locations": locs[: feats.shape[0]],
                        }
                else:
                    if fixed_tile_num is not None:
                        feats = feats[: fixed_tile_num]
                        pscores = pscores[: fixed_tile_num]
                        locs = locs[: fixed_tile_num]
                        tiles_in_slide = min(tiles_in_slide, fixed_tile_num)
                    self.slide_names.append(name)
                    self.labels.append(int(labels[i]))
                    self.targets.append(int(targets[i]))
                    self.scores.append(float(scores[i]))
                    self.tile_scores.append(pscores)
                    self.features.append(feats)
                    self.num_tiles.append(tiles_in_slide)
                    self.tile_locations.append(locs)

        if self.paired_is_tumor:
            tumor = _load_feature_records(tumor_files, carmel_only)
            if is_per_patient:
                for p in sorted(self.patient_data):
                    pdct = self.patient_data[p]
                    parts = []
                    for s, nt in zip(pdct["slides"], pdct["num tiles"]):
                        rec = tumor.get(s)
                        if rec is None:
                            raise KeyError(
                                f"slide {s} missing from the is_Tumor set"
                            )
                        if rec["num_tiles"] < nt:
                            raise ValueError(
                                f"num tiles mismatch for {s}: receptor {nt} "
                                f"vs is_Tumor {rec['num_tiles']}"
                            )
                        parts.append(rec["features"][:nt])
                    tlocs = np.concatenate(
                        [
                            tumor[s]["tile_locations"][:nt]
                            for s, nt in zip(pdct["slides"], pdct["num tiles"])
                        ],
                        axis=0,
                    )
                    if not np.array_equal(
                        pdct["tile_locations"], tlocs, equal_nan=True
                    ):
                        raise ValueError(
                            f"tile locations for patient {p} are not equal "
                            "between the Receptor and is_Tumor sets"
                        )
                    # concatenate ONCE at load (feature dim: [receptor |
                    # is_Tumor]) — doing it per _entry call re-copied the
                    # full (N, 1024) bag on every training access
                    pdct["features"] = np.concatenate(
                        [pdct["features"], np.concatenate(parts, axis=0)],
                        axis=1,
                    )
            else:
                for i, name in enumerate(self.slide_names):
                    rec = tumor.get(name)
                    if rec is None:
                        raise KeyError(
                            f"slide {name} missing from the is_Tumor set"
                        )
                    nt = self.num_tiles[i]
                    if rec["num_tiles"] < nt:
                        raise ValueError(
                            f"num tiles mismatch for {name}: receptor {nt} "
                            f"vs is_Tumor {rec['num_tiles']}"
                        )
                    # Receptor tile_locations are stored UNTRUNCATED (the
                    # reference keeps the full location table even when
                    # fixed_tile_num trims the features) — align both sides
                    # to nt before comparing.
                    if not np.array_equal(
                        np.asarray(self.tile_locations[i])[:nt],
                        rec["tile_locations"][:nt],
                        equal_nan=True,
                    ):
                        raise ValueError(
                            f"tile locations of {name} are not equal between "
                            "the Receptor and is_Tumor sets"
                        )
                    self.features[i] = np.concatenate(
                        [self.features[i], rec["features"][:nt]], axis=1
                    )

        if is_per_patient:
            self._patients = sorted(self.patient_data)
        self.skipped_few_tiles = skipped_few_tiles
        self.bad_num_of_good_tiles = bad_num_of_good_tiles

    def __len__(self):
        return len(self._patients) if self.is_per_patient else len(self.features)

    def _entry(self, idx: int):
        """(features, target, tile_scores, name) — in paired mode the
        features are the per-tile [receptor(512) | is_Tumor(512)] concat
        (utils_MIL.py:1603-1630 downstream contract; score readout slices
        back out with models.mil.tile_scores_from_head(receptor_slice=512))."""
        if self.is_per_patient:
            p = self.patient_data[self._patients[idx]]
            # paired mode pre-concatenates [receptor | is_Tumor] at load
            return (
                p["features"], p["target"], p["tile scores"],
                self._patients[idx],
            )
        feats = self.features[idx]
        return (
            feats,
            self.targets[idx],
            self.tile_scores[idx],
            self.slide_names[idx],
        )

    def sample_bag(self, idx: int, rng: np.random.Generator):
        """One bag: without replacement when enough tiles, with replacement
        otherwise (datasets.py:1489-1494)."""
        feats, target, tile_scores, name = self._entry(idx)
        n = feats.shape[0]
        if self.is_all_tiles:
            return feats, target, tile_scores, name
        if not self.sample_tiles:
            take = feats[: self.bag_size]
            return take, target, tile_scores[: self.bag_size], name
        if n >= self.bag_size:
            pick = rng.choice(n, size=self.bag_size, replace=False)
        else:
            pick = rng.choice(n, size=self.bag_size, replace=True)
        return feats[pick], target, np.asarray(tile_scores)[pick], name

    def bags(
        self,
        rng: np.random.Generator,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Fixed-shape padded bag batches for the MIL step."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        dim = self._entry(0)[0].shape[1]
        for start in range(0, len(order), batch_size):
            chunk = order[start : start + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            feats = np.zeros((len(chunk), self.bag_size, dim), np.float32)
            mask = np.zeros((len(chunk), self.bag_size), bool)
            targets = np.zeros((len(chunk),), np.int64)
            for j, i in enumerate(chunk):
                f, t, _, _ = self.sample_bag(int(i), rng)
                k = min(f.shape[0], self.bag_size)
                feats[j, :k] = f[:k]
                mask[j, :k] = True
                targets[j] = t
            yield {"features": feats, "mask": mask, "labels": targets}
