"""Slide-walking survival evaluation (``tpuwsi/infer/survival_walker.py``).

Parity: ``Infer_Dataset_Survival`` (datasets.py:3243-3461) walks every slide
of the selected folds in fixed chunks and emits, per chunk, the survival
targets beside the tiles ('Binary Target', 'Time Target', 'Censored',
:3449-3461). The chunks are the plain ``SlideWalker``'s, padded and masked;
the risk of a slide is the mean of its tiles' risks, and the slide-level
C-index and binary AUC are reckoned on the host once every slide is in.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from tpuwsi_torch.infer.aggregate import roc_auc
from tpuwsi_torch.infer.pipeline import eval_stream
from tpuwsi_torch.infer.slide_walker import SlideWalker
from tpuwsi_torch.utils.labels import get_label


class SurvivalSlideWalker(SlideWalker):
    """``SlideWalker`` over a survival ``SlideTable``: each chunk carries its
    slide's Binary Target, Time Target and Censored flag."""

    def walk(self):
        t = self.table
        if t.target_binary is None or t.target_cont is None:
            raise ValueError("SurvivalSlideWalker needs a survival SlideTable")
        binary = [get_label(b)[0] for b in t.target_binary]
        for chunk in super().walk():
            i = chunk.slide_index
            chunk.binary_target = binary[i]
            chunk.time_target = float(t.target_cont[i])
            chunk.censored = bool(t.censored[i])
            yield chunk


@dataclasses.dataclass
class SurvivalSlideResult:
    slide_name: str
    patient_barcode: str
    binary_target: int
    time_target: float
    censored: bool
    tile_risks: np.ndarray  # (n_tiles,)
    tile_locations: List

    @property
    def slide_risk(self) -> float:
        return float(self.tile_risks.mean()) if len(self.tile_risks) else 0.0


class SurvivalAggregator:
    """Collects the masked tile risks chunk by chunk; the slide-level
    metrics. Higher risk means shorter expected survival, the direction of
    ``cox_partial_likelihood``."""

    def __init__(self):
        self._risks: List[np.ndarray] = []
        self._locs: List = []
        self.results: List[SurvivalSlideResult] = []

    def add_chunk(self, chunk, risks: np.ndarray):
        """``risks``: (tiles_per_iter,) risk scores of the padded chunk."""
        m = chunk.mask
        self._risks.append(np.asarray(risks).reshape(-1)[: len(m)][m])
        self._locs.extend(chunk.locations)
        if chunk.is_last_batch:
            self.results.append(SurvivalSlideResult(
                slide_name=chunk.slide_name,
                patient_barcode=chunk.patient_barcode,
                binary_target=int(chunk.binary_target),
                time_target=float(chunk.time_target),
                censored=bool(chunk.censored),
                tile_risks=np.concatenate(self._risks),
                tile_locations=list(self._locs),
            ))
            self._risks, self._locs = [], []

    def slide_c_index(self) -> float:
        """Concordance over slides: P(risk_i > risk_j | t_i < t_j, i an
        event), ties in risk counting a half; 0.5 with no comparable pair."""
        risks = np.asarray([r.slide_risk for r in self.results])
        times = np.asarray([r.time_target for r in self.results])
        events = np.asarray([not r.censored for r in self.results], dtype=bool)
        num = den = 0.0
        for i in np.flatnonzero(events):
            for j in range(len(risks)):
                if times[i] < times[j]:
                    den += 1.0
                    if risks[i] > risks[j]:
                        num += 1.0
                    elif risks[i] == risks[j]:
                        num += 0.5
        return float(num / den) if den else 0.5

    def slide_binary_auc(self) -> float:
        """AUC of the slide risk against the 5-year status, unknown (-1)
        targets left out. A positive status (survived 5 years) is the low-risk
        class, so the risk scores the negative one."""
        scores, labels = [], []
        for r in self.results:
            if r.binary_target in (0, 1):
                scores.append(r.slide_risk)
                labels.append(1 - r.binary_target)
        return roc_auc(scores, labels)


def infer_survival_slides(walker: SurvivalSlideWalker, risk_fn,
                          aggregator: Optional[SurvivalAggregator] = None,
                          dispatch_ahead: int = 2) -> SurvivalAggregator:
    """A whole survival evaluation: ``risk_fn(images) -> (N,)`` risks (the
    Cox head's output or the binary logits' margin) for each chunk's uint8
    tiles, fetched ``dispatch_ahead`` chunks behind."""
    agg = aggregator or SurvivalAggregator()
    for chunk, risks in eval_stream(walker.walk(), lambda c: c.images, risk_fn,
                                    depth=dispatch_ahead):
        agg.add_chunk(chunk, np.asarray(risks))
    return agg
