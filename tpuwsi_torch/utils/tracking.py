"""Experiment metric tracking, offline (``tpuwsi/utils/tracking.py``).

``Tracker`` appends one JSON line per ``log`` call to
``<output_dir>/metrics.jsonl``, and ``log_roc_pr`` logs the points of the
ROC and PR curves as data. The wandb back end (--log-wandb) is not ported
(ROADMAP.md, Queue 1, M3b).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np


def roc_curve_points(scores: Sequence[float], labels: Sequence[int], n: int = 50):
    """(fpr, tpr) at n score thresholds (quantiles of the scores)."""
    scores = np.asarray(scores, float)
    labels = np.asarray(labels)
    thresholds = np.quantile(scores, np.linspace(0, 1, n)) if len(scores) else []
    pos = max((labels == 1).sum(), 1)
    neg = max((labels == 0).sum(), 1)
    pts = []
    for t in thresholds:
        pred = scores >= t
        pts.append((float(((labels == 0) & pred).sum() / neg),
                    float(((labels == 1) & pred).sum() / pos)))
    return pts


def pr_curve_points(scores, labels, n: int = 50):
    """(recall, precision) at n score thresholds."""
    scores = np.asarray(scores, float)
    labels = np.asarray(labels)
    thresholds = np.quantile(scores, np.linspace(0, 1, n)) if len(scores) else []
    pts = []
    for t in thresholds:
        pred = scores >= t
        tp = ((labels == 1) & pred).sum()
        pts.append((float(tp / max((labels == 1).sum(), 1)), float(tp / max(pred.sum(), 1))))
    return pts


def _to_jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if hasattr(v, "item") and getattr(v, "size", 2) == 1:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


class Tracker:
    def __init__(self, output_dir: str, use_wandb: bool = False):
        if use_wandb:
            raise NotImplementedError(
                "--log-wandb is not ported yet (ROADMAP.md, Queue 1, M3b); metrics.jsonl "
                "holds what it would log")
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")

    def log(self, metrics: Dict, step: Optional[int] = None):
        rec = {"_time": time.time()}
        if step is not None:
            rec["_step"] = int(step)
        rec.update({k: _to_jsonable(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_roc_pr(self, scores, labels, prefix: str = "", step=None):
        self.log({f"{prefix}roc_points": roc_curve_points(scores, labels),
                  f"{prefix}pr_points": pr_curve_points(scores, labels)}, step=step)

    def finish(self):
        """Nothing is held open."""
