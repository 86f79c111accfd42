"""Best-K checkpointing on ``torch.save`` (``tpuwsi/train/checkpoint.py``).

One directory per step under the manager's directory, laid out as Orbax
lays them out: ``<step>/default/state.pt`` holds the state and
``<step>/metrics/metrics`` the metrics as JSON. A step is written into a
temporary directory and renamed into place. Which steps survive is Orbax's
choice for the same sequence of ``(step, metrics)``: with
``rank_by_metric`` the ``max_history`` best by ``metrics[metric_name]``
(0.0 where it is missing; ties go to the later step), else the
``max_history`` latest; a save at a step not after the latest is skipped.
The newest save can itself be collected when it ranks outside the best.

Saves are synchronous: ``wait`` and ``close`` are there for the reference's
call sites. A state is an object with ``state_dict()`` and
``load_state_dict()`` (``ssl_dino.dino.DINOState``, an ``nn.Module``) or a
dict that ``torch.save`` takes; restores load with ``weights_only=True``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional

import torch

_STATE_FILE = os.path.join("default", "state.pt")
_METRICS_FILE = os.path.join("metrics", "metrics")


class CheckpointManager:
    """Best-K checkpoint manager over a training state."""

    def __init__(self, directory: str, max_history: int = 10, metric_name: str = "auc",
                 mode: str = "max", rank_by_metric: bool = True):
        """``rank_by_metric=False`` keeps the most recent ``max_history``
        saves, for recovery checkpoints that carry no eval metric."""
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_history = max_history
        self.metric_name = metric_name
        self.mode = mode
        self.rank_by_metric = rank_by_metric
        self._steps: List[int] = sorted(
            int(d) for d in os.listdir(self.directory)
            if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, _STATE_FILE)))
        self._metrics = {s: self._read_metrics(s) for s in self._steps}
        self._open = True

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _read_metrics(self, step: int) -> dict:
        path = os.path.join(self._step_dir(step), _METRICS_FILE)
        if not os.path.isfile(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def _score(self, step: int) -> float:
        return self._metrics[step].get(self.metric_name, 0.0)

    def _ranked(self) -> List[int]:
        """Steps from worst to best: Orbax's stable sort, reversed for 'min'."""
        return sorted(self._steps, key=self._score, reverse=self.mode == "min")

    def _collect(self):
        if self.max_history is None or len(self._steps) <= self.max_history:
            return
        if self.max_history == 0:
            keep = set()
        elif self.rank_by_metric:
            keep = set(self._ranked()[-self.max_history:])
        else:
            keep = set(self._steps[-self.max_history:])
        for step in [s for s in self._steps if s not in keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            self._steps.remove(step)
            del self._metrics[step]

    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> bool:
        """Write ``state`` at ``step`` with ``metrics`` (floats); False when
        the step is not after the latest and nothing was written."""
        if not self._open:
            raise RuntimeError("the checkpoint manager is closed")
        step = int(step)
        if self._steps and self._steps[-1] >= step:
            return False
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        payload = state.state_dict() if hasattr(state, "state_dict") else state
        final = self._step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(os.path.join(tmp, "default"))
        os.makedirs(os.path.join(tmp, "metrics"))
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
        with open(os.path.join(tmp, _METRICS_FILE), "w") as f:
            json.dump(metrics, f)
        os.replace(tmp, final)
        self._steps.append(step)
        self._metrics[step] = metrics
        self._collect()
        return True

    def restore(self, step: Optional[int] = None, target: Any = None):
        """The state saved at ``step`` (default: the latest), loaded into
        ``target`` with ``load_state_dict`` and returned when ``target`` is
        given, else the saved dict (tensors on the CPU); None when there is
        no checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        payload = torch.load(os.path.join(self._step_dir(step), _STATE_FILE),
                             map_location="cpu", weights_only=True)
        if target is None:
            return payload
        target.load_state_dict(payload)
        return target

    def all_steps(self) -> List[int]:
        return list(self._steps)

    def best_step(self) -> Optional[int]:
        if not self._steps:
            return None
        if not self.rank_by_metric:
            return self.latest_step()
        return self._ranked()[-1]

    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    def wait(self):
        """Saves are synchronous: nothing is in flight."""

    def close(self):
        """Idempotent; a closed manager refuses saves."""
        self._open = False


def load_checkpoint(directory: str, target: Any = None, step: Optional[int] = None):
    """One-shot restore: open a manager, restore, close it."""
    mgr = CheckpointManager(directory)
    try:
        return mgr.restore(step=step, target=target)
    finally:
        mgr.close()


def save_args_snapshot(directory: str, args: dict):
    """args.json snapshot of the run configuration."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "args.json"), "w") as f:
        json.dump(args, f, indent=2, default=str)
