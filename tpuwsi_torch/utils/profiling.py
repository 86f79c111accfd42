"""Input-pipeline stage timing (``tpuwsi/utils/profiling.py:29 StageTimer``).

The reference's opt-in hand timers (``-time``: per-``__getitem__`` extraction
times, datasets.py:449-526) under its 'Time dict' keys. The rest of the JAX
module (trace capture, ``ThroughputMeter``) is not carried.
"""

from __future__ import annotations

import threading
from typing import Dict


class StageTimer:
    """Host-side stage timing with reference-compatible keys; safe to call
    from several threads."""

    KEYS = ("Average time to extract a tile", "Augmentation time", "Total time")

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = {k: 0.0 for k in self.KEYS}
        self.counts: Dict[str, int] = {k: 0 for k in self.KEYS}
        self._lock = threading.Lock()

    def add(self, key: str, seconds: float, count: int = 1) -> None:
        """Record ``count`` events that took ``seconds`` together."""
        if not self.enabled:
            return
        with self._lock:
            self.totals[key] = self.totals.get(key, 0.0) + seconds
            self.counts[key] = self.counts.get(key, 0) + count

    def time_dict(self) -> Dict[str, float]:
        """'Time dict' parity (datasets.py:517-526)."""
        return {
            k: (self.totals.get(k, 0.0) / max(self.counts.get(k, 0), 1))
            for k in self.KEYS
        }
