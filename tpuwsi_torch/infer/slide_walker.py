"""The unit of slide inference (``tpuwsi/infer/slide_walker.py:33``).

Chunks are padded to a fixed ``tiles_per_iter`` with a validity mask. The
walker that cuts slides into chunks is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class InferChunk:
    images: np.ndarray  # (tiles_per_iter, ts, ts, 3) uint8, padded
    mask: np.ndarray  # (tiles_per_iter,) bool
    label: np.ndarray  # int label(s)
    slide_index: int
    slide_name: str
    patient_barcode: str
    slide_dataset: str
    initial_num_tiles: int
    is_last_batch: bool
    locations: List[Tuple[int, int]]  # valid tile locations (level-0)
    # Raw per-slide target (can be -1 for unknown), kept distinct from
    # `label` in the MIL feature pickles. Defaults to the label.
    target: Optional[int] = None
    # Survival walker extras
    binary_target: Optional[int] = None
    time_target: Optional[float] = None
    censored: Optional[bool] = None
