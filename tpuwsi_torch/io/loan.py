"""Localized annotation (LOAN) per-tile labels (``tpuwsi/io/loan.py``).

Parity: utils.py:144-149, 183-196 — with ``--loan`` each tile gets a label
from a QuPath-exported PNG mask stored next to the slide at
``local_labels/<slide-stem>-labels.png`` (downsample 8, set by the QuPath
groovy script). A tile is positive when more than 10% of its mask pixels
have red == 250; slides scanned with a bounds offset (mrxs) subtract the
level-0 bounds origin before indexing the mask. Strongly supervised
training then uses these tile labels instead of the slide target
(train.py:380 '--loan', datasets.py:487-489). The mask PNG is read by the
port's own decoder (``io/image.decode_png``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np

Location = Tuple[int, int]


def annotation_path(slide_path: str) -> str:
    stem = os.path.splitext(os.path.basename(slide_path))[0]
    return os.path.join(
        os.path.dirname(slide_path), "local_labels", stem + "-labels.png"
    )


@dataclasses.dataclass
class LoanAnnotation:
    """Loaded mask + the geometry needed to label level-0 tile origins."""

    image: np.ndarray  # (H, W, 3+) uint8 at level-0/ds resolution
    bounds: Tuple[int, int] = (0, 0)  # level-0 scan-bounds origin (x0, y0)
    ds: int = 8  # mask downsample (QuPath script constant, utils.py:150)
    red_value: int = 250
    threshold: float = 0.1

    def label(self, top: int, left: int, tile_size_level_0: int) -> int:
        # NOTE (reference parity, utils.py:186-189): the reference computes
        # the window extent from the ADJUSTED tile size while indexing with
        # level-0 coordinates — when best_slide_level != 0 the window covers
        # only the top-left (1/ds_level²) of the tile area. get_tiles passes
        # the adjusted size to reproduce that behavior exactly; pass the
        # true level-0 extent here to get the geometrically correct label.
        d = max(tile_size_level_0 // self.ds, 1)
        x = left // self.ds - self.bounds[0] // self.ds
        y = top // self.ds - self.bounds[1] // self.ds
        tile = self.image[max(y, 0) : max(y, 0) + d, max(x, 0) : max(x, 0) + d]
        if tile.size == 0:
            return 0
        red_zone = float(np.mean(tile[..., 0] == self.red_value))
        return 1 if red_zone > self.threshold else 0

    def labels(
        self, origins: Sequence[Location], tile_size_level_0: int
    ) -> np.ndarray:
        return np.asarray(
            [self.label(t, l, tile_size_level_0) for t, l in origins],
            dtype=np.int64,
        )


def load_loan_annotation(
    slide_path: str, bounds: Tuple[int, int] = (0, 0), ds: int = 8
) -> Optional[LoanAnnotation]:
    """Read the slide's local-labels PNG; None when the slide has none."""
    path = annotation_path(slide_path)
    if not os.path.isfile(path):
        return None
    from tpuwsi_torch.io.image import decode_png

    return LoanAnnotation(image=decode_png(path), bounds=bounds, ds=ds)
