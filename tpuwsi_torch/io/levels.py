"""Pyramid-level selection math (``tpuwsi/io/levels.py``).

Parity: utils.py:37-61 ``get_optimal_slide_level`` — pick the slide pyramid
level and adjusted tile size for a desired magnification, including the exact
corner cases: relative-tolerance level match (isclose rel_tol=1e-3), the
next-best-lower level with residual downsample, and the upsample branch
(desired_downsample < 1).
"""

from __future__ import annotations

from math import isclose
from typing import Sequence, Tuple


def get_optimal_slide_level(
    level_downsamples: Sequence[float],
    magnification: float,
    desired_mag: float,
    tile_size: int,
) -> Tuple[int, int, int]:
    """Returns (best_slide_level, adjusted_tile_size, level_0_tile_size)."""
    desired_downsample = magnification / desired_mag

    if desired_downsample < 1:  # upsample branch (utils.py:41-44)
        level_0_tile_size = int(desired_downsample * tile_size)
        return 0, level_0_tile_size, level_0_tile_size

    level, best_next_level = -1, -1
    level_downsample = 1.0
    for index, downsample in enumerate(level_downsamples):
        if isclose(desired_downsample, downsample, rel_tol=1e-3):
            level = index
            level_downsample = 1.0
            break
        if downsample < desired_downsample:
            best_next_level = index
            level_downsample = desired_downsample / level_downsamples[index]

    adjusted_tile_size = int(tile_size * level_downsample)
    best_slide_level = level if level > best_next_level else best_next_level
    level_0_tile_size = int(desired_downsample * tile_size)
    return best_slide_level, adjusted_tile_size, level_0_tile_size
