"""Presaved-tile cohorts, ABCTB_TILES (``tpuwsi/io/presaved.py``).

Parity: datasets.py:452-467 — cohorts whose tiles are pre-extracted into
per-slide directories of ``tile_<i>.data`` files with an ASCII header
``"<dtype> <d0> <d1> <c>\\n"`` followed by raw bytes, where the FIRST size
field is the leading (row) axis: the reference names the fields ``w h`` but
reshapes ``(int(w), int(h), c)`` (datasets.py:463-464), so 'w' is actually
rows. Reader and writer here follow that byte layout exactly — files
round-trip against the reference in both directions.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def read_presaved_tile(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline()
        raw = f.read()
    dtype, w, h, c = header.decode("ascii").strip().split()
    return np.frombuffer(raw, dtype=dtype).reshape(int(w), int(h), int(c))


def write_presaved_tile(path: str, tile: np.ndarray):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        h, w, c = tile.shape
        f.write(f"{tile.dtype.name} {h} {w} {c}\n".encode("ascii"))
        f.write(np.ascontiguousarray(tile).tobytes())


def tiles_dir_for_slide(cohort_dir: str, file_name: str) -> str:
    """datasets.py:391-393: <cohort>/tiles/<basename-without-ext>/"""
    base = ".".join(os.path.basename(file_name).split(".")[:-1])
    return os.path.join(cohort_dir, "tiles", base)


def sample_presaved_tiles(
    tiles_dir: str,
    n_available: int,
    how_many: int,
    tile_size: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random tiles + random crop to tile_size (datasets.py:454-465)."""
    rng = rng or np.random.default_rng()
    idxs = rng.choice(n_available, size=how_many, replace=False)
    out = np.zeros((how_many, tile_size, tile_size, 3), dtype=np.uint8)
    for i, tile_ind in enumerate(idxs):
        tile = read_presaved_tile(
            os.path.join(tiles_dir, f"tile_{int(tile_ind)}.data")
        )
        h, w = tile.shape[:2]
        top = int(rng.integers(0, max(h - tile_size, 0) + 1))
        left = int(rng.integers(0, max(w - tile_size, 0) + 1))
        crop = tile[top : top + tile_size, left : left + tile_size]
        out[i, : crop.shape[0], : crop.shape[1]] = crop[..., :3]
    return out
