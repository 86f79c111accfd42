"""Tile-grid store (``tpuwsi/io/grids.py``).

Parity: the reference's per-slide pickled grid files
``Grids_<mag>/<name>--tlsz<size>.data`` holding a list of (top, left) level-0
tile locations (datasets.py:406-413), and ``Grid_data.xlsx`` per-cohort totals
(datasets.py:99-103, columns 'Total/Legitimate tiles - <sz> compatible @ X<mag>').

Adds a packed little-endian int32 binary format (``.grid``) consumed directly
by the native C++ tile-ingest (zero-copy mmap-able), plus a tissue-grid
builder for raw slides (the working ``patch_cutter`` the reference never had —
its in-repo tiler is a broken scratch script, SURVEY §0).
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import List, Sequence, Tuple

import numpy as np

from tpuwsi_torch.io.slide_readers import SlideReader

Location = Tuple[int, int]  # (top, left) level-0 coordinates


def grid_file_path(cohort_dir: str, file_name: str, magnification: int,
                   tile_size: int) -> str:
    basic = ".".join(file_name.split(".")[:-1])
    return os.path.join(
        cohort_dir, f"Grids_{magnification}", f"{basic}--tlsz{tile_size}.data"
    )


def load_grid_pickle(path: str) -> List[Location]:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_grid_pickle(path: str, grid: Sequence[Location]):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(list(grid), f)


_GRID_MAGIC = b"TWGRID01"


def save_grid_packed(path: str, grid: Sequence[Location]):
    """Packed format: magic, int32 count, then count×(int32 top, int32 left)."""
    arr = np.asarray(grid, dtype="<i4").reshape(-1, 2)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_GRID_MAGIC)
        f.write(struct.pack("<i", arr.shape[0]))
        f.write(arr.tobytes())


def load_grid_packed(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _GRID_MAGIC:
            raise IOError(f"bad grid magic in {path}")
        (n,) = struct.unpack("<i", f.read(4))
        arr = np.frombuffer(f.read(n * 8), dtype="<i4").reshape(n, 2)
    return arr


def build_tissue_grid(
    reader: SlideReader,
    tile_size_level_0: int,
    tissue_threshold: float = 0.5,
    white_threshold: int = 230,
    preview_downsample: int | None = None,
) -> List[Location]:
    """Build the legitimate-tile grid for a slide: regular tiling of level 0,
    keeping tiles whose tissue fraction (non-white pixels in a low-res
    preview) exceeds the threshold.

    This is the working equivalent of the reference's intended WSI→grid
    mechanism (the broken ``patch_cutter`` sketch + the precomputed
    Grids_<mag> directories its datasets consume).
    """
    w, h = reader.dimensions
    if preview_downsample is None:
        preview_downsample = max(int(max(reader.level_downsamples)), 1)
    # Read the COARSEST pyramid level whose downsample still satisfies the
    # requested preview resolution, then box-downsample the rest on the
    # host. (Always taking the coarsest level silently ignored a finer
    # preview_downsample request and could drop small tissue regions.)
    level = max(
        (
            i for i, d in enumerate(reader.level_downsamples)
            if int(d) <= preview_downsample
        ),
        key=lambda i: reader.level_downsamples[i],
    )
    level_ds = int(reader.level_downsamples[level])
    full = reader.read_region((0, 0), level, (w // level_ds, h // level_ds))
    rest = max(preview_downsample // level_ds, 1)
    ph, pw = full.shape[0] // rest, full.shape[1] // rest
    preview = (
        full[: ph * rest, : pw * rest]
        .reshape(ph, rest, pw, rest, 3)
        .mean(axis=(1, 3))
    )
    preview_downsample = level_ds * rest
    gray = preview.mean(axis=-1)
    tissue = gray < white_threshold  # histology: background is near-white

    grid: List[Location] = []
    pt = max(tile_size_level_0 // preview_downsample, 1)
    for top in range(0, h - tile_size_level_0 + 1, tile_size_level_0):
        for left in range(0, w - tile_size_level_0 + 1, tile_size_level_0):
            py, px = top // preview_downsample, left // preview_downsample
            frac = tissue[py : py + pt, px : px + pt].mean()
            if frac >= tissue_threshold:
                grid.append((top, left))
    return grid


def grid_data_columns(tile_size: int, magnification: int) -> Tuple[str, str]:
    """The load-bearing Grid_data.xlsx column names (datasets.py:221-225)."""
    total = f"Total tiles - {tile_size} compatible @ X{magnification}"
    legit = f"Legitimate tiles - {tile_size} compatible @ X{magnification}"
    return total, legit
