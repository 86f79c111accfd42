"""Tile extraction from slides (``tpuwsi/io/tiles.py``).

Parity: utils.py:64-108 ``_choose_data`` and :111-210 ``_get_tiles`` —
sampling grid locations without replacement, the random ±half-tile shift with
the reference's exact border-clamping rules (utils.py:152-170), blank-patch
fallback on read failure (:175-181 — reproduced but *counted*, the reference
fails silently), the 2× ``oversized_HC_tiles`` mode (:139-142), and resize to
the output tile size (:198-199) with PIL's default bicubic filter.

Python makes every random draw, in the JAX package's order (``plan_tiles``);
the crops and resizes of a whole batch then run as one C call on threads
outside the interpreter lock (``read_tiles`` → ``io/image.crop_resize``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tpuwsi_torch.io.image import crop_resize
from tpuwsi_torch.io.levels import get_optimal_slide_level
from tpuwsi_torch.io.slide_readers import SlideReader

Location = Tuple[int, int]


@dataclasses.dataclass
class TileStats:
    """Observability the reference lacks: blank-fallback count (SURVEY §5.3)."""

    read_failures: int = 0
    tiles_read: int = 0


@dataclasses.dataclass
class TileRequest:
    """Tiles of one slide to cut: (top, left) level-0 origins, each a
    ``region``² square at ``level``."""

    reader: SlideReader
    level: int
    origins: List[Location]
    region: int


def choose_locations(
    rng: np.random.Generator, grid: Sequence[Location], how_many: int
) -> List[Location]:
    """Sample without replacement (utils.py:93 ``random.sample`` parity)."""
    if how_many > len(grid):
        raise ValueError("Requested more tiles than available by the grid list")
    idxs = rng.choice(len(grid), size=how_many, replace=False)
    return [grid[i] for i in idxs]


def shifted_origin(
    rng: Optional[np.random.Generator],
    loc: Location,
    tile_size_level_0: int,
    slide_dimensions: Tuple[int, int],
    random_shift: bool,
    oversized: bool = False,
) -> Tuple[int, int]:
    """(top, left) after the reference's random shift + border clamping
    (utils.py:152-170). slide_dimensions is (width, height)."""
    if random_shift:
        half = tile_size_level_0 // 2
        shift = rng.choice(np.arange(-half, half), size=2, replace=False)
        shift = (int(shift[0]), int(shift[1]))
    elif oversized:
        shift = (tile_size_level_0 // 2, tile_size_level_0 // 2)
    else:
        return loc[0], loc[1]

    top = loc[0] - shift[0]
    left = loc[1] - shift[1]
    bottom = top + tile_size_level_0
    right = left + tile_size_level_0
    if top < 0:
        top = 0
    if left < 0:
        left = 0
    if bottom > slide_dimensions[1]:
        top -= bottom - slide_dimensions[1]
    if right > slide_dimensions[0]:
        left -= right - slide_dimensions[0]
    return top, left


def plan_tiles(
    reader: SlideReader,
    locations: Sequence[Location],
    tile_size_level_0: int,
    adjusted_tile_size: int,
    best_slide_level: int,
    rng: Optional[np.random.Generator] = None,
    random_shift: bool = False,
    oversized_hc_tiles: bool = False,
    loan=None,  # Optional[tpuwsi_torch.io.loan.LoanAnnotation]
) -> Tuple[TileRequest, Optional[np.ndarray]]:
    """The draws of ``get_tiles``, in its order: each location's shifted
    origin and, with ``loan``, its label. → (the request, the labels or
    None)."""
    if oversized_hc_tiles:
        adjusted_tile_size *= 2
    origins, labels = [], np.zeros(len(locations), dtype=np.int64) - 1
    for i, loc in enumerate(locations):
        top, left = shifted_origin(rng, loc, tile_size_level_0, reader.dimensions,
                                   random_shift, oversized_hc_tiles)
        if loan is not None:
            labels[i] = loan.label(top, left, adjusted_tile_size)
        origins.append((top, left))
    request = TileRequest(reader, best_slide_level, origins, adjusted_tile_size)
    return request, (labels if loan is not None else None)


def _spans(starts: np.ndarray, length: np.ndarray, size: np.ndarray):
    """numpy's ``a[max(s, 0):s + length]`` on an axis of ``size``, for each
    start → (first, count, ok): ``ok`` is false where the slice is longer
    than ``length`` (the read then fails, as the reference's assignment into
    its tile does)."""
    lo = np.minimum(np.maximum(starts, 0), size)
    hi = starts + length
    hi = np.clip(np.where(hi < 0, hi + size, hi), 0, size)
    count = np.maximum(hi - lo, 0)
    return lo, count, count <= length


def read_tiles(
    requests: Sequence[TileRequest],
    output_tile_size: int,
    stats: Optional[TileStats] = None,
    threads: int = 1,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Every request's tiles → uint8 (N, output, output, 3), in order, from one
    ``crop_resize`` call on ``threads`` threads. A reader that holds its level
    in memory gives its tiles as boxes of that array (``read_region``'s
    bounds, worked out for all such tiles at once); the regions of pyramidal
    slides (``io/ingest.CTileReader``) are read before, all in one C call on
    ``threads`` threads; any other reader's regions are read one by one. A
    failed read is a blank tile, logged and counted in ``stats``."""
    from tpuwsi_torch.io.ingest import CTileReader, read_regions

    blank = np.zeros((1, 1, 3), np.uint8)
    sources, boxes, failed, held, where, owners = [], [], [], [], [], []
    pyramid, pyramid_at = [], []
    for req in requests:
        level = req.reader.level_array(req.level)
        for top, left in req.origins:
            if level is not None:
                where.append(len(sources))
                held.append((top, left, req.region, *level.shape[:2]))
                owners.append(req.reader)
                sources.append(level)
                boxes.append((0, 0, 0, 0, req.region))
                continue
            if isinstance(req.reader, CTileReader):
                pyramid_at.append(len(sources))
                pyramid.append((req.reader, left, top, req.level, req.region, req.region))
                sources.append(blank)
                boxes.append((0, 0, 0, 0, req.region))
                continue
            try:
                tile = np.ascontiguousarray(req.reader.read_region(
                    (left, top), req.level, (req.region, req.region)), dtype=np.uint8)
                sources.append(tile)
                boxes.append((0, 0, tile.shape[0], tile.shape[1], req.region))
            except Exception:
                sources.append(blank)
                boxes.append((0, 0, 0, 0, req.region))
                failed.append((top, left, req.reader))
    if pyramid:
        tiles, lost = read_regions(pyramid, threads)
        for i, tile in zip(pyramid_at, tiles):
            sources[i] = tile
            boxes[i] = (0, 0, tile.shape[0], tile.shape[1], boxes[i][4])
        for j, _ in lost:
            reader, left, top = pyramid[j][:3]
            sources[pyramid_at[j]] = blank
            boxes[pyramid_at[j]] = (0, 0, 0, 0, boxes[pyramid_at[j]][4])
            failed.append((top, left, reader))
    boxes = np.asarray(boxes, np.int64).reshape(-1, 5)
    if held:
        where = np.asarray(where)
        top, left, region, h, w = np.asarray(held, np.int64).T
        r0, rows, rows_ok = _spans(top, region, h)
        c0, cols, cols_ok = _spans(left, region, w)
        ok = rows_ok & cols_ok
        boxes[where, :4] = np.stack([r0, c0, rows, cols], 1) * ok[:, None]
        for j in np.flatnonzero(~ok):
            sources[where[j]] = blank
            failed.append((int(top[j]), int(left[j]), owners[j]))
    for t, lf, reader in failed:
        logging.info("failed to read slide %s at (%d, %d); taking blank patch",
                     getattr(reader, "path", "?"), lf, t)
    if stats is not None:
        stats.tiles_read += len(sources) - len(failed)
        stats.read_failures += len(failed)
    return crop_resize(sources, boxes.astype(np.int32), output_tile_size, threads=threads,
                       out=out)


def get_tiles(
    reader: SlideReader,
    locations: Sequence[Location],
    tile_size_level_0: int,
    adjusted_tile_size: int,
    output_tile_size: int,
    best_slide_level: int,
    rng: Optional[np.random.Generator] = None,
    random_shift: bool = False,
    oversized_hc_tiles: bool = False,
    stats: Optional[TileStats] = None,
    loan=None,
    threads: int = 1,
    out: Optional[np.ndarray] = None,
):
    """Extract len(locations) tiles → uint8 (N, output, output, 3).

    With ``loan`` set, returns (tiles, labels) where labels are the per-tile
    localized-annotation labels computed from each tile's post-shift origin
    (utils.py:183-196 parity: red-zone fraction of the QuPath mask over the
    adjusted tile extent).
    """
    request, labels = plan_tiles(reader, locations, tile_size_level_0, adjusted_tile_size,
                                 best_slide_level, rng, random_shift, oversized_hc_tiles,
                                 loan)
    if oversized_hc_tiles:
        output_tile_size *= 2
    tiles = read_tiles([request], output_tile_size, stats, threads, out)
    return (tiles, labels) if loan is not None else tiles


def choose_data(
    reader: SlideReader,
    grid: Sequence[Location],
    how_many: int,
    magnification: float,
    tile_size: int = 256,
    desired_mag: float = 20,
    rng: Optional[np.random.Generator] = None,
    random_shift: bool = True,
    stats: Optional[TileStats] = None,
) -> Tuple[np.ndarray, List[Location]]:
    """utils.py:64-108 parity: sample + extract. Returns (tiles, locations)."""
    rng = rng or np.random.default_rng()
    best_level, adjusted, level0 = get_optimal_slide_level(
        reader.level_downsamples, magnification, desired_mag, tile_size
    )
    locs = choose_locations(rng, grid, how_many)
    tiles = get_tiles(reader, locs, level0, adjusted, tile_size, best_level, rng=rng,
                      random_shift=random_shift, stats=stats)
    return tiles, locs
