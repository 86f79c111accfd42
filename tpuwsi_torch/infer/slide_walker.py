"""Slide-level inference walker (``tpuwsi/infer/slide_walker.py``).

Parity: ``Infer_Dataset`` (datasets.py:634-817) — per-slide tile budget
``min(num_tiles, legitimate)`` (:684-688), random patch subset or
patch-dir-resumed exact locations (:693-696, :766-773), ``tiles_per_iter``
chunking (:698), stateful slide walking with 'Is Last Batch' (:783-803),
``resume_slide`` (:674-680), and ``reset_counter`` (:816).

Chunks are padded to a fixed ``tiles_per_iter`` with a validity mask, as in
the JAX package. The resume CSVs are the bytes ``DataFrame.to_csv`` writes
there, so either package resumes from the other's files. Each chunk's tiles
are cut in one C call (``io/tiles.read_tiles``) on ``threads`` threads, and
the next ``threads`` slides are read and decoded on as many threads while the
current one is walked; the chunks, their order and the draws stay the same.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from tpuwsi_torch.io.grids import grid_file_path, load_grid_pickle
from tpuwsi_torch.io.levels import get_optimal_slide_level
from tpuwsi_torch.io.metadata import SlideTable
from tpuwsi_torch.io.slide_readers import open_slide
from tpuwsi_torch.io.tiles import TileStats, get_tiles
from tpuwsi_torch.utils.labels import get_label
from tpuwsi_torch.utils.minixlsx import read_csv


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


class SlideWalker:
    """``walk()`` yields the table's slides as padded chunks. ``seconds``
    adds up the host's time: "open" (reading and decoding each slide, on
    whichever thread) and "walk" (the grids, the draws and the tile cuts)."""

    def __init__(
        self,
        table: SlideTable,
        tiles_per_iter: int = 500,
        num_tiles: int = 500,
        resume_slide: int = 0,
        patch_dir: str = "",
        rng: Optional[np.random.Generator] = None,
        threads: int = 1,
    ):
        self.table = table
        self.tiles_per_iter = tiles_per_iter
        self.num_tiles_budget = num_tiles
        self.resume_slide = resume_slide
        self.patch_dir = patch_dir
        self.rng = rng or np.random.default_rng(0)
        self.threads = threads
        self.open_ahead = threads  # slides decoded ahead of the one walked
        self.stats = TileStats()
        self.seconds = {"open": 0.0, "walk": 0.0}

        self.num_tiles: List[int] = []
        self.slides_with_not_enough = 0
        for i in range(len(table)):
            t = int(table.tissue_tiles[i])
            if num_tiles <= t and t > 0:
                self.num_tiles.append(num_tiles)
            else:
                self.num_tiles.append(t)
                self.slides_with_not_enough += 1

        self._patch_xy = None
        if patch_dir:
            from glob import glob

            xf = glob(os.path.join(patch_dir, "*_x.csv"))
            yf = glob(os.path.join(patch_dir, "*_y.csv"))
            if len(xf) != 1 or len(yf) != 1:
                raise IOError("patch location files not found (or ambiguous) in dir")
            self._patch_xy = (read_csv(xf[0]), read_csv(yf[0]))

    def __len__(self):
        n = np.asarray(self.num_tiles[self.resume_slide :], dtype=float)
        return int(np.ceil(n / self.tiles_per_iter).sum())

    def _slide_locations(self, idx: int) -> List[Tuple[int, int]]:
        name = self.table.file_names[idx]
        if self._patch_xy is not None:
            x_pd, y_pd = self._patch_xy
            rows_x = [i for i, s in enumerate(x_pd["slide_name"]) if s == name]
            rows_y = [i for i, s in enumerate(y_pd["slide_name"]) if s == name]
            if len(rows_x) != 1 or len(rows_y) != 1:
                raise IOError(
                    f"slide {name!r} missing (or duplicated) in the patch "
                    "location CSVs — the resume CSVs must come from a run "
                    "over the same slide set"
                )
            rx, ry = rows_x[0], rows_y[0]
            # replay the SAVED locations: the CSV row's non-null count is
            # authoritative, not the current --num_tiles budget
            cols = [c for c in x_pd if c != "slide_name" and not math.isnan(float(x_pd[c][rx]))]
            n = min(len(cols), self.num_tiles[idx])
            return [(int(y_pd[str(i)][ry]), int(x_pd[str(i)][rx])) for i in range(n)]
        grid = load_grid_pickle(
            grid_file_path(
                self.table.path_names[idx],
                name,
                self.table.desired_magnification,
                self.table.tile_size,
            )
        )
        which = self.rng.choice(
            int(self.table.tissue_tiles[idx]),
            size=self.num_tiles[idx],
            replace=False,
        )
        return [grid[i] for i in which]

    def _open(self, idx: int):
        t0 = time.perf_counter()
        reader = open_slide(self.table.slide_path(idx))
        return reader, time.perf_counter() - t0

    def _readers(self) -> Iterator:
        """(slide index, reader) in table order, up to ``open_ahead`` slides
        opened ahead on threads (0: each slide opened when it is walked)."""
        order = range(self.resume_slide, len(self.table))
        pool = ThreadPoolExecutor(max(self.open_ahead, 1))
        pending, upcoming = deque(), iter(order)
        try:
            for idx in order:
                while len(pending) <= self.open_ahead:
                    nxt = next(upcoming, None)
                    if nxt is None:
                        break
                    pending.append(pool.submit(self._open, nxt))
                reader, seconds = pending.popleft().result()
                self.seconds["open"] += seconds
                yield idx, reader
        finally:  # the consumer stopped early: close what was opened ahead
            pool.shutdown(wait=True, cancel_futures=True)
            for f in pending:
                if not f.cancelled() and f.exception() is None:
                    f.result()[0].close()

    def walk(self) -> Iterator[InferChunk]:
        ts = self.table.tile_size
        tpi = self.tiles_per_iter
        for idx, reader in self._readers():
            t1 = time.perf_counter()
            best_level, adjusted, level0 = get_optimal_slide_level(
                reader.level_downsamples,
                self.table.magnifications[idx],
                self.table.desired_magnification,
                ts,
            )
            locs = self._slide_locations(idx)
            label = np.asarray(
                get_label(self.table.targets[idx], self.table.multi_target),
                dtype=np.int64,
            )
            n = len(locs)
            self.seconds["walk"] += time.perf_counter() - t1
            for start in range(0, n, tpi):
                t0 = time.perf_counter()
                chunk_locs = locs[start : start + tpi]
                k = len(chunk_locs)
                images = np.zeros((tpi, ts, ts, 3), dtype=np.uint8)
                get_tiles(reader, chunk_locs, level0, adjusted, ts, best_level,
                          random_shift=False, stats=self.stats, threads=self.threads,
                          out=images[:k])
                mask = np.zeros((tpi,), dtype=bool)
                mask[:k] = True
                self.seconds["walk"] += time.perf_counter() - t0
                yield InferChunk(
                    images=images,
                    mask=mask,
                    label=label,
                    slide_index=idx,
                    slide_name=self.table.file_names[idx],
                    patient_barcode=str(self.table.patient_barcodes[idx]),
                    slide_dataset=self.table.cohort_ids[idx],
                    initial_num_tiles=n,
                    is_last_batch=(start + tpi >= n),
                    locations=chunk_locs,
                    target=int(np.asarray(label).ravel()[0]),
                )
            reader.close()

    def save_patch_locations(self, out_dir: str, all_locations: Dict[str, list]):
        """Write the patch_locs_x.csv / patch_locs_y.csv resume files
        (datasets.py:330-345 format: one row per slide, columns 0..N-1; a
        column that pads some slide holds floats, as pandas writes it)."""
        os.makedirs(out_dir, exist_ok=True)
        names = list(all_locations.keys())
        max_n = max(len(v) for v in all_locations.values())
        for axis, fname in ((1, "patch_locs_x.csv"), (0, "patch_locs_y.csv")):
            cols = []
            for i in range(max_n):
                col = [all_locations[name][i][axis] if i < len(all_locations[name]) else None
                       for name in names]
                padded = any(v is None for v in col)
                cols.append(["" if v is None else repr(float(v)) if padded else str(int(v))
                             for v in col])
            with open(os.path.join(out_dir, fname), "w", newline="") as f:
                writer = csv.writer(f, lineterminator="\n")
                writer.writerow(["slide_name"] + [str(i) for i in range(max_n)])
                for r, name in enumerate(names):
                    writer.writerow([name] + [col[r] for col in cols])
