"""WSI tile sampling (``tpuwsi/io/wsi.py``).

Parity: ``WSI_REGdataset`` (datasets.py:560-631) — bag_size=1 tile-level
training with ``factor = n_tiles`` virtual epochs (:427-429) — and the MIL
bag view (train_type='MIL', bag_size tiles per draw). Batches are raw uint8;
augmentation runs on the device inside the step. The ``Prefetcher`` is
``io/prefetch.py``.

A batch is made in three stages, each sample drawing from its own generator
(seeded from the epoch's), so the batches do not depend on thread timing:
the batch's slides not yet open are read and decoded on the sampler's pool
(each slide once, several at a time); Python then draws every sample's grid
locations and shifts in order; and one C call cuts and resizes all of the
batch's tiles on ``num_threads`` threads outside the interpreter lock
(``io/tiles.read_tiles``, after one C call that reads the batch's regions of
pyramidal slides, ``io/ingest.read_regions``). Every slide's reader stays
open, as in the JAX package: a PNG slide holds its whole decoded image, a
pyramidal one its directory and a file descriptor, its tiles read lazily. A
TMA cohort's sample is its whole core (``tma_core``), repeated.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from tpuwsi_torch.io.grids import grid_file_path, load_grid_pickle
from tpuwsi_torch.io.levels import get_optimal_slide_level
from tpuwsi_torch.io.metadata import SlideTable
from tpuwsi_torch.io.image import resize_bilinear
from tpuwsi_torch.io.slide_readers import ImageSlideReader, SlideReader, open_slide
from tpuwsi_torch.io.tiles import TileStats, choose_locations, plan_tiles, read_tiles
from tpuwsi_torch.utils.profiling import StageTimer

_TILE_TIME = "Average time to extract a tile"
_TMA_WIDTH = 1440


def tma_core(path: str, tile_size: int) -> np.ndarray:
    """A TMA core as the sampler takes it (``tpuwsi/io/wsi.py:97-115``,
    datasets.py:471-478): the whole JPEG in BGR order (``mirror_bgr``, for
    the 'Amir' bank), the width beyond 1,440 px cut off evenly, and PIL's
    bilinear resize to ``tile_size``² → uint8 ``(tile_size, tile_size, 3)``."""
    reader = ImageSlideReader(path, mirror_bgr=True)
    arr = reader.read_region((0, 0), 0, reader.dimensions)
    margin = (arr.shape[1] - _TMA_WIDTH) // 2
    if margin > 0:
        arr = np.ascontiguousarray(arr[:, margin:-margin])
    return resize_bilinear(arr, tile_size)


class WSITileSampler:
    """Random-tile sampler over a SlideTable (REG/MIL semantics)."""

    def __init__(
        self,
        table: SlideTable,
        n_tiles: int = 10,
        bag_size: int = 1,
        random_shift: bool = True,
        readers: Optional[Dict[int, SlideReader]] = None,
        num_threads: int = 8,
        balanced_sampling: bool = False,
        loan: bool = False,
        print_timing: bool = False,
    ):
        self.table = table
        self._tma = table.dataset.startswith("TMA")
        self.n_tiles = n_tiles
        self.bag_size = bag_size
        self.random_shift = random_shift
        self.balanced_sampling = balanced_sampling
        # --loan: per-tile labels from QuPath local_labels masks replace the
        # slide target (train.py:380, utils.py:144-149/183-196)
        self.loan = loan
        self.num_threads = max(int(num_threads), 1)
        self.stats = TileStats()
        # -time parity (datasets.py:512-526): per-stage extraction timing
        self.stage_timer = StageTimer(enabled=print_timing)
        self._readers = readers or {}
        self._grids: Dict[int, list] = {}
        self._loans: Dict[int, object] = {}
        self._level_cache: Dict[int, tuple] = {}
        self._cores: Dict[int, np.ndarray] = {}
        self._opening: Dict[int, threading.Lock] = {}
        self._pool = ThreadPoolExecutor(max_workers=self.num_threads)
        # RLock: _loan() holds the lock and opens the reader via _reader()
        self._lock = threading.RLock()

    # -- lazy per-slide state -------------------------------------------------
    def _reader(self, idx: int) -> SlideReader:
        with self._lock:
            if idx in self._readers:
                return self._readers[idx]
            opening = self._opening.setdefault(idx, threading.Lock())
        with opening:  # one decode per slide; other slides decode meanwhile
            with self._lock:
                if idx in self._readers:
                    return self._readers[idx]
            reader = open_slide(self.table.slide_path(idx))
            with self._lock:
                self._readers[idx] = reader
            return reader

    def _grid(self, idx: int) -> list:
        with self._lock:
            if idx not in self._grids:
                path = grid_file_path(
                    self.table.path_names[idx],
                    self.table.file_names[idx],
                    self.table.desired_magnification,
                    self.table.tile_size,
                )
                self._grids[idx] = load_grid_pickle(path)
            return self._grids[idx]

    def _levels(self, idx: int) -> tuple:
        if idx not in self._level_cache:
            reader = self._reader(idx)
            self._level_cache[idx] = get_optimal_slide_level(
                reader.level_downsamples,
                self.table.magnifications[idx],
                self.table.desired_magnification,
                self.table.tile_size,
            )
        return self._level_cache[idx]

    def _loan(self, idx: int):
        with self._lock:
            if idx not in self._loans:
                from tpuwsi_torch.io.loan import load_loan_annotation

                reader = self._reader(idx)
                self._loans[idx] = load_loan_annotation(
                    self.table.slide_path(idx),
                    bounds=getattr(reader, "bounds", (0, 0)),
                )
            return self._loans[idx]

    def _presaved(self, idx: int) -> bool:
        return self.table.cohort_ids[idx] == "ABCTB_TILES"

    def _whole(self, idx: int) -> bool:
        """A sample not cut from a grid: presaved tiles, or a TMA core."""
        return self._tma or self._presaved(idx)

    def _open(self, idx: int) -> None:
        """Everything a slide's draws need: reader, grid, levels, mask."""
        self._reader(idx)
        self._grid(idx)
        self._levels(idx)
        if self.loan:
            self._loan(idx)

    # -- sampling --------------------------------------------------------------
    def _sample_whole(self, idx: int, rng: np.random.Generator, n: int) -> np.ndarray:
        if self._tma:  # the core, decoded and resized once a slide (no draws)
            with self._lock:
                core = self._cores.get(idx)
            if core is None:
                core = tma_core(self.table.slide_path(idx), self.table.tile_size)
                with self._lock:
                    core = self._cores.setdefault(idx, core)
            return np.repeat(core[None], n, axis=0)
        # presaved-tile cohort (datasets.py:452-467)
        from tpuwsi_torch.io.presaved import sample_presaved_tiles, tiles_dir_for_slide

        return sample_presaved_tiles(
            tiles_dir_for_slide(self.table.path_names[idx], self.table.file_names[idx]),
            int(self.table.tissue_tiles[idx]), n, self.table.tile_size, rng)

    def _plan(self, idx: int, rng: np.random.Generator, n: int):
        """A slide's draws for ``n`` tiles → (request, loan labels or None)."""
        best_level, adjusted, level0 = self._levels(idx)
        locs = choose_locations(rng, self._grid(idx), n)
        loan = self._loan(idx) if self.loan else None
        return plan_tiles(self._reader(idx), locs, level0, adjusted, best_level, rng=rng,
                          random_shift=self.random_shift, loan=loan)

    def _with_labels(self, tiles: np.ndarray, labels, n: int):
        if not self.loan:
            return tiles
        # loan requested but this slide has no annotation file: label -1
        return tiles, (labels if labels is not None else np.zeros(n, dtype=np.int64) - 1)

    def sample_slide(self, idx: int, rng: np.random.Generator, n: int):
        """``n`` tiles of slide ``idx`` drawn with ``rng`` (with ``loan``:
        (tiles, labels))."""
        if self._whole(idx):
            return self._sample_whole(idx, rng, n)
        self._open(idx)
        request, labels = self._plan(idx, rng, n)
        t0 = time.perf_counter()
        tiles = read_tiles([request], self.table.tile_size, self.stats)
        self.stage_timer.add(_TILE_TIME, time.perf_counter() - t0)
        return self._with_labels(tiles, labels, n)

    def close(self) -> None:
        """Stop the pool and drop the readers (the decoded slides)."""
        self._pool.shutdown(wait=True)
        with self._lock:
            for reader in self._readers.values():
                reader.close()
            self._readers.clear()

    def __len__(self):
        # REG virtual epoch length (datasets.py:427-429, 445-446)
        return len(self.table) * self.n_tiles

    def epoch_indices(self, rng: np.random.Generator) -> np.ndarray:
        if self.balanced_sampling:
            # WeightedRandomSampler parity (train.py:719-731): sample slides
            # with replacement, weight ∝ 1 / class frequency. Unknown targets
            # (label -1) get weight 0 — never sampled.
            labels = self.table.labels().reshape(len(self.table), -1)[:, 0]
            weights = np.zeros(len(labels), dtype=np.float64)
            n_pos = int(np.sum(labels == 1))
            n_neg = int(np.sum(labels == 0))
            if n_pos:
                weights[labels == 1] = 1.0 / n_pos
            if n_neg:
                weights[labels == 0] = 1.0 / n_neg
            if weights.sum() == 0:
                weights[:] = 1.0
            weights = weights / weights.sum()
            return rng.choice(len(self.table), size=len(self), replace=True, p=weights)
        idx = np.repeat(np.arange(len(self.table)), self.n_tiles)
        rng.shuffle(idx)
        return idx

    def process_order(
        self, rng: np.random.Generator, process_index: int = 0, process_count: int = 1,
    ) -> np.ndarray:
        """This process's strided slice of the epoch index stream
        (DistributedSampler semantics: all hosts shuffle with the SAME seed,
        then rank p takes every p-th element), truncated to the common
        per-host length so that every host runs the same number of batches."""
        idx = self.epoch_indices(rng)
        per_host = len(idx) // process_count
        return idx[process_index::process_count][:per_host]

    def _batch_tiles(self, chunk: np.ndarray, seeds: np.ndarray):
        """The batch's tiles (B * bag, ts, ts, 3) and loan labels (B, bag)."""
        bs, ts = self.bag_size, self.table.tile_size
        rngs = [np.random.default_rng(int(s)) for s in seeds]
        slides = [int(i) for i in chunk]
        unopened = [i for i in dict.fromkeys(slides)
                    if not self._whole(i) and i not in self._level_cache]
        if unopened:
            list(self._pool.map(self._open, unopened))
        whole = {k: self._pool.submit(self._sample_whole, i, rngs[k], bs)
                 for k, i in enumerate(slides) if self._whole(i)}
        plans = {k: self._plan(i, rngs[k], bs) for k, i in enumerate(slides)
                 if k not in whole}
        tiles = np.empty((len(slides) * bs, ts, ts, 3), np.uint8)
        t0 = time.perf_counter()
        requests = [plans[k][0] for k in sorted(plans)]
        if whole:
            cut = read_tiles(requests, ts, self.stats, self.num_threads)
            for j, k in enumerate(sorted(plans)):
                tiles[k * bs:(k + 1) * bs] = cut[j * bs:(j + 1) * bs]
            for k, future in whole.items():
                tiles[k * bs:(k + 1) * bs] = future.result()
        else:  # the cuts straight into the batch
            read_tiles(requests, ts, self.stats, self.num_threads, out=tiles)
        self.stage_timer.add(_TILE_TIME, time.perf_counter() - t0, len(plans))
        labels = np.zeros((len(slides), bs), dtype=np.int64) - 1
        for k, (_, loan_labels) in plans.items():
            if loan_labels is not None:
                labels[k] = loan_labels
        return tiles, labels

    def batches(
        self,
        rng: np.random.Generator,
        batch_size: int,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield {'images': (B, ts, ts, 3) u8, 'labels': (B,)} batches
        (``images`` (B, bag, ts, ts, 3) for bags), each process taking a
        strided slice of the epoch's index stream."""
        labels = self.table.labels()
        order = self.process_order(rng, process_index, process_count)
        ts = self.table.tile_size
        bs = self.bag_size
        for start in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            chunk = order[start : start + batch_size]
            if len(chunk) == 0:
                break
            seeds = rng.integers(0, 2 ** 31, size=len(chunk))
            tiles, tile_labels = self._batch_tiles(chunk, seeds)
            tiles = tiles.reshape(len(chunk), bs, ts, ts, 3)
            if self.loan:
                batch_labels = tile_labels[:, 0] if bs == 1 else tile_labels
            else:
                batch_labels = (
                    labels[chunk][:, 0]
                    if labels.ndim > 1 and not self.table.multi_target
                    else labels[chunk]
                )
            batch = {"labels": batch_labels, "slide_indices": chunk.astype(np.int64)}
            # REG squeeze (datasets.py:618)
            batch["images"] = tiles[:, 0] if bs == 1 else tiles
            yield batch
