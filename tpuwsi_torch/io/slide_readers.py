"""Slide readers: a uniform pyramidal read_region interface
(``tpuwsi/io/slide_readers.py``).

- ``ImageSlideReader`` — a whole image held in memory, one pyramid level:
  PNG slides through the port's own decoder (``io/image.decode_png``, the
  bytes PIL's ``convert("RGB")`` gives), or an array.
- ``SyntheticSlideReader`` — deterministic procedural slide for tests/bench.

``open_slide`` takes ``.png``. Pyramidal TIFF, SVS, NDPI and MIRAX slides
and JPEG cores need a reader that runs on the card's machine, which has
neither libtiff nor libjpeg (ROADMAP.md, Queue 1, M1b): ``open_slide`` refuses
them by name, never reading page 0 of a pyramid and never falling back.

All readers return HWC uint8 RGB numpy arrays. A reader that holds a level
in memory hands it out through ``level_array``, so that the tile code cuts a
batch of tiles from it in one C call (``io/image.crop_resize``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

M1B_EXTENSIONS = (".svs", ".tif", ".tiff", ".ndpi", ".mrxs", ".jpg", ".jpeg")


class SlideReader:
    """Interface: dimensions (w, h) at level 0, level_downsamples, read_region."""

    dimensions: Tuple[int, int]
    level_downsamples: Sequence[float]

    def read_region(
        self, location: Tuple[int, int], level: int, size: Tuple[int, int]
    ) -> np.ndarray:
        """location is (x, y) in LEVEL-0 coordinates (OpenSlide convention);
        size is (w, h) at the requested level. Returns uint8 (h, w, 3)."""
        raise NotImplementedError

    def level_array(self, level: int) -> Optional[np.ndarray]:
        """The whole of ``level`` as a C-contiguous uint8 (h, w, 3) array
        where the reader holds it in memory, else None."""
        return None

    def close(self):
        pass


class ImageSlideReader(SlideReader):
    """Whole image held in memory; single pyramid level."""

    def __init__(self, path_or_array):
        if isinstance(path_or_array, np.ndarray):
            arr = path_or_array
            self.path = "<array>"
        else:
            from tpuwsi_torch.io.image import decode_png

            arr = decode_png(str(path_or_array))
            self.path = str(path_or_array)
        self._arr = np.ascontiguousarray(arr, dtype=np.uint8)
        h, w = self._arr.shape[:2]
        self.dimensions = (w, h)
        self.level_downsamples = [1.0]

    def read_region(self, location, level, size):
        assert level == 0
        x, y = location
        w, h = size
        out = np.zeros((h, w, 3), dtype=np.uint8)
        src = self._arr[max(y, 0) : y + h, max(x, 0) : x + w]
        out[: src.shape[0], : src.shape[1]] = src
        return out

    def level_array(self, level):
        return self._arr if level == 0 else None

    def close(self):
        self._arr = None


class SyntheticSlideReader(SlideReader):
    """Deterministic procedural pyramid for tests and benchmarks."""

    def __init__(self, width: int = 4096, height: int = 4096, levels: int = 3,
                 seed: int = 0):
        self.dimensions = (width, height)
        self.level_downsamples = [float(2 ** i) for i in range(levels)]
        self._seed = seed

    def read_region(self, location, level, size):
        x, y = location
        w, h = size
        ds = int(self.level_downsamples[level])
        xs = (x // ds + np.arange(w)) % 251
        ys = (y // ds + np.arange(h)) % 241
        r = (xs[None, :] * 3 + ys[:, None] * 7 + self._seed) % 256
        g = (xs[None, :] * 5 + ys[:, None] * 11 + self._seed) % 256
        b = (xs[None, :] * 13 + ys[:, None] * 2 + self._seed) % 256
        return np.stack([r, g, b], axis=-1).astype(np.uint8)


def check_readable(path: str) -> None:
    """Raise as ``open_slide`` would for a format it does not read, without
    reading the file."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return
    if ext in M1B_EXTENSIONS:
        raise NotImplementedError(
            f"cannot read {path}: {ext} slides (pyramidal TIFF/SVS/NDPI, MIRAX, JPEG cores) "
            "need a reader that runs on the card's machine, which has no libtiff or "
            "libjpeg (ROADMAP.md, Queue 1, M1b); this package reads .png slides")
    raise ValueError(f"cannot read {path}: no slide reader for {ext or 'files without an '
                     'extension'}; this package reads .png slides")


def open_slide(path: str) -> SlideReader:
    """The reader for a slide file: ``.png`` → ``ImageSlideReader``. The
    formats of M1b raise ``NotImplementedError``, any other extension
    ``ValueError``."""
    check_readable(path)
    return ImageSlideReader(path)
