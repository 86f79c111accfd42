"""Slide readers: a uniform pyramidal read_region interface
(``tpuwsi/io/slide_readers.py``).

- ``ImageSlideReader`` — a whole image held in memory, one pyramid level:
  PNG slides and JPEG cores through the port's own decoders
  (``io/image.decode_png`` and ``decode_jpeg``, the bytes PIL's
  ``convert("RGB")`` gives), or an array.
- ``CTileReader`` (``io/ingest.py``) — pyramidal TIFF, SVS, NDPI and MIRAX,
  read by the port's own C.
- ``SyntheticSlideReader`` — deterministic procedural slide for tests/bench.

``open_slide`` sends ``.tif/.tiff/.svs/.ndpi/.mrxs`` to ``CTileReader`` and
``.png/.jpg/.jpeg`` to ``ImageSlideReader``: a multi-page TIFF is read as its
pyramid, never as page 0, and a ``.mrxs`` never as an image. A file its
reader cannot parse raises, naming the file and what it lacks; nothing falls
back to another reader. JPEG 2000 tiles raise ``NotImplementedError`` (M1c).

All readers return HWC uint8 RGB numpy arrays. A reader that holds a level
in memory hands it out through ``level_array``, so that the tile code cuts a
batch of tiles from it in one C call (``io/image.crop_resize``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from tpuwsi_torch.io.image import DECODED as IMAGE_EXTENSIONS
from tpuwsi_torch.io.image import decode_jpeg, decode_png

PYRAMID_EXTENSIONS = (".tif", ".tiff", ".svs", ".ndpi", ".mrxs")


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

    def __init__(self, path_or_array, mirror_bgr: bool = False):
        if isinstance(path_or_array, np.ndarray):
            arr = path_or_array
            self.path = "<array>"
        else:
            self.path = str(path_or_array)
            png = self.path.lower().endswith(".png")
            arr = (decode_png if png else decode_jpeg)(self.path)
        if mirror_bgr:
            # cv2.imread's channel order (BGR), which the TMA cohorts' 'Amir'
            # normalization bank (the channel-reversed 'Ron' bank) expects
            arr = arr[..., ::-1]
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
    """Raise as ``open_slide`` would for a format it does not read: an
    unknown extension, or a TIFF pyramid in JPEG 2000 (M1c), found from the
    TIFF's directories without reading its tile tables."""
    ext = os.path.splitext(path)[1].lower()
    if ext in IMAGE_EXTENSIONS:
        return
    if ext in PYRAMID_EXTENSIONS:
        from tpuwsi_torch.io.ingest import check_pyramid

        check_pyramid(path)
        return
    raise ValueError(f"cannot read {path}: no slide reader for {ext or 'files without an '
                     'extension'}; this package reads {', '.join(PYRAMID_EXTENSIONS)} and "
                     f"{', '.join(IMAGE_EXTENSIONS)} slides")


def open_slide(path: str) -> SlideReader:
    """The reader for a slide file: ``.tif/.tiff/.svs/.ndpi/.mrxs`` →
    ``io.ingest.CTileReader``, ``.png/.jpg/.jpeg`` → ``ImageSlideReader``; any
    other extension raises ``ValueError``."""
    ext = os.path.splitext(path)[1].lower()
    if ext in PYRAMID_EXTENSIONS:
        from tpuwsi_torch.io.ingest import CTileReader

        return CTileReader(path)
    if ext not in IMAGE_EXTENSIONS:
        check_readable(path)
    return ImageSlideReader(path)
