"""Slides for the tests of the port's slide reader (M1b), and the committed
set under ``tests/data/torch_m1b/`` that ``chip_smoke.py``'s ``[wsi_formats]``
reads on the card's machine, which has no JPEG encoder, libtiff or libjpeg to
make or check them.

- ``write_tiff``: pyramidal TIFFs through the system's libtiff (ctypes):
  tiled or striped, none/LZW/Deflate/JPEG, the horizontal predictor, YCbCr
  JPEG with any subsampling (libtiff writes the tables once, as JPEGTables),
  classic or BigTIFF, either byte order.
- ``tissue``: a tissue-like picture (blobs of stain on near-white, noise).
- ``PYTHONPATH=. python tests/torch_m1b_fixtures.py`` (from the repository's
  root) rewrites the committed set and
  ``digests.json``: the SHA-256 of every level as the JAX package's
  ``CTileReader`` reads it whole, and of the JPEG core as PIL decodes it and
  as the JAX sampler's TMA branch resizes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_m1b")
DIGESTS = os.path.join(DATA, "digests.json")
# the committed set; TMA_SIZE is the core's resize in the digests
PYRAMIDS = ("svs_layout.svs", "tissue_ycbcr420.svs", "mirax/slide.mrxs")
CORE = "core.jpg"
TMA_SIZE = 256

_tiff = None


def _libtiff():
    global _tiff
    if _tiff is None:
        lib = ctypes.CDLL("libtiff.so.6")
        lib.TIFFOpen.restype = ctypes.c_void_p
        lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.TIFFWriteDirectory.argtypes = [ctypes.c_void_p]
        lib.TIFFClose.argtypes = [ctypes.c_void_p]
        lib.TIFFWriteTile.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                                      ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint16]
        lib.TIFFWriteEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                              ctypes.c_ssize_t]
        lib.TIFFWriteEncodedStrip.restype = ctypes.c_ssize_t
        _tiff = lib
    return _tiff


def _set(tif, tag: int, *values: int) -> None:
    # TIFFSetField is variadic: its 16- and 32-bit arguments travel as ints
    if _libtiff().TIFFSetField(ctypes.c_void_p(tif), ctypes.c_uint32(tag),
                               *[ctypes.c_int(int(v)) for v in values]) != 1:
        raise RuntimeError(f"TIFFSetField({tag}, {values}) failed")


def write_tiff(path: str, pages, mode: str = "w") -> None:
    """Write ``pages`` (dicts) as a TIFF's directories; ``mode`` is libtiff's
    ("w", "w8" BigTIFF, "wb" big-endian, "w8b"). Each page: ``img`` uint8
    (H, W, 3); ``tile`` (px) or ``rows`` (per strip, None: one strip);
    ``compression`` (1, 5, 7, 8, 32946); ``photometric`` (2 RGB, 6 YCbCr, from
    RGB given); ``subsampling``; ``predictor``; ``quality``; ``subfile``."""
    lib = _libtiff()
    tif = lib.TIFFOpen(path.encode(), mode.encode())
    if not tif:
        raise OSError(f"TIFFOpen({path!r}, {mode!r}) failed")
    try:
        for page in pages:
            img = np.ascontiguousarray(page["img"], dtype=np.uint8)
            h, w = img.shape[:2]
            compression = page.get("compression", 1)
            photometric = page.get("photometric", 2)
            for tag, value in ((256, w), (257, h), (277, 3), (258, 8), (284, 1),
                               (259, compression), (262, photometric)):
                _set(tif, tag, value)
            if page.get("subfile"):
                _set(tif, 254, page["subfile"])
            if compression == 7:
                _set(tif, 65537, page.get("quality", 75))  # JPEGQUALITY
                if photometric == 6:
                    _set(tif, 530, *page.get("subsampling", (2, 2)))
                    _set(tif, 65538, 1)  # JPEGCOLORMODE_RGB: libtiff converts the RGB given
            if page.get("predictor", 1) != 1:
                _set(tif, 317, page["predictor"])
            tile = page.get("tile")
            if tile:
                _set(tif, 322, tile)
                _set(tif, 323, tile)
                buf = np.zeros((tile, tile, 3), np.uint8)
                for ty in range(0, h, tile):
                    for tx in range(0, w, tile):
                        part = img[ty:ty + tile, tx:tx + tile]
                        buf[:] = 0
                        buf[:part.shape[0], :part.shape[1]] = part
                        if lib.TIFFWriteTile(tif, buf.ctypes.data, tx, ty, 0, 0) < 0:
                            raise OSError(f"TIFFWriteTile failed at {(tx, ty)}")
            else:
                rows = page.get("rows") or h
                _set(tif, 278, rows)
                for strip, y in enumerate(range(0, h, rows)):
                    part = np.ascontiguousarray(img[y:y + rows])
                    if lib.TIFFWriteEncodedStrip(tif, strip, part.ctypes.data, part.nbytes) < 0:
                        raise OSError(f"TIFFWriteEncodedStrip failed at strip {strip}")
            if lib.TIFFWriteDirectory(tif) != 1:
                raise OSError("TIFFWriteDirectory failed")
    finally:
        lib.TIFFClose(tif)


def tissue(h: int, w: int, seed: int, background=240.0) -> np.ndarray:
    """Blobs of purple/pink stain on ``background`` (near-white: slide glass),
    with texture and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3)) + np.asarray(background, np.float64)
    for _ in range(max(6, h * w // 40000)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.1, 0.3) * min(h, w)
        colour = rng.uniform((120, 60, 120), (220, 140, 210))
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = colour
    texture = 18 * np.sin(xx / 5.0 + rng.uniform(0, 6)) * np.cos(yy / 7.0)
    img += texture[..., None] + rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def tma_core_reference(path: str, size: int = TMA_SIZE) -> np.ndarray:
    """The JAX sampler's TMA branch (``tpuwsi/io/wsi.py:97-115``) on one core."""
    from PIL import Image

    from tpuwsi.io.slide_readers import ImageSlideReader

    reader = ImageSlideReader(path, mirror_bgr=True)
    arr = reader.read_region((0, 0), 0, reader.dimensions)
    margin = (arr.shape[1] - 1440) // 2
    if margin > 0:
        arr = arr[:, margin:-margin]
    return np.asarray(Image.fromarray(arr).resize((size, size), Image.BILINEAR))


def reference_digests() -> dict:
    """The committed set as the JAX package and PIL read it."""
    from PIL import Image

    from tpuwsi.io.ingest import CTileReader

    out = {}
    for name in PYRAMIDS:
        reader = CTileReader(os.path.join(DATA, name))
        out[name] = {"levels": [[w, h, ds] for (w, h), ds in
                                zip(reader._level_dims, reader.level_downsamples)],
                     "sha256": [sha256(reader.read_region((0, 0), level, dims))
                                for level, dims in enumerate(reader._level_dims)]}
        reader.close()
    core = os.path.join(DATA, CORE)
    pixels = np.asarray(Image.open(core).convert("RGB"))
    out[CORE] = {"levels": [[pixels.shape[1], pixels.shape[0], 1.0]],
                 "sha256": [sha256(pixels)],
                 f"tma_core_{TMA_SIZE}": sha256(tma_core_reference(core))}
    return out


def make_fixtures() -> None:
    from PIL import Image

    from tpuwsi.io.ingest import write_synthetic_mrxs, write_synthetic_svs_layout

    shutil.rmtree(DATA, ignore_errors=True)
    os.makedirs(os.path.join(DATA, "mirax"))
    # Aperio's layout: JPEG tiles in photometric RGB, a strip thumbnail, label, macro
    write_synthetic_svs_layout(os.path.join(DATA, "svs_layout.svs"), 1024, 768, levels=3,
                               tile=256, seed=11)
    # YCbCr 4:2:0 JPEG tiles with JPEGTables: the pool chip_smoke.py builds slides from,
    # tissue everywhere (pale stain between the blobs), as a slide's tissue region is
    img = tissue(1024, 1024, seed=3, background=(214, 168, 204))
    levels = [img, img[::2, ::2], img[::4, ::4]]
    write_tiff(os.path.join(DATA, "tissue_ycbcr420.svs"), [
        dict(img=lv, tile=256, compression=7, photometric=6, subsampling=(2, 2), quality=80,
             subfile=1 if i else 0) for i, lv in enumerate(levels)])
    write_synthetic_mrxs(os.path.join(DATA, "mirax", "slide.mrxs"), 640, 512, levels=2,
                         tile=128, seed=5)
    Image.fromarray(tissue(1100, 1600, seed=4)).save(os.path.join(DATA, CORE), quality=75)
    with open(DIGESTS, "w") as f:
        json.dump(reference_digests(), f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    make_fixtures()
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(DATA) for f in fs)
    print(f"wrote {DATA}: {total} bytes")
