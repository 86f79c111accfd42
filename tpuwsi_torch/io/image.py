"""Image files as uint8 arrays, without PIL on the PNG and JPEG paths.

``.png`` is decoded by ``csrc/png_decode.c``: bit depth 8, no interlacing,
colour types gray, gray + alpha, RGB, RGBA and palette, each converted to RGB
or L as PIL's ``Image.convert`` does (alpha dropped, no compositing; L from
RGB by ITU-R 601-2 luma with PIL's integer rounding). ``.jpg``/``.jpeg`` by
``csrc/jpeg_decode.c``: baseline JPEG, the bytes libjpeg gives with its
default decoding (PIL's). Anything else in such a file raises, naming the file
and what is missing. The codecs (``csrc/codecs.h``: these two, and the TIFF
and MIRAX slide readers of ``io/ingest.py``) are one library built with the
host's C compiler on first use, linked to ``libz.so.1`` alone, and called
through ctypes, which releases the interpreter lock for the call:
``load_images`` reads and decodes a batch's files on threads of its own, so
a training loop's thread that launches kernels does not wait on the lock
while a batch decodes. Other extensions go through PIL where it imports, and
raise naming the extension and the package where it does not.

``resize_bicubic`` is PIL's default ``Image.resize`` filter: the bicubic
kernel with a = -0.5, antialiased when shrinking, 22-bit fixed-point
coefficients, a horizontal pass rounded to uint8, then a vertical pass.
``crop_resize`` does the same arithmetic in C (``csrc/crop_resize.c``) for a
batch of tiles cut from slides, on threads of its own outside the lock;
``resize_bilinear`` does PIL's bilinear resize of one rectangle (a TMA core).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
DECODED = (".png", ".jpg", ".jpeg")  # the extensions this package decodes itself
_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuwsi_torch"
# zlib is linked by its soname: the machine needs its shared library, not its headers
_CFLAGS = ("-O3", "-std=gnu11", "-shared", "-fPIC", "-pthread")
_LIBS = ("-l:libz.so.1",)
_ERR_LEN = 512
_HEAD = 33  # the signature and the IHDR chunk
_libs, _lib_lock = {}, threading.Lock()


class PNGError(ValueError):
    """A PNG file this decoder does not take, or a damaged one."""


class JPEGError(ValueError):
    """A JPEG file this decoder does not take, or a damaged one."""


def _host_lib(stem: str, libs: Sequence[str] = (), sources: Sequence[str] = ()) -> ctypes.CDLL:
    """``csrc/<stem>.c`` (or the ``csrc/`` files ``sources`` name, with
    ``codecs.h``), compiled on first use with ``$CC`` (else ``cc``) into
    ``build/tpuwsi_torch/`` at the repository root, keyed by a hash of the
    sources and the flags, and loaded once per process."""
    with _lib_lock:
        if stem in _libs:
            return _libs[stem]
        files = [_CSRC / name for name in (sources or (f"{stem}.c",))]
        flags = _CFLAGS + tuple(libs)
        h = hashlib.sha256(" ".join(flags).encode())
        for path in files + ([_CSRC / "codecs.h"] if sources else []):
            h.update(path.read_bytes())
        out = _BUILD_DIR / f"libtpuwsi_{stem}_{h.hexdigest()[:16]}.so"
        if not out.exists():
            cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
            if cc is None:
                raise RuntimeError(f"no C compiler (set CC): {stem} is built on first use")
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [cc, *_CFLAGS, "-o", str(tmp), *map(str, files), *libs]
            done = subprocess.run(cmd, capture_output=True, text=True)
            if done.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{' '.join(cmd)} failed ({done.returncode}):\n"
                                   f"{done.stderr}{done.stdout}")
            os.replace(tmp, out)  # atomic: a process loading concurrently sees a whole file
        _libs[stem] = ctypes.CDLL(str(out))
        return _libs[stem]


@functools.cache
def codec_lib() -> ctypes.CDLL:
    """The slide codecs (``csrc/codecs.h``): JPEG, PNG, TIFF and MIRAX, one
    library linked to zlib, its entry points typed."""
    lib = _host_lib("codecs", _LIBS, ("jpeg_decode.c", "png_decode.c", "tiff_read.c",
                                      "mirax_read.c"))
    ptr, i32, size, text = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p
    for name in ("tpuwsi_png_decode", "tpuwsi_jpeg_decode"):
        getattr(lib, name).argtypes = [text, size, i32, ptr, i32, i32, text, size]
    lib.tpuwsi_jpeg_size.argtypes = [text, size, ptr, ptr, ptr, text, size]
    lib.tpuwsi_decode_files.argtypes = [ctypes.POINTER(text), i32, i32, ptr, i32, i32, i32,
                                        ctypes.POINTER(i32), text, size]
    return lib


def _png_size(path: str, head: bytes) -> tuple:
    """→ (height, width) from the IHDR chunk, which the PNG specification
    puts first; its CRC is checked before the sizes are trusted."""
    if head[:8] != PNG_SIGNATURE:
        raise PNGError(f"{path}: not a PNG file (bad signature)")
    if len(head) < _HEAD or head[8:16] != b"\x00\x00\x00\x0dIHDR":
        raise PNGError(f"{path}: no IHDR chunk")
    if zlib.crc32(head[12:29]) != struct.unpack(">I", head[29:33])[0]:
        raise PNGError(f"{path}: CRC mismatch in the IHDR chunk")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def decode_png(path: str, data: Optional[bytes] = None, mode: str = "RGB") -> np.ndarray:
    """PNG file → uint8 ``(H, W, 3)`` for ``mode="RGB"`` or ``(H, W)`` for
    ``mode="L"``, the bytes PIL's ``Image.open(path).convert(mode)`` gives."""
    if mode not in ("RGB", "L"):
        raise ValueError(f"mode must be 'RGB' or 'L', got {mode!r}")
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    height, width = _png_size(path, data[:_HEAD])
    out = np.empty((height, width, 3 if mode == "RGB" else 1), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if codec_lib().tpuwsi_png_decode(data, len(data), out.shape[-1], out.ctypes.data, height,
                                    width, err, _ERR_LEN):
        raise PNGError(f"{path}: {err.value.decode(errors='backslashreplace')}")
    return out if mode == "RGB" else out[..., 0]


def _image_size(path: str, data: bytes) -> tuple:
    """→ (height, width) of a PNG or JPEG file's bytes (a PNG's first
    ``_HEAD`` bytes are enough)."""
    if data[:2] != JPEG_SIGNATURE:
        return _png_size(path, data[:_HEAD])
    return _jpeg_size(path, data)


def _jpeg_size(path: str, data: bytes) -> tuple:
    """→ (height, width) of a JPEG file's frame."""
    dims, err = (ctypes.c_int * 3)(), ctypes.create_string_buffer(_ERR_LEN)
    if codec_lib().tpuwsi_jpeg_size(data, len(data), ctypes.byref(dims, 0),
                                    ctypes.byref(dims, 4), ctypes.byref(dims, 8), err, _ERR_LEN):
        raise JPEGError(f"{path}: {err.value.decode(errors='backslashreplace')}")
    return dims[0], dims[1]


def decode_jpeg(path: str, data: Optional[bytes] = None, mode: str = "RGB") -> np.ndarray:
    """Baseline JPEG file → uint8 ``(H, W, 3)`` for ``mode="RGB"`` or
    ``(H, W)`` for ``mode="L"``, the bytes PIL's
    ``Image.open(path).convert(mode)`` gives (libjpeg's default decoding:
    ``csrc/jpeg_decode.c``). Progressive, arithmetic-coded and 12-bit files
    raise ``JPEGError`` naming what they are."""
    if mode not in ("RGB", "L"):
        raise ValueError(f"mode must be 'RGB' or 'L', got {mode!r}")
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    height, width = _jpeg_size(path, data)
    out = np.empty((height, width, 3 if mode == "RGB" else 1), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if codec_lib().tpuwsi_jpeg_decode(data, len(data), out.shape[-1], out.ctypes.data, height,
                                      width, err, _ERR_LEN):
        raise JPEGError(f"{path}: {err.value.decode(errors='backslashreplace')}")
    return out if mode == "RGB" else out[..., 0]


def decode_image_files(paths: Sequence[str], channels: int = 3, threads: int = 1) -> np.ndarray:
    """PNG or JPEG files of one size → uint8 ``(n, H, W, channels)`` (RGB or
    L, as ``decode_png`` and ``decode_jpeg``), read and decoded on ``threads``
    threads outside the interpreter lock. A file of another size than the
    first raises."""
    with open(paths[0], "rb") as f:
        head = f.read(_HEAD)
        height, width = _image_size(paths[0], head + (f.read() if head[:2] == JPEG_SIGNATURE
                                                      else b""))
    out = np.empty((len(paths), height, width, channels), np.uint8)
    names = (ctypes.c_char_p * len(paths))(*(os.fsencode(p) for p in paths))
    status, err = ctypes.c_int(0), ctypes.create_string_buffer(_ERR_LEN)
    first = codec_lib().tpuwsi_decode_files(names, len(paths), channels, out.ctypes.data, height,
                                            width, threads, ctypes.byref(status), err, _ERR_LEN)
    if first >= 0:
        path = paths[first]
        if status.value == 2:  # the file could not be read; the message is its errno
            code = int(err.value)
            raise OSError(code, os.strerror(code), path)
        with open(path, "rb") as f:
            kind = JPEGError if f.read(2) == JPEG_SIGNATURE else PNGError
        raise kind(f"{path}: {err.value.decode(errors='backslashreplace')}")
    return out


# PIL's resampling (Resample.c): bicubic support 2, 22-bit coefficients
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coefficients(in_size: int, out_size: int):
    """→ (first input index (out,), int coefficients (out, ksize)) of one
    axis, as PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    centre = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(centre - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(centre + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = _bicubic((taps[None, :] + xmin[:, None] - centre[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    scaled = w * (1 << _PRECISION_BITS)
    k = np.where(w < 0, np.trunc(scaled - 0.5), np.trunc(scaled + 0.5)).astype(np.int64)
    return xmin, k


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    xmin, k = _coefficients(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :], in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)       # (in, ...)
    win = src[idx]                                           # (out, ksize, ...)
    kk = k.reshape(k.shape + (1,) * (src.ndim - 1))
    acc = (win * kk).sum(axis=1) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 ``(H, W[, C])`` → ``(size, size[, C])``, the bytes of PIL's
    ``Image.fromarray(img).resize((size, size))`` (mode L or RGB)."""
    if img.shape[:2] == (size, size):
        return img.copy()
    out = img
    if img.shape[1] != size:
        out = _resample_axis(out, size, 1)
    if img.shape[0] != size:
        out = _resample_axis(out, size, 0)
    return out


@functools.cache
def _crop_resize_lib() -> ctypes.CDLL:
    lib = _host_lib("crop_resize")
    ptr, i32, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.tpuwsi_crop_resize.argtypes = [i32, ptr, ptr, ptr, i32, ptr, i32, ctypes.c_char_p, size]
    lib.tpuwsi_resize_bilinear.argtypes = [ptr, i32, i32, i32, ptr, ctypes.c_char_p, size]
    return lib


def resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 ``(H, W, 3)`` → ``(size, size, 3)`` in one call of
    ``csrc/crop_resize.c``: the bytes of PIL's ``Image.fromarray(img).resize(
    (size, size), Image.BILINEAR)`` (``resize_bicubic``'s arithmetic with the
    triangle kernel, on any rectangle)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.shape[:2] == (size, size):
        return img.copy()
    out = np.empty((size, size, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _crop_resize_lib().tpuwsi_resize_bilinear(img.ctypes.data, img.shape[0], img.shape[1],
                                                 size, out.ctypes.data, err, _ERR_LEN):
        raise RuntimeError(f"resize_bilinear: {err.value.decode(errors='backslashreplace')}")
    return out


def crop_resize(sources: Sequence[np.ndarray], boxes: np.ndarray, out_size: int,
                threads: int = 1, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Cut and resize a batch of RGB tiles in one call of ``csrc/crop_resize.c``
    on ``threads`` threads, outside the interpreter lock.

    Tile i comes from ``sources[i]`` (uint8 ``(H, W, 3)``, C-contiguous):
    ``boxes[i] = (row, col, rows, cols, region)`` puts the ``rows`` x ``cols``
    block at (row, col) at the top left of a ``region``² tile of zeros, which
    becomes ``out_size``² by ``resize_bicubic``'s arithmetic (the same bytes;
    a region of ``out_size`` is copied). → uint8 ``(n, out_size, out_size, 3)``,
    written into ``out`` where given."""
    boxes = np.ascontiguousarray(boxes, dtype=np.int32).reshape(-1, 5)
    n = len(boxes)
    if len(sources) != n:
        raise ValueError(f"{len(sources)} sources for {n} boxes")
    if out is None:
        out = np.empty((n, out_size, out_size, 3), np.uint8)
    if out.shape != (n, out_size, out_size, 3) or out.dtype != np.uint8 \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous uint8 {(n, out_size, out_size, 3)}")
    for src in {id(src): src for src in sources}.values():
        if (src.dtype != np.uint8 or src.ndim != 3 or src.shape[2] != 3
                or not src.flags.c_contiguous):
            raise ValueError("sources must be C-contiguous uint8 (H, W, 3) arrays")
    h, w = np.asarray([src.shape[:2] for src in sources], np.int64).reshape(n, 2).T
    row, col, rows, cols, region = boxes.T.astype(np.int64)
    inside = ((0 <= rows) & (rows <= region) & (0 <= cols) & (cols <= region) & (region > 0)
              & ((rows == 0) | ((0 <= row) & (row <= h - rows)))
              & ((cols == 0) | ((0 <= col) & (col <= w - cols))))
    if not inside.all():
        i = int(np.argmin(inside))
        raise ValueError(f"box {tuple(int(v) for v in boxes[i])} outside a {h[i]} x {w[i]} "
                         "image")
    if n == 0:
        return out
    ptrs = (ctypes.c_void_p * n)(*(src.ctypes.data for src in sources))
    widths = np.asarray([src.shape[1] for src in sources], np.int64)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _crop_resize_lib().tpuwsi_crop_resize(n, ptrs, widths.ctypes.data, boxes.ctypes.data,
                                             out_size, out.ctypes.data, max(int(threads), 1),
                                             err, _ERR_LEN):
        raise RuntimeError(f"crop_resize: {err.value.decode(errors='backslashreplace')}")
    return out


def load_image(path: str, channels: int = 3, image_size: Optional[int] = None) -> np.ndarray:
    """Image file → uint8 ``(H, W, 3)`` (``channels=3``) or ``(H, W, 1)``,
    resized to ``image_size`` squared with ``resize_bicubic`` where given and
    different: the bytes of ``tpuwsi.io.folder.ImageFolderDataset.load``."""
    mode = "L" if channels == 1 else "RGB"
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        arr = decode_png(path, mode=mode)
    elif ext in DECODED:
        arr = decode_jpeg(path, mode=mode)
    else:
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError(
                f"{path}: {ext} files are decoded through PIL (the Pillow package), which "
                "is not installed; this package decodes .png, .jpg and .jpeg itself") from None
        arr = np.asarray(Image.open(path).convert(mode), dtype=np.uint8)
    if image_size is not None and arr.shape[:2] != (image_size, image_size):
        arr = resize_bicubic(arr, image_size)
    return arr[..., None] if channels == 1 else arr


def load_images(paths: Sequence[str], channels: int = 3, image_size: Optional[int] = None,
                threads: int = 1) -> np.ndarray:
    """Image files → uint8 ``(n, H, W, channels)``, ``np.stack`` of
    ``load_image`` of each. PNG and JPEG files left at their size are decoded
    together by ``decode_image_files`` on ``threads`` threads; files to resize
    and other extensions one by one on the calling thread."""
    if paths and image_size is None and all(p.lower().endswith(DECODED) for p in paths):
        return decode_image_files(paths, channels, threads)
    return np.stack([load_image(p, channels, image_size) for p in paths])
