"""Pyramidal slides read by the port's own C (``tpuwsi/io/ingest.py``).

``CTileReader`` reads pyramidal TIFF, Aperio SVS and Hamamatsu NDPI
(``csrc/tiff_read.c``: tiled or striped, classic or BigTIFF; none, LZW,
Deflate or JPEG) and MIRAX (``csrc/mirax_read.c``: JPEG, PNG or BMP24 tiles),
with the levels, downsamples and pixels of the JAX package's ``CTileReader``.
JPEG tiles go through ``csrc/jpeg_decode.c``, the bytes libjpeg gives. The
library is built on first use by ``io/image._host_lib`` and links only
``libz.so.1``. JPEG 2000 tiles raise ``NotImplementedError`` at open (M1c);
any other file the reader does not take raises ``ValueError`` naming what it
lacks: nothing falls back to another reader or to a blank slide.

``read_regions`` reads a batch of regions, from any number of slides, in one
C call on threads of its own outside the interpreter lock (the meaning of the
JAX package's ``ti_extract_batch``, without its resize); each region decodes
the tiles it covers, and nothing decoded is kept between calls.
``check_pyramid`` raises what opening a TIFF would raise for its levels, from
the file's directories alone.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Sequence, Tuple

import numpy as np

from tpuwsi_torch.io.image import _ERR_LEN, codec_lib
from tpuwsi_torch.io.slide_readers import SlideReader

_OS_ERROR, _NOT_IMPLEMENTED = 2, 3


class _Region(ctypes.Structure):
    _fields_ = [("slide", ctypes.c_void_p), ("level", ctypes.c_int32),
                ("status", ctypes.c_int32), ("x", ctypes.c_int64), ("y", ctypes.c_int64),
                ("w", ctypes.c_int64), ("h", ctypes.c_int64), ("offset", ctypes.c_int64)]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = codec_lib()
    ptr, i32, i64, size, text = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_size_t,
                                 ctypes.c_char_p)
    lib.tpuwsi_slide_open.argtypes = [text, ctypes.POINTER(i32), text, size]
    lib.tpuwsi_slide_open.restype = ptr
    lib.tpuwsi_slide_levels.argtypes = [ptr]
    lib.tpuwsi_slide_level.argtypes = [ptr, i32, ptr, ptr, ptr]
    lib.tpuwsi_slide_close.argtypes = [ptr]
    lib.tpuwsi_slide_read_region.argtypes = [ptr, i32, i64, i64, i64, i64, ptr, text, size]
    lib.tpuwsi_slide_read_regions.argtypes = [ctypes.POINTER(_Region), i32, ptr, i32, text, size]
    lib.tpuwsi_slide_check.argtypes = [text, text, size]
    return lib


def _message(err) -> str:
    return err.value.decode(errors="backslashreplace")


def _raise(status: int, err, path: str):
    if status == _OS_ERROR:
        code = int(err.value)
        raise OSError(code, os.strerror(code), path)
    if status == _NOT_IMPLEMENTED:
        raise NotImplementedError(_message(err))
    raise ValueError(_message(err))


def check_pyramid(path: str) -> None:
    """Raise as ``CTileReader(path)`` would for a TIFF level this package
    does not read (``NotImplementedError`` for JPEG 2000: M1c), reading only
    the TIFF's directories, not its tile tables; a MIRAX slide is not read."""
    err = ctypes.create_string_buffer(_ERR_LEN)
    status = _lib().tpuwsi_slide_check(os.fsencode(path), err, _ERR_LEN)
    if status:
        _raise(status, err, path)


class CTileReader(SlideReader):
    """A pyramidal TIFF/SVS/NDPI or MIRAX slide, opened by the C reader."""

    def __init__(self, path: str):
        lib = _lib()
        status, err = ctypes.c_int(0), ctypes.create_string_buffer(_ERR_LEN)
        self._handle = lib.tpuwsi_slide_open(os.fsencode(path), ctypes.byref(status), err,
                                             _ERR_LEN)
        if not self._handle:
            _raise(status.value, err, path)
        self.path = path
        dims: List[Tuple[int, int]] = []
        downs: List[float] = []
        w, h, ds = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_double()
        for level in range(lib.tpuwsi_slide_levels(self._handle)):
            lib.tpuwsi_slide_level(self._handle, level, ctypes.byref(w), ctypes.byref(h),
                                   ctypes.byref(ds))
            dims.append((w.value, h.value))
            downs.append(ds.value)
        self.dimensions = dims[0]
        self.level_downsamples = downs
        self._level_dims = dims
        # the origin is the slide's own (MIRAX's is moved to its tiles' bounding box)
        self.bounds = (0, 0)

    def read_region(self, location, level, size):
        x, y = location
        w, h = size
        if not 0 <= level < len(self.level_downsamples):
            raise IndexError(f"{self.path}: level {level} of {len(self.level_downsamples)}")
        out = np.empty((h, w, 3), np.uint8)
        err = ctypes.create_string_buffer(_ERR_LEN)
        if _lib().tpuwsi_slide_read_region(self._handle, level, x, y, w, h, out.ctypes.data,
                                           err, _ERR_LEN):
            raise IOError(f"{self.path}: {_message(err)}")
        return out

    def close(self):
        if getattr(self, "_handle", None):  # also after an __init__ that raised
            _lib().tpuwsi_slide_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def read_regions(requests: Sequence[Tuple[CTileReader, int, int, int, int, int]],
                 threads: int = 1) -> Tuple[List[np.ndarray], List[Tuple[int, str]]]:
    """``(reader, x, y, level, w, h)`` regions of any slides → (uint8 ``(h, w, 3)``
    arrays in order, the ``(index, message)`` of each read that failed, whose
    array is then zeros). One C call on ``threads`` threads, outside the
    interpreter lock; the bytes ``read_region`` gives one by one."""
    n = len(requests)
    regions = (_Region * max(n, 1))()
    offset = 0
    for i, (reader, x, y, level, w, h) in enumerate(requests):
        if not 0 <= level < len(reader.level_downsamples):
            raise IndexError(f"{reader.path}: level {level} of {len(reader.level_downsamples)}")
        regions[i] = _Region(reader._handle, level, 0, x, y, w, h, offset)
        offset += w * h * 3
    flat = np.zeros(offset, np.uint8)
    failed: List[Tuple[int, str]] = []
    if n:
        err = ctypes.create_string_buffer(_ERR_LEN)
        if _lib().tpuwsi_slide_read_regions(regions, n, flat.ctypes.data, max(int(threads), 1),
                                            err, _ERR_LEN):
            for i in range(n):
                if regions[i].status:
                    failed.append((i, _message(err)))
                    r = regions[i]
                    flat[r.offset:r.offset + r.w * r.h * 3] = 0
    tiles = [flat[r.offset:r.offset + r.w * r.h * 3].reshape(r.h, r.w, 3)
             for r in regions[:n]]
    return tiles, failed
