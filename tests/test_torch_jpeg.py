"""The port's baseline JPEG decoder (``tpuwsi_torch/io/csrc/jpeg_decode.c``)
and its PIL-exact bilinear resize of a rectangle (``io.image.resize_bilinear``,
the TMA cores'), held byte for byte against PIL (libjpeg-turbo) on files PIL
writes: 4:4:4, 4:2:2, 4:2:0 and grey at qualities 50, 90 and 100, sizes that
are not multiples of the MCU, restart intervals, Adobe RGB, ``convert("L")``,
and batches of files decoded on threads. Progressive, arithmetic-coded,
12-bit and damaged files raise, naming what they are."""

import io

import numpy as np
import pytest
from PIL import Image

from tpuwsi_torch.io.image import (JPEGError, decode_image_files, decode_jpeg, load_image,
                                   load_images, resize_bilinear)

# sizes around the 8- and 16-px MCUs, and tiny ones (fancy upsampling's edge cases)
SIZES = [(64, 64), (37, 29), (17, 100), (9, 3), (2, 2), (1, 5), (256, 255)]


def _picture(h, w, seed=0):
    """Gradients, texture and noise: every DCT frequency and clipping."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 3 + y) % 256, (y * 5 + x // 2) % 256, (x * y // 7) % 256], -1)
    return np.clip(img + rng.normal(0, 24, img.shape), 0, 255).astype(np.uint8)


def _jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data: bytes, mode="RGB") -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert(mode))


@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_decode_jpeg_matches_pil(subsampling, quality):
    for i, (h, w) in enumerate(SIZES):
        data = _jpeg(_picture(h, w, i), quality=quality, subsampling=subsampling)
        assert np.array_equal(decode_jpeg("x.jpg", data), _pil(data)), (h, w)


@pytest.mark.parametrize("quality", [50, 90, 100])
def test_grey_jpeg_matches_pil(quality):
    for i, (h, w) in enumerate(SIZES):
        data = _jpeg(_picture(h, w, i)[..., 1], quality=quality)
        assert np.array_equal(decode_jpeg("x.jpg", data), _pil(data)), (h, w)
        assert np.array_equal(decode_jpeg("x.jpg", data, mode="L"), _pil(data, "L"))


@pytest.mark.parametrize("option", [{"restart_marker_blocks": 3}, {"restart_marker_rows": 1},
                                    {"optimize": True}, {"keep_rgb": True},
                                    {"subsampling": "4:2:0", "restart_marker_blocks": 1}])
def test_restarts_optimized_tables_and_adobe_rgb_match_pil(option):
    data = _jpeg(_picture(77, 123, 5), quality=85, **option)
    if "restart_marker_blocks" in option or "restart_marker_rows" in option:
        assert b"\xff\xdd" in data  # a DRI marker: the file does have restart intervals
    if "keep_rgb" in option:
        assert b"Adobe" in data  # RGB kept, the Adobe marker says so (transform 0)
    assert np.array_equal(decode_jpeg("x.jpg", data), _pil(data))


def test_mode_l_is_pils_luma_of_the_rgb_decode():
    data = _jpeg(_picture(50, 70, 1), quality=90)
    assert np.array_equal(decode_jpeg("x.jpg", data, mode="L"), _pil(data, "L"))


def _with_sof(data: bytes, marker: int = None, precision: int = None) -> bytes:
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def test_what_the_decoder_does_not_take_raises_by_name():
    img = _picture(40, 48, 2)
    with pytest.raises(JPEGError, match="progressive"):
        decode_jpeg("p.jpg", _jpeg(img, progressive=True))
    base = _jpeg(img, quality=90)
    with pytest.raises(JPEGError, match="arithmetic"):
        decode_jpeg("a.jpg", _with_sof(base, marker=0xC9))
    with pytest.raises(JPEGError, match="12-bit"):
        decode_jpeg("t.jpg", _with_sof(base, precision=12))
    with pytest.raises(JPEGError, match="lossless"):
        decode_jpeg("l.jpg", _with_sof(base, marker=0xC3))
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    with pytest.raises(JPEGError, match="CMYK"):
        decode_jpeg("c.jpg", cmyk.getvalue())
    with pytest.raises(JPEGError, match="x.jpg"):
        decode_jpeg("x.jpg", base[:len(base) // 2])  # cut: the EOI and data are missing
    with pytest.raises(JPEGError, match="no SOI"):
        decode_jpeg("y.jpg", b"GIF89a" + base)


def test_image_files_on_threads_match_one_by_one(tmp_path):
    paths = []
    for i in range(9):
        img = _picture(48, 40, i)
        if i % 3 == 2:  # PNG and JPEG in one batch
            path = tmp_path / f"{i}.png"
            Image.fromarray(img).save(path)
        else:
            path = tmp_path / f"{i}.jpg"
            Image.fromarray(img).save(path, quality=80 + i,
                                      subsampling=["4:2:0", "4:4:4"][i % 2])
        paths.append(str(path))
    want = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in paths])
    for threads in (1, 4):
        assert np.array_equal(decode_image_files(paths, threads=threads), want)
        assert np.array_equal(load_images(paths, threads=threads), want)
    grey = np.stack([np.asarray(Image.open(p).convert("L")) for p in paths])[..., None]
    assert np.array_equal(load_images(paths, channels=1, threads=3), grey)
    assert np.array_equal(load_image(paths[0], image_size=32),
                          np.asarray(Image.open(paths[0]).convert("RGB").resize((32, 32))))
    (tmp_path / "bad.jpg").write_bytes(b"\xff\xd8\xff\xd9")
    with pytest.raises(JPEGError, match="bad.jpg"):
        decode_image_files(paths[:2] + [str(tmp_path / "bad.jpg")], threads=2)


@pytest.mark.parametrize("h,w,size", [(1100, 1440, 256), (37, 50, 64), (300, 200, 97),
                                      (10, 400, 256)])
def test_resize_bilinear_matches_pil(h, w, size):
    img = _picture(h, w, size)
    want = np.asarray(Image.fromarray(img).resize((size, size), Image.BILINEAR))
    assert np.array_equal(resize_bilinear(img, size), want)
