"""tpuwsi_torch's image-folder data layer held against the JAX package's.

The PNG decoder gives PIL's bytes on files PIL wrote (gray, gray + alpha,
RGB, RGBA, palette; converted to RGB and to L) and on files that use every
scanline filter; its resize gives PIL's default bicubic within one grey
level. ``ImageFolderDataset`` gives ``tpuwsi.io.folder``'s class maps,
samples and batches (order and bytes, exactly) for several seeds, host
strides, ``repeats`` and ``drop_last``, decoded on one thread or several;
a batch's decoding names the first file that fails. The ``Prefetcher``
re-raises its producer's error and retires its thread on ``close()``.
"""

import io
import struct
import sys
import threading
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from tpuwsi.io import folder as jfolder
from tpuwsi_torch.io import folder as tfolder
from tpuwsi_torch.io.image import (PNGError, decode_png, decode_png_files, load_image,
                                   load_images, resize_bicubic)
from tpuwsi_torch.io.prefetch import Prefetcher


def _png(img: np.ndarray, kinds, colour: int = 2, depth: int = 8, interlace: int = 0) -> bytes:
    """A PNG of ``img`` (H, W, C) whose scanline r is filtered with
    ``kinds[r]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), cur[:-1]])
    left = np.hstack([np.zeros((h, c), np.int16), cur[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int16), up[:, :-c]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(cur), left, up, (left + up) // 2, paeth])
    kinds = np.asarray(kinds)
    rows = ((cur - preds[kinds, np.arange(h)]) & 0xFF).astype(np.uint8)
    raw = np.hstack([kinds[:, None].astype(np.uint8), rows]).tobytes()

    def chunk(kind, body):
        crc = struct.pack(">I", zlib.crc32(kind + body))
        return struct.pack(">I", len(body)) + kind + body + crc

    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def _pil_png(mode: str, seed: int, optimize: bool) -> bytes:
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, 48, 2))
    # smooth content, so PIL's adaptive filtering picks every filter type
    base = (np.cumsum(rng.integers(0, 9, (h, w, 4)), axis=1) % 256).astype(np.uint8)
    if mode == "P":
        im = Image.fromarray(base[..., :3]).quantize(colors=int(rng.integers(17, 256)))
    else:
        im = Image.fromarray(base[..., :len(mode)] if len(mode) > 1 else base[..., 0], mode)
    buf = io.BytesIO()
    im.save(buf, "PNG", optimize=optimize)
    return buf.getvalue()


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_decoder_gives_pils_bytes(mode, optimize):
    for seed in range(6):
        data = _pil_png(mode, seed, optimize)
        for target in ("RGB", "L"):
            want = np.asarray(Image.open(io.BytesIO(data)).convert(target))
            got = decode_png("x.png", data, target)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{mode} → {target}, seed {seed}")


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("colour,channels", [(2, 3), (0, 1), (4, 2), (6, 4)])
def test_png_decoder_undoes_every_scanline_filter(colour, channels, kind, tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (19, 23, channels), dtype=np.uint8)
    kinds = rng.integers(0, 5, 19) if kind == "mixed" else np.full(19, kind)
    path = tmp_path / "f.png"
    path.write_bytes(_png(img, kinds, colour=colour))
    for target in ("RGB", "L"):
        want = np.asarray(Image.open(path).convert(target))
        np.testing.assert_array_equal(decode_png(str(path), mode=target), want)
    if colour == 2:
        np.testing.assert_array_equal(decode_png(str(path)), img)
        np.testing.assert_array_equal(load_image(str(path)), img)


def test_png_decoder_refusals(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    cases = {
        "interlaced.png": (_png(img, [0] * 4, interlace=1), "Adam7"),
        "deep.png": (_png(img, [0] * 4, depth=16), "bit depth 16"),
        "notpng.png": (b"GIF89a" + bytes(20), "not a PNG"),
    }
    im = Image.fromarray(np.arange(16, dtype=np.uint8).reshape(4, 4) % 4).convert("P")
    buf = io.BytesIO()
    im.save(buf, "PNG", bits=2)  # PIL packs a 4-colour palette image into 2 bits
    cases["packed.png"] = (buf.getvalue(), "bit depth")
    data = bytearray(_png(img, [0] * 4))
    data[-20] ^= 0xFF  # inside the IDAT body
    cases["damaged.png"] = (bytes(data), "CRC mismatch")
    raw = zlib.compress(bytes([0] + [0] * 12 + [5] + [0] * 12) + bytes(26))
    header = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    cases["filter5.png"] = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", raw)
                            + chunk(b"IEND", b""), "unknown scanline filter type 5")
    for name, (data, what) in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(PNGError, match=what) as e:
            decode_png(str(path))
        assert name in str(e.value)


@pytest.mark.parametrize("mode", ["RGB", "P"])
def test_png_decoder_refuses_every_cut_and_flip(mode):
    data = _pil_png(mode, 1, optimize=False)
    for cut in range(len(data)):
        with pytest.raises(PNGError):
            decode_png("x.png", data[:cut])
    rng = np.random.default_rng(0)
    for _ in range(300):
        flipped = bytearray(data)
        flipped[int(rng.integers(8, len(data)))] ^= int(rng.integers(1, 256))
        with pytest.raises(PNGError):  # every chunk's CRC covers it
            decode_png("x.png", bytes(flipped))


def test_other_extensions_need_pil(tmp_path, monkeypatch):
    arr = np.random.default_rng(0).integers(0, 256, (8, 9, 3), dtype=np.uint8)
    path = tmp_path / "t.bmp"
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(load_image(str(path)), arr)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match=r"\.bmp files .* PIL \(the Pillow package\)"):
        load_image(str(path))


@pytest.mark.parametrize("channels", [3, 1])
def test_resize_matches_pil_bicubic(channels):
    rng = np.random.default_rng(channels)
    worst = 0
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(3, 70, 2))
        size = int(rng.integers(4, 100))
        arr = rng.integers(0, 256, (h, w, 3) if channels == 3 else (h, w), dtype=np.uint8)
        want = np.asarray(Image.fromarray(arr).resize((size, size)))
        got = resize_bicubic(arr, size)
        assert got.shape == want.shape and got.dtype == np.uint8
        worst = max(worst, int(np.abs(got.astype(int) - want.astype(int)).max()))
    assert worst <= 1  # one grey level (PIL's fixed-point arithmetic, copied)


@pytest.fixture
def tree(tmp_path):
    """train/{a,b,c} and val/{a,c}: PNG, JPEG-free; tiles of two sizes."""
    rng = np.random.default_rng(7)
    for split, classes in (("train", "abc"), ("val", "ac")):
        for ci, c in enumerate(classes):
            d = tmp_path / split / c
            d.mkdir(parents=True)
            for i in range(5 + ci):
                side = 20 if i % 3 else 24
                arr = np.clip(rng.normal(60 + 60 * ci, 25, (side, side, 3)), 0, 255)
                Image.fromarray(arr.astype(np.uint8)).save(d / f"{i:02d}.png")
            (d / "notes.txt").write_text("not an image")
    (tmp_path / "classes.txt").write_text("c\nb\na\n")
    return tmp_path


def _same_dataset(t, j):
    assert t.class_to_idx == j.class_to_idx
    assert t.num_classes == j.num_classes
    assert t.samples == j.samples


@pytest.mark.parametrize("class_map", [False, True])
def test_folder_datasets_match_reference(tree, class_map):
    cmap = str(tree / "classes.txt") if class_map else None
    ttr, tva = tfolder.load_folder_datasets(str(tree), image_size=20, class_map=cmap)
    jtr, jva = jfolder.load_folder_datasets(str(tree), image_size=20, class_map=cmap)
    _same_dataset(ttr, jtr)
    _same_dataset(tva, jva)
    assert tfolder.load_class_map(str(tree / "classes.txt")) == jfolder.load_class_map(
        str(tree / "classes.txt"))
    for i in range(len(ttr)):
        np.testing.assert_array_equal(ttr.load(i), jtr.load(i))  # resized 24 → 20
    a, b = ttr.split(0.7, np.random.default_rng(5))
    c, d = jtr.split(0.7, np.random.default_rng(5))
    assert a.samples == c.samples and b.samples == d.samples
    assert ttr.subset([3, 1]).samples == jtr.subset([3, 1]).samples
    gray = tfolder.ImageFolderDataset(str(tree / "train"), channels=1)
    jgray = jfolder.ImageFolderDataset(str(tree / "train"), channels=1)
    np.testing.assert_array_equal(gray.load(2), jgray.load(2))
    with pytest.raises(ValueError, match="channels"):
        tfolder.ImageFolderDataset(str(tree / "train"), channels=2)


@pytest.mark.parametrize("seed,process_index,process_count,repeats,drop_last,shuffle,workers", [
    (0, 0, 1, 1, True, True, 0),
    (1, 0, 1, 1, False, True, 3),
    (2, 1, 2, 1, True, True, 0),
    (3, 1, 3, 1, False, True, 2),
    (4, 0, 1, 3, True, True, 0),
    (5, 0, 2, 2, False, False, 1),
])
def test_batches_match_reference(tree, seed, process_index, process_count, repeats, drop_last,
                                 shuffle, workers):
    t = tfolder.ImageFolderDataset(str(tree / "train"), image_size=22)
    j = jfolder.ImageFolderDataset(str(tree / "train"), image_size=22)
    kw = dict(shuffle=shuffle, drop_last=drop_last, process_index=process_index,
              process_count=process_count, repeats=repeats)
    got = list(t.batches(4, rng=np.random.default_rng(seed), workers=workers, **kw))
    want = list(j.batches(4, rng=np.random.default_rng(seed), **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["images"].dtype == w["images"].dtype == np.uint8
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["labels"], w["labels"])


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("workers", [0, 3])
def test_batches_of_one_size_decode_together_as_the_reference(tmp_path, workers, channels):
    rng = np.random.default_rng(11)
    for c in "ab":
        (tmp_path / c).mkdir()
        for i in range(7):
            base = (np.cumsum(rng.integers(0, 9, (24, 24, 4)), axis=1) % 256).astype(np.uint8)
            mode = ("RGB", "RGBA", "L", "P")[i % 4]  # each with PIL's adaptive filters
            im = (Image.fromarray(base[..., :3]).quantize(colors=40) if mode == "P" else
                  Image.fromarray(base[..., :len(mode)] if len(mode) > 1 else base[..., 0]))
            im.save(tmp_path / c / f"{i:02d}.png")
    t = tfolder.ImageFolderDataset(str(tmp_path), channels=channels)
    j = jfolder.ImageFolderDataset(str(tmp_path), channels=channels)
    got = list(t.batches(5, rng=np.random.default_rng(1), drop_last=False, workers=workers))
    want = list(j.batches(5, rng=np.random.default_rng(1), drop_last=False))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["images"].shape == w["images"].shape
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["labels"], w["labels"])


def test_batch_decoding_names_the_file_that_fails(tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(6):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, (9, 8, 3), dtype=np.uint8)).save(paths[-1])
    np.testing.assert_array_equal(decode_png_files(paths, threads=4),
                                  np.stack([np.asarray(Image.open(p)) for p in paths]))
    Image.fromarray(np.zeros((9, 9, 3), np.uint8)).save(tmp_path / "wide.png")
    data = bytearray((tmp_path / "0.png").read_bytes())
    data[-20] ^= 0xFF
    (tmp_path / "damaged.png").write_bytes(bytes(data))
    cases = [("wide.png", PNGError, r"wide\.png: 9 x 9 pixels, not the 8 x 9"),
             ("damaged.png", PNGError, r"damaged\.png: CRC mismatch"),
             ("gone.png", FileNotFoundError, r"gone\.png")]
    for name, error, what in cases:
        # the first of two failing files is named, whichever thread meets it first
        batch = paths[:3] + [str(tmp_path / name)] + paths[3:] + [str(tmp_path / "gone2.png")]
        with pytest.raises(error, match=what):
            decode_png_files(batch, threads=3)
    with pytest.raises(ValueError):  # as np.stack refuses tiles of two sizes
        load_images(paths + [str(tmp_path / "wide.png")])
    mixed = paths + [str(tmp_path / "wide.png")]
    np.testing.assert_array_equal(load_images(mixed, image_size=8),
                                  np.stack([resize_bicubic(decode_png(p), 8) for p in mixed]))


def test_prefetcher_reraises_and_closes():
    def failing():
        yield 1
        yield 2
        raise OSError("tile 3 is unreadable")

    feed = Prefetcher(failing(), depth=2)
    assert next(feed) == 1 and next(feed) == 2
    with pytest.raises(OSError, match="unreadable"):
        next(feed)
    with pytest.raises(StopIteration):
        next(feed)

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    before = threading.active_count()
    feed = Prefetcher((2 * x for x in endless()), depth=3)
    assert [next(feed) for _ in range(4)] == [0, 2, 4, 6]
    time.sleep(0.1)
    feed.close()
    feed.close()  # idempotent
    assert not feed._thread.is_alive()
    assert threading.active_count() <= before
    assert feed.wait_s >= 0.0
    assert list(Prefetcher(iter(range(5)))) == list(range(5))
