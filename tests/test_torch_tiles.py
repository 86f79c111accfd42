"""The port's tile reads held against the JAX package's, byte for byte.

``tpuwsi_torch.io`` ``grids``, ``tiles``, ``slide_readers``, ``presaved`` and
``loan`` against ``tpuwsi.io``'s on PNG slides (the port's decoder against
PIL), synthetic pyramids and arrays: the tissue grids, ``get_tiles`` and
``choose_data`` with and without the random shift, with resizing (2x, odd
ratios, upsampling) and ``oversized_hc_tiles``, tiles across the slide's
edge, the blank-tile fallback and its count, and the C crop-and-resize
(``io.image.crop_resize``) against ``resize_bicubic`` and PIL.
"""

import os

import numpy as np
import pytest
from PIL import Image

from tpuwsi.io import grids as j_grids
from tpuwsi.io import loan as j_loan
from tpuwsi.io import presaved as j_presaved
from tpuwsi.io import slide_readers as j_readers
from tpuwsi.io import tiles as j_tiles
from tpuwsi_torch.io import grids as t_grids
from tpuwsi_torch.io import loan as t_loan
from tpuwsi_torch.io import presaved as t_presaved
from tpuwsi_torch.io import slide_readers as t_readers
from tpuwsi_torch.io import tiles as t_tiles
from tpuwsi_torch.io.image import crop_resize, resize_bicubic


def _tissue_image(seed: int, h: int, w: int) -> np.ndarray:
    """Near-white background with a few coloured blobs and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.full((h, w, 3), 240.0)
    for _ in range(4):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(h / 6, h / 3)
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        img[blob] = rng.uniform(60, 200, 3)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def png_slide(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("slide") / "slide.png")
    Image.fromarray(_tissue_image(0, 200, 264)).save(path)
    return path


def _reader_pair(kind, png_slide):
    if kind == "png":
        return j_readers.open_slide(png_slide), t_readers.open_slide(png_slide)
    if kind == "array":
        arr = _tissue_image(1, 150, 170)
        return j_readers.ImageSlideReader(arr), t_readers.ImageSlideReader(arr)
    return (j_readers.SyntheticSlideReader(300, 260, 3, seed=5),
            t_readers.SyntheticSlideReader(300, 260, 3, seed=5))


def test_png_reader_and_refusals(png_slide):
    j, t = _reader_pair("png", png_slide)
    assert t.dimensions == j.dimensions and t.level_downsamples == j.level_downsamples
    assert np.array_equal(t.read_region((0, 0), 0, t.dimensions), np.asarray(
        Image.open(png_slide).convert("RGB")))
    for loc, size in (((-5, 7), (40, 30)), ((250, 190), (40, 30)), ((10, 10), (1, 1))):
        assert np.array_equal(t.read_region(loc, 0, size), j.read_region(loc, 0, size))
    for ext in t_readers.PYRAMID_EXTENSIONS + t_readers.IMAGE_EXTENSIONS:
        with pytest.raises(FileNotFoundError):  # each is read, by the port's own code
            t_readers.open_slide(f"/nowhere/slide{ext.upper()}")
    with pytest.raises(ValueError, match=".png"):
        t_readers.open_slide("/nowhere/slide.bmp")


@pytest.mark.parametrize("kind", ["png", "array", "synthetic"])
@pytest.mark.parametrize("tile,preview", [(32, None), (40, 4), (16, 1)])
def test_build_tissue_grid_matches_jax(kind, tile, preview, png_slide, tmp_path):
    j, t = _reader_pair(kind, png_slide)
    want = j_grids.build_tissue_grid(j, tile, preview_downsample=preview)
    got = t_grids.build_tissue_grid(t, tile, preview_downsample=preview)
    assert got == want and len(want) > 0
    # both pickle and packed files cross between the packages
    t_grids.save_grid_pickle(str(tmp_path / "t.data"), got)
    assert j_grids.load_grid_pickle(str(tmp_path / "t.data")) == want
    j_grids.save_grid_packed(str(tmp_path / "j.grid"), want)
    assert np.array_equal(t_grids.load_grid_packed(str(tmp_path / "j.grid")),
                          np.asarray(want, "<i4"))
    assert t_grids.grid_file_path("/c", "a.b.svs", 10, 256) == \
        j_grids.grid_file_path("/c", "a.b.svs", 10, 256)
    assert t_grids.grid_data_columns(256, 10) == j_grids.grid_data_columns(256, 10)


# (level-0 tile, adjusted, output, level): crops, 2x, odd ratios, upsampling
_GEOMETRY = [(32, 32, 32, 0), (64, 64, 32, 0), (48, 48, 32, 0), (30, 30, 32, 0),
             (37, 37, 23, 0), (64, 32, 32, 1), (64, 16, 32, 2)]


@pytest.mark.parametrize("kind", ["png", "array", "synthetic"])
@pytest.mark.parametrize("geometry", _GEOMETRY, ids=[str(g) for g in _GEOMETRY])
@pytest.mark.parametrize("shift,oversized", [(False, False), (True, False), (False, True)])
def test_get_tiles_matches_jax(kind, geometry, shift, oversized, png_slide):
    level0, adjusted, out, level = geometry
    j, t = _reader_pair(kind, png_slide)
    w, h = t.dimensions
    rng = np.random.default_rng(11)
    # tiles inside, on every edge and corner, and past the slide
    locs = [(int(rng.integers(0, h)), int(rng.integers(0, w))) for _ in range(12)]
    locs += [(0, 0), (h - level0, w - level0), (h - 5, 3), (3, w - 5), (h + 40, w + 40)]
    results = []
    for mod, reader in ((j_tiles, j), (t_tiles, t)):
        stats = mod.TileStats()
        tiles = mod.get_tiles(reader, locs, level0, adjusted, out, level,
                              rng=np.random.default_rng(3), random_shift=shift,
                              oversized_hc_tiles=oversized, stats=stats)
        results.append((tiles, stats))
    (want, want_stats), (got, got_stats) = results
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert (got_stats.tiles_read, got_stats.read_failures) == \
        (want_stats.tiles_read, want_stats.read_failures)
    if kind != "synthetic" and level > 0:
        assert got_stats.read_failures == len(locs)  # one level: blank tiles, counted


def test_get_tiles_threads_do_not_change_the_bytes(png_slide):
    _, t = _reader_pair("png", png_slide)
    locs = [(i * 7 % 150, i * 13 % 200) for i in range(40)]
    one = t_tiles.get_tiles(t, locs, 48, 48, 32, 0, threads=1)
    four = t_tiles.get_tiles(t, locs, 48, 48, 32, 0, threads=4)
    assert np.array_equal(one, four)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mag", [20, 10, 40])
def test_choose_data_matches_jax(seed, mag, png_slide):
    j, t = _reader_pair("png", png_slide)
    grid = t_grids.build_tissue_grid(t, 32)
    want = j_tiles.choose_data(j, grid, 5, 20, tile_size=32, desired_mag=mag,
                               rng=np.random.default_rng(seed))
    got = t_tiles.choose_data(t, grid, 5, 20, tile_size=32, desired_mag=mag,
                              rng=np.random.default_rng(seed))
    assert got[1] == want[1]
    assert np.array_equal(got[0], want[0])
    with pytest.raises(ValueError, match="more tiles"):
        t_tiles.choose_locations(np.random.default_rng(0), grid, len(grid) + 1)


_RESIZES = [(512, 256), (256, 256), (300, 256), (77, 32), (32, 77), (103, 64), (64, 31),
            (1, 5), (5, 1), (2, 1), (257, 128)]


@pytest.mark.parametrize("region,out", _RESIZES)
def test_crop_resize_matches_resize_bicubic_and_pil(region, out):
    img = np.random.default_rng(region * 1000 + out).integers(0, 256, (600, 700, 3),
                                                              dtype=np.uint8)
    other = np.ascontiguousarray(img[::-1, :350])
    boxes = np.array([[10, 20, region, region, region],
                      [0, 0, max(region - 5, 0), max(region - 3, 0), region],
                      [600 - min(region, 100), 3, min(region, 100), min(region, 300), region],
                      [0, 0, 0, 0, region]], np.int32)
    sources = [img, img, other, img]
    got = crop_resize(sources, boxes, out, threads=3)
    for src, (r, c, rs, cs, reg), tile_out in zip(sources, boxes, got):
        tile = np.zeros((reg, reg, 3), np.uint8)
        tile[:rs, :cs] = src[r:r + rs, c:c + cs]
        want = resize_bicubic(tile, out)
        assert np.array_equal(tile_out, want)
        assert np.array_equal(want, np.asarray(Image.fromarray(tile).resize((out, out))))


def test_crop_resize_refuses_bad_boxes():
    img = np.zeros((10, 10, 3), np.uint8)
    with pytest.raises(ValueError, match="outside"):
        crop_resize([img], np.array([[5, 5, 6, 5, 8]]), 4)
    with pytest.raises(ValueError, match="C-contiguous"):
        crop_resize([img[:, ::2]], np.array([[0, 0, 2, 2, 2]]), 4)


def test_presaved_tiles_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    tiles_dir = t_presaved.tiles_dir_for_slide(str(tmp_path), "slide_1.ndpi")
    assert tiles_dir == j_presaved.tiles_dir_for_slide(str(tmp_path), "slide_1.ndpi")
    for i in range(6):
        tile = rng.integers(0, 256, (40 + i, 36, 4 if i % 2 else 3), dtype=np.uint8)
        (t_presaved if i % 2 else j_presaved).write_presaved_tile(
            os.path.join(tiles_dir, f"tile_{i}.data"), tile)
        path = os.path.join(tiles_dir, f"tile_{i}.data")
        assert np.array_equal(t_presaved.read_presaved_tile(path),
                              j_presaved.read_presaved_tile(path))
    for seed in range(3):
        want = j_presaved.sample_presaved_tiles(tiles_dir, 6, 4, 32, np.random.default_rng(seed))
        got = t_presaved.sample_presaved_tiles(tiles_dir, 6, 4, 32, np.random.default_rng(seed))
        assert np.array_equal(got, want)


def test_loan_labels_match_jax(tmp_path, png_slide):
    slide = tmp_path / "s.png"
    slide.write_bytes(open(png_slide, "rb").read())
    assert t_loan.load_loan_annotation(str(slide)) is None
    mask = np.zeros((25, 33, 3), np.uint8)
    mask[5:15, 8:20, 0] = 250
    mask[16:, :, 0] = 249
    os.makedirs(tmp_path / "local_labels")
    Image.fromarray(mask).save(tmp_path / "local_labels" / "s-labels.png")
    assert t_loan.annotation_path(str(slide)) == j_loan.annotation_path(str(slide))
    want = j_loan.load_loan_annotation(str(slide), bounds=(16, 8))
    got = t_loan.load_loan_annotation(str(slide), bounds=(16, 8))
    assert np.array_equal(got.image, want.image)
    origins = [(y, x) for y in range(0, 200, 23) for x in range(0, 264, 29)]
    assert np.array_equal(got.labels(origins, 48), want.labels(origins, 48))
    # get_tiles with loan: the same tiles and labels from the shifted origins
    j, t = _reader_pair("png", png_slide)
    locs = origins[:15]
    jt, jl = j_tiles.get_tiles(j, locs, 48, 48, 32, 0, rng=np.random.default_rng(1),
                               random_shift=True, loan=want)
    tt, tl = t_tiles.get_tiles(t, locs, 48, 48, 32, 0, rng=np.random.default_rng(1),
                               random_shift=True, loan=got)
    assert np.array_equal(tt, jt) and np.array_equal(tl, jl) and 0 < tl.sum() < len(tl)
