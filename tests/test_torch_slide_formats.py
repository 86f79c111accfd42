"""The port's slide reader for real cohorts (M1b): ``io.ingest.CTileReader``
(``csrc/tiff_read.c``, ``csrc/mirax_read.c``, ``csrc/jpeg_decode.c``) held
byte for byte against the JAX package's ``CTileReader.read_region``
(libtiff, libjpeg, libpng) at every level, at regions across tile edges and
the slide's edge:

- the JAX writers' slides: tiled JPEG pyramids, Aperio's SVS layout (level
  detection as ``tests/test_ingest.py`` checks it), MIRAX;
- libtiff's layouts (``torch_m1b_fixtures.write_tiff``): YCbCr JPEG with
  JPEGTables at 4:2:0, 4:2:2, 4:4:0 and 4:4:4, tiled, striped and in one
  strip; RGB JPEG in BigTIFF; LZW and Deflate with the predictor, in either
  byte order; uncompressed tiles;
- PIL's striped TIFFs (an "NDPI", LZW, Deflate) and a TIFF without
  RowsPerStrip;
- every ``tests/mirax_fixture.py`` case and its geometry fuzz;
- JPEG 2000 tiles raise ``NotImplementedError`` naming M1c, and what the
  reader does not take raises naming it;
- ``read_regions`` on threads against ``read_region`` one by one;
- the committed set under ``tests/data/torch_m1b/`` against its digests;
- the sampler (SVS and TMA cohorts) against the JAX sampler, and ``-ef``
  through both packages' ``main`` over a small SVS and a small TMA cohort
  (the 'Amir' bank) at 1e-4.
"""

import json
import os
import struct

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_supervised import _tiny_models
from torch_m1b_fixtures import (CORE, DATA, DIGESTS, PYRAMIDS, TMA_SIZE, sha256, tissue,
                                tma_core_reference, write_tiff)
from tpuwsi.io import ingest as jingest
from tpuwsi.io.wsi import WSITileSampler as JWSITileSampler
from tpuwsi_torch.io import grids as t_grids
from tpuwsi_torch.io.cohorts import get_datasets_dir_dict
from tpuwsi_torch.io.ingest import CTileReader, read_regions
from tpuwsi_torch.io.metadata import load_slide_table
from tpuwsi_torch.io.slide_readers import ImageSlideReader, check_readable, open_slide
from tpuwsi_torch.io.wsi import WSITileSampler, tma_core
from tpuwsi_torch.models.convert import params_from_flax
from tpuwsi_torch.utils.minixlsx import write_xlsx

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _regions(dims, downsamples, rng, n=6):
    """(x, y, level, w, h): the whole level, its corners past the edge, and
    random regions that cross tile edges, at every level."""
    out = []
    for level, ((w, h), ds) in enumerate(zip(dims, downsamples)):
        at = lambda x, y: (int(x * ds), int(y * ds))  # noqa: E731
        out += [(*at(0, 0), level, w, h), (*at(-7, -9), level, 40, 50),
                (*at(w - 30, h - 20), level, 61, 47)]
        for _ in range(n):
            x, y = int(rng.integers(-20, w)), int(rng.integers(-20, h))
            out.append((*at(x, y), level, int(rng.integers(1, 200)), int(rng.integers(1, 200))))
    return out


def assert_reads_like_jax(path, seed=0):
    want, got = jingest.CTileReader(path), CTileReader(path)
    assert got.dimensions == want.dimensions
    assert got.level_downsamples == want.level_downsamples
    assert got._level_dims == want._level_dims
    for x, y, level, w, h in _regions(got._level_dims, got.level_downsamples,
                                      np.random.default_rng(seed)):
        np.testing.assert_array_equal(got.read_region((x, y), level, (w, h)),
                                      want.read_region((x, y), level, (w, h)),
                                      err_msg=f"{os.path.basename(path)} {(x, y, level, w, h)}")
    want.close()
    return got


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("slides")


# -- the JAX package's writers ---------------------------------------------------------

def test_jax_written_pyramids(tmp):
    p = str(tmp / "synthetic.tif")
    jingest.write_synthetic_slide(p, 1000, 700, levels=3, tile=256, seed=7)
    assert assert_reads_like_jax(p).level_downsamples == [1.0, 2.0, 4.0]
    p = str(tmp / "aperio_like.svs")
    jingest.write_synthetic_svs_layout(p, 2048, 1536, levels=3, tile=256, seed=7)
    r = assert_reads_like_jax(p)
    # the tissue pyramid: not the strip thumbnail (dir 1), the label or the macro
    assert r.dimensions == (2048, 1536) and [round(d) for d in r.level_downsamples] == [1, 2, 4]
    assert r._level_dims[1:] == [(1024, 768), (512, 384)]
    p = str(tmp / "carmel_like.mrxs")
    jingest.write_synthetic_mrxs(p, 2000, 1600, levels=3, tile=256, seed=7)
    assert len(assert_reads_like_jax(p).level_downsamples) == 3


# -- libtiff's layouts --------------------------------------------------------------------

_A, _B = tissue(300, 420, 1), tissue(150, 210, 2)
_LAYOUTS = {
    "ycbcr420_tiled.svs": ([dict(img=_A, tile=64, compression=7, photometric=6, quality=80),
                            dict(img=_B, tile=64, compression=7, photometric=6, subfile=1)],
                           "w"),
    "ycbcr422_tiled.tif": ([dict(img=_A, tile=64, compression=7, photometric=6,
                                 subsampling=(2, 1))], "w"),
    "ycbcr440_tiled.tif": ([dict(img=_A, tile=64, compression=7, photometric=6,
                                 subsampling=(1, 2))], "w"),
    "ycbcr444_strips.tif": ([dict(img=_A, rows=48, compression=7, photometric=6,
                                  subsampling=(1, 1))], "w"),
    "ycbcr420_strips.ndpi": ([dict(img=_A, rows=32, compression=7, photometric=6)], "w"),
    "ycbcr420_one_strip.ndpi": ([dict(img=_A, compression=7, photometric=6, quality=95)], "w"),
    "rgb_jpeg_bigtiff.tif": ([dict(img=_A, tile=128, compression=7, photometric=2)], "w8"),
    "lzw_predictor_msb.tif": ([dict(img=_A, tile=64, compression=5, predictor=2),
                               dict(img=_B, tile=64, compression=5, subfile=1)], "wb"),
    "lzw_strips.tif": ([dict(img=_A, rows=7, compression=5)], "w"),
    "deflate_predictor_bigtiff_msb.tif": ([dict(img=_A, tile=48, compression=8,
                                                predictor=2)], "w8b"),
    "deflate_32946_strips.tif": ([dict(img=_A, rows=16, compression=32946)], "w"),
    "uncompressed_tiles.tiff": ([dict(img=_A, tile=32, compression=1),
                                 dict(img=_B, tile=32, compression=1, subfile=1)], "w"),
}


@pytest.mark.parametrize("name", sorted(_LAYOUTS))
def test_libtiff_layouts(tmp, name):
    pages, mode = _LAYOUTS[name]
    path = str(tmp / name)
    write_tiff(path, pages, mode)
    reader = assert_reads_like_jax(path, seed=len(name))
    assert reader._level_dims == [p["img"].shape[1::-1] for p in pages]
    if pages[0]["compression"] != 7:  # lossless: the pixels written
        assert np.array_equal(reader.read_region((0, 0), 0, reader.dimensions), _A)


@pytest.mark.parametrize("compression", [None, "tiff_lzw", "tiff_deflate",
                                         "tiff_adobe_deflate"])
def test_pil_striped_tiffs(tmp, compression):
    arr = np.random.default_rng(0).integers(0, 255, (600, 800, 3), dtype=np.uint8)
    path = str(tmp / f"pil_{compression}.ndpi")  # NDPI-class: striped containers
    Image.fromarray(arr).save(path, format="TIFF", compression=compression)
    reader = assert_reads_like_jax(path)
    assert type(open_slide(path)) is CTileReader
    np.testing.assert_array_equal(reader.read_region((100, 50), 0, (64, 32)),
                                  arr[50:82, 100:164])


def test_tiff_without_rows_per_strip(tmp):
    """A single strip with no RowsPerStrip tag (``tests/test_ingest.py:540``)."""
    w = h = 64
    pixels = np.random.default_rng(0).integers(0, 255, (h, w, 3), dtype=np.uint8).tobytes()
    ifd_off = 8 + len(pixels)
    bits_off = ifd_off + 2 + 9 * 12 + 4

    def tag(code, typ, count, value):
        return struct.pack("<HHI4s", code, typ, count, value)

    short = lambda v: struct.pack("<HH", v, 0)  # noqa: E731
    long_ = lambda v: struct.pack("<I", v)  # noqa: E731
    entries = [tag(256, 3, 1, short(w)), tag(257, 3, 1, short(h)), tag(258, 3, 3, long_(bits_off)),
               tag(259, 3, 1, short(1)), tag(262, 3, 1, short(2)), tag(273, 4, 1, long_(8)),
               tag(277, 3, 1, short(3)), tag(279, 4, 1, long_(len(pixels))),
               tag(284, 3, 1, short(1))]
    data = (struct.pack("<2sHI", b"II", 42, ifd_off) + pixels + struct.pack("<H", len(entries))
            + b"".join(entries) + struct.pack("<I", 0) + struct.pack("<HHH", 8, 8, 8))
    path = str(tmp / "nostrip.tif")
    with open(path, "wb") as f:
        f.write(data)
    reader = assert_reads_like_jax(path)
    expected = np.frombuffer(pixels, np.uint8).reshape(h, w, 3)[8:24, 8:24]
    np.testing.assert_array_equal(reader.read_region((8, 8), 0, (16, 16)), expected)


def test_what_the_tiff_reader_does_not_take_raises_by_name(tmp):
    img = tissue(40, 48, 0)
    rgba = str(tmp / "rgba.tif")
    Image.fromarray(img).convert("RGBA").save(rgba)
    with pytest.raises(ValueError, match="4 samples"):
        CTileReader(rgba)
    grey = str(tmp / "grey.tif")
    Image.fromarray(img[..., 0]).save(grey)
    with pytest.raises(ValueError, match="1 samples"):
        CTileReader(grey)
    (tmp / "bogus.svs").write_bytes(b"not a tiff at all")
    with pytest.raises(ValueError, match="not a TIFF"):
        CTileReader(str(tmp / "bogus.svs"))
    with pytest.raises(FileNotFoundError):
        open_slide(str(tmp / "gone.svs"))


# -- MIRAX -------------------------------------------------------------------------------

_MIRAX_CASES = {
    "divisions_multifile": dict(cam_x=3, cam_y=2, divisions=2, tile=64, overlap=8, levels=2,
                                seed=5, n_data_files=3),
    "absent_cameras": dict(cam_x=3, cam_y=2, divisions=1, tile=64, overlap=8, levels=2,
                           seed=3, absent_cameras=((1, 0), (2, 1))),
    "png": dict(cam_x=2, cam_y=2, divisions=2, tile=32, overlap=8, levels=2, seed=9,
                image_format="PNG"),
    "bmp24": dict(cam_x=2, cam_y=2, divisions=2, tile=32, overlap=8, levels=2, seed=9,
                  image_format="BMP24"),
    "zlib_positions": dict(cam_x=3, cam_y=2, divisions=2, tile=32, overlap=8, levels=2,
                           seed=4, zlib_position=True),
}


@pytest.mark.parametrize("case", sorted(_MIRAX_CASES))
def test_mirax_fixture_cases(tmp, case):
    from mirax_fixture import write_mirax

    path = write_mirax(str(tmp / f"{case}.mrxs"), **_MIRAX_CASES[case])
    assert_reads_like_jax(path)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mirax_geometry_fuzz(tmp, seed):
    """``tests/test_ingest.py:477``'s geometries, read like the JAX reader."""
    from mirax_fixture import write_mirax

    rng = np.random.default_rng(100 + seed)
    cam_x, cam_y = int(rng.integers(2, 5)), int(rng.integers(1, 4))
    divisions, tile = int(rng.choice([1, 2])), int(rng.choice([32, 64]))
    overlap, levels = int(rng.choice([0, 8, 16])), int(rng.integers(1, 3))
    absent = []
    if cam_x * cam_y > 2 and rng.random() < 0.5:
        absent = [(int(rng.integers(0, cam_x)), int(rng.integers(0, cam_y)))]
    path = write_mirax(str(tmp / f"fuzz{seed}.mrxs"), cam_x=cam_x, cam_y=cam_y,
                       divisions=divisions, tile=tile, overlap=overlap, levels=levels, seed=seed,
                       absent_cameras=tuple(absent), n_data_files=int(rng.integers(1, 4)))
    assert_reads_like_jax(path, seed)


def test_mirax_refusals(tmp):
    from mirax_fixture import write_mirax

    path = write_mirax(str(tmp / "exotic.mrxs"), cam_x=2, cam_y=1, divisions=1, tile=32,
                       overlap=8, levels=1, seed=1)
    ini = os.path.join(str(tmp / "exotic"), "Slidedat.ini")
    with open(ini) as f:
        text = f.read()
    with open(ini, "w") as f:
        f.write(text.replace("IMAGE_FORMAT = JPEG", "IMAGE_FORMAT = JPEG2000"))
    with pytest.raises(ValueError, match="IMAGE_FORMAT"):
        CTileReader(path)
    # a page chain that points at itself fails at open, at once
    path = write_mirax(str(tmp / "cycle.mrxs"), cam_x=2, cam_y=1, divisions=1, tile=32,
                       overlap=8, levels=1, seed=1)
    idx_path = os.path.join(str(tmp / "cycle"), "Index.dat")
    idx = bytearray(open(idx_path, "rb").read())
    hier_root = struct.unpack_from("<i", idx, 5 + len(f"PYSYNTH-{1:08x}"))[0]
    page = struct.unpack_from("<i", idx, hier_root)[0]
    struct.pack_into("<i", idx, page + 4, page)
    open(idx_path, "wb").write(idx)
    with pytest.raises(ValueError, match="page chain"):
        CTileReader(path)
    bogus = tmp / "bogus.mrxs"
    bogus.write_text("not mirax")
    with pytest.raises(ValueError, match="Slidedat.ini"):
        open_slide(str(bogus))


# -- JPEG 2000 (M1c) ---------------------------------------------------------------------

@pytest.mark.parametrize("compression", [33005, 33003])
def test_jpeg2000_tiles_raise_naming_m1c(tmp, compression):
    from jp2k_fixture import write_jp2k_svs

    path = str(tmp / f"jp2k_{compression}.svs")
    write_jp2k_svs(path, tissue(300, 300, 0), tile=256, compression=compression, levels=1)
    assert jingest.CTileReader(path).dimensions == (300, 300)  # the JAX package reads it
    with pytest.raises(NotImplementedError, match="M1c"):
        open_slide(path)
    with pytest.raises(NotImplementedError, match="M1c"):
        check_readable(path)


def test_check_readable_reads_only_the_directories(tmp):
    """The CLI's start-up check reads a TIFF's directories, not its tile
    tables: a tiled TIFF whose TileOffsets lie past the end of the file
    passes it, and opening the slide raises naming what it lacks. A MIRAX
    slide is not read by the check."""
    entries = [(256, 3, 64), (257, 3, 64), (258, 3, 8), (259, 3, 1), (262, 3, 2),
               (277, 3, 3), (322, 3, 32), (323, 3, 32), (324, 4, None), (325, 4, None)]
    ifd = struct.pack("<H", len(entries))
    for tag, typ, value in entries:
        count = 4 if value is None else 1
        if value is None:  # four LONGs past the end of the file
            value = 1 << 20
        ifd += struct.pack("<HHI", tag, typ, count)
        ifd += struct.pack("<HH" if typ == 3 else "<I", *((value, 0) if typ == 3 else (value,)))
    path = tmp / "far_offsets.tif"
    path.write_bytes(b"II*\x00" + struct.pack("<I", 8) + ifd + b"\x00" * 4)
    check_readable(str(path))
    with pytest.raises(ValueError, match="offsets or byte counts"):
        open_slide(str(path))
    bogus = tmp / "bogus_check.mrxs"
    bogus.write_text("not mirax")
    check_readable(str(bogus))
    with pytest.raises(ValueError, match="Slidedat.ini"):
        open_slide(str(bogus))


# -- batches of regions --------------------------------------------------------------------

def test_read_regions_on_threads_equal_read_region(tmp):
    slides = []
    for i, (name, (pages, mode)) in enumerate(sorted(_LAYOUTS.items())[:4]):
        path = str(tmp / f"batch_{name}")
        write_tiff(path, pages, mode)
        slides.append(CTileReader(path))
    from mirax_fixture import write_mirax

    slides.append(CTileReader(write_mirax(str(tmp / "batch.mrxs"), **_MIRAX_CASES["png"])))
    rng = np.random.default_rng(3)
    requests = [(s, *r) for s in slides for r in _regions(s._level_dims, s.level_downsamples,
                                                             rng, n=10)]
    rng.shuffle(requests)
    want = [s.read_region((x, y), level, (w, h)) for s, x, y, level, w, h in requests]
    for threads in (1, 4, 8):
        got, failed = read_regions(requests, threads)
        assert not failed
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_)
    reader = slides[0]
    tiles, failed = read_regions([(reader, 0, 0, 0, 64, 64), (reader, 30, 30, 0, 10, 20)],
                                 threads=2)
    assert not failed
    np.testing.assert_array_equal(tiles[1], reader.read_region((30, 30), 0, (10, 20)))


# -- the committed set ------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PYRAMIDS) + [CORE])
def test_committed_digests_match_both_packages(name):
    from tpuwsi.io.slide_readers import open_slide as j_open_slide

    with open(DIGESTS) as f:
        want = json.load(f)[name]
    path = os.path.join(DATA, name)
    for reader in (j_open_slide(path), open_slide(path)):
        dims = getattr(reader, "_level_dims", [reader.dimensions])
        assert [list(d) + [ds] for d, ds in zip(dims, reader.level_downsamples)] == \
            want["levels"]
        assert [sha256(reader.read_region((0, 0), level, d))
                for level, d in enumerate(dims)] == want["sha256"]
    if name == CORE:
        assert sha256(tma_core_reference(path)) == want[f"tma_core_{TMA_SIZE}"]
        assert sha256(tma_core(path, TMA_SIZE)) == want[f"tma_core_{TMA_SIZE}"]


def test_open_slide_routes_by_extension(tmp):
    path = os.path.join(DATA, CORE)
    reader = open_slide(path)
    assert type(reader) is ImageSlideReader
    np.testing.assert_array_equal(reader.read_region((0, 0), 0, reader.dimensions),
                                  np.asarray(Image.open(path).convert("RGB")))
    mirrored = ImageSlideReader(path, mirror_bgr=True)
    np.testing.assert_array_equal(mirrored.read_region((5, 9), 0, (30, 20)),
                                  reader.read_region((5, 9), 0, (30, 20))[..., ::-1])
    for name in PYRAMIDS:
        assert type(open_slide(os.path.join(DATA, name))) is CTileReader
    for ext in (".bmp", ""):
        with pytest.raises(ValueError, match="no slide reader"):
            open_slide(str(tmp / f"slide{ext}"))


# -- cohorts: the sampler and -ef against the JAX package -----------------------------------

TILE = 32


def write_formats_cohort(root: str, dataset: str, kind: str) -> str:
    """A cohort of four slides under ``root``: ``kind`` "svs" (YCbCr JPEG
    tiles, two levels) or "tma" (JPEG cores); grids for --mag 20 and 10 from
    the port's ``build_tissue_grid`` over the port's reader."""
    cohort = get_datasets_dir_dict(dataset, data_root=root)[dataset.split("_")[0]
                                                             if dataset == "TCGA" else dataset]
    os.makedirs(cohort, exist_ok=True)
    files, rows = [], {20: [], 10: []}
    for i in range(4):
        img = tissue(192 + 32 * i, 256, 10 + i)
        if kind == "svs":
            name = f"slide_{i}.svs"
            write_tiff(os.path.join(cohort, name), [
                dict(img=img, tile=64, compression=7, photometric=6, quality=85),
                dict(img=img[::2, ::2], tile=64, compression=7, photometric=6, subfile=1)])
        else:
            name = f"core_{i}.jpg"
            Image.fromarray(img).save(os.path.join(cohort, name), quality=85)
        files.append(name)
        reader = open_slide(os.path.join(cohort, name))
        for mag in rows:
            grid = t_grids.build_tissue_grid(reader, TILE * 20 // mag, preview_downsample=4)
            t_grids.save_grid_pickle(t_grids.grid_file_path(cohort, name, mag, TILE), grid)
            rows[mag].append(len(grid))
    for mag, n in rows.items():
        total, legit = t_grids.grid_data_columns(TILE, mag)
        write_xlsx(os.path.join(cohort, f"Grids_{mag}", "Grid_data.xlsx"),
                   {"file": files, total: n, legit: n})
    ident = "TCGA" if dataset == "TCGA" else dataset
    write_xlsx(os.path.join(cohort, f"slides_data_{ident}.xlsx"), {
        "file": files, "id": [ident] * 4, "patient barcode": [f"p{i}" for i in range(4)],
        "ER status": ["Positive", "Negative"] * 2, "test fold idx": [1, 1, 2, 2],
        "Manipulated Objective Power": [20] * 4})
    return cohort


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    roots = {}
    for kind, dataset in (("svs", "TCGA"), ("tma", "TMA_HE_02_008")):
        roots[kind] = str(tmp_path_factory.mktemp(kind))
        write_formats_cohort(roots[kind], dataset, kind)
    return roots


_DATASET = {"svs": "TCGA", "tma": "TMA_HE_02_008"}


@pytest.mark.parametrize("kind", ["svs", "tma"])
def test_sampler_batches_match_jax(cohorts, kind):
    from tpuwsi.io.metadata import load_slide_table as j_load_slide_table

    kw = dict(tile_size=TILE, train=True, train_type="REG", desired_magnification=10,
              test_fold=2, n_tiles=2)
    jt = j_load_slide_table(_DATASET[kind], data_root=cohorts[kind], **kw)
    tt = load_slide_table(_DATASET[kind], data_root=cohorts[kind], **kw)
    js, ts = JWSITileSampler(jt, n_tiles=3), WSITileSampler(tt, n_tiles=3, num_threads=3)
    try:
        for epoch in range(2):
            want = list(js.batches(np.random.default_rng(epoch), 4))
            got = list(ts.batches(np.random.default_rng(epoch), 4))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g["images"], w["images"])
                np.testing.assert_array_equal(g["labels"], w["labels"])
    finally:
        ts.close()
    if kind == "tma":  # the whole core, resized by PIL's bilinear filter, as the JAX branch
        core = os.path.join(get_datasets_dir_dict(_DATASET[kind], data_root=cohorts[kind])[
            _DATASET[kind]], "core_0.jpg")
        np.testing.assert_array_equal(tma_core(core, TILE), tma_core_reference(core, TILE))


EF_ARGV = ["-ef", "--model", "vit_tiny_patch8_224", "--tile-size", str(TILE), "-nt", "6",
           "-tpi", "4", "--workers", "2", "--mag", "20"]


@pytest.mark.parametrize("kind", ["svs", "tma"])
def test_extract_features_main_matches_jax_main(cohorts, kind, tmp_path, monkeypatch):
    """Both packages' ``main -ef`` over the cohort, the port started from the
    JAX run's initial weights; a TMA cohort is normalized with 'Amir'."""
    import tpuwsi.train as jtrain
    from tpuwsi.cli.train import main as jmain
    from tpuwsi_torch.cli import train as ttrain

    _tiny_models(monkeypatch)
    init, banks = {}, []
    real_create = jtrain.create_train_state

    def recording(params, *a, **kw):
        init.setdefault("params", jax.device_get(params))
        return real_create(params, *a, **kw)

    real_recipe = ttrain.make_recipe

    def noting(*a, norm_type="Ron", **kw):
        banks.append(norm_type)
        return real_recipe(*a, norm_type=norm_type, **kw)

    monkeypatch.setattr(jtrain, "create_train_state", recording)
    monkeypatch.setattr(ttrain, "init_dino_weights",
                        lambda model, seed: model.load_state_dict(params_from_flax(init["params"])))
    monkeypatch.setattr(ttrain, "make_recipe", noting)
    argv = EF_ARGV + ["--dataset", _DATASET[kind], "--data-root", cohorts[kind]]
    want = jmain(argv + ["--output", str(tmp_path / "j")])
    got = ttrain.main(argv + ["--output", str(tmp_path / "t")], device=CPU)
    assert set(banks) == {"Amir" if kind == "tma" else "Ron"}
    assert [r.slide_name for r in got.results] == [r.slide_name for r in want.results]
    assert len(got.results) == 2
    for g, w in zip(got.results, want.results):
        assert g.tile_locations == w.tile_locations
        np.testing.assert_allclose(g.features, w.features, **TOL)
        np.testing.assert_allclose(g.tile_probs, w.tile_probs, **TOL)
