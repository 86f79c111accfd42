"""The port's slide walker, tile sampler and WSI entry points held against
the JAX package's on a tiny TCGA-layout cohort.

Five PNG slides of 192 x 256 px (objective power 20, one 40) in test folds 1
and 2, their tissue grids at 32-px tiles for ``--mag`` 20 and 10, and the
cohort's ``slides_data_TCGA.xlsx`` and ``Grid_data.xlsx``:

- ``SlideWalker.walk()`` chunk by chunk and field by field, with crops and
  resizes (2x and 4x), short and long budgets, ``resume_slide``, and the
  replay of saved locations; the resume CSVs' bytes;
- ``WSITileSampler.batches`` over two epochs, as is, with ``process_count``
  2, with ``balanced_sampling``, with MIL bags and with ``loan``;
- ``-ef`` over the table (fp32 ViT, depth 2, weights carried by
  ``params_from_flax``): features, probabilities, slide scores and
  ``inference.data`` at 1e-4 against the JAX walker and feature step;
  ``evaluate_slide_table`` against the JAX ``evaluate_slides``, single and
  multi-target;
- ``main -ef`` and WSI-mode ``main --ssl`` on the CPU, and the refusals.
"""

import dataclasses
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpuwsi.infer import SlideAggregator as JSlideAggregator
from tpuwsi.infer import SlideWalker as JSlideWalker
from tpuwsi.io.metadata import load_slide_table as j_load_slide_table
from tpuwsi.io.wsi import WSITileSampler as JWSITileSampler
from tpuwsi_torch.infer.slide_walker import SlideWalker
from tpuwsi_torch.io import grids as t_grids
from tpuwsi_torch.io.cohorts import get_datasets_dir_dict
from tpuwsi_torch.io.metadata import load_slide_table
from tpuwsi_torch.io.slide_readers import ImageSlideReader
from tpuwsi_torch.io.wsi import WSITileSampler
from tpuwsi_torch.utils.minixlsx import write_xlsx

CPU = torch.device("cpu")
TILE = 32
OBJECTIVE = [20, 20, 40, 20, 20]
FOLDS = [1, 1, 1, 2, 2]
ER = ["Positive", "Negative", "Positive", "Negative", "Positive"]
PR = ["Negative", "Negative", None, "Positive", "Positive"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _slide(seed: int) -> np.ndarray:
    """Mostly tissue: coloured blobs on near-white, with noise."""
    rng = np.random.default_rng(seed)
    h, w = 192, 256
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.full((h, w, 3), 242.0)
    for _ in range(9):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(50, 90)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(60, 200, 3)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


def write_cohort(root: str) -> str:
    """The cohort under ``root`` (``--data-root``); → its directory."""
    cohort = get_datasets_dir_dict("TCGA", data_root=root)["TCGA"]
    os.makedirs(cohort, exist_ok=True)
    files = [f"slide_{i}.png" for i in range(len(OBJECTIVE))]
    grid_rows = {}
    for i, name in enumerate(files):
        img = _slide(i)
        Image.fromarray(img).save(os.path.join(cohort, name))
        reader = ImageSlideReader(img)
        for mag in (20, 10):
            grid = t_grids.build_tissue_grid(reader, TILE * OBJECTIVE[i] // mag,
                                             preview_downsample=4)
            t_grids.save_grid_pickle(t_grids.grid_file_path(cohort, name, mag, TILE), grid)
            grid_rows.setdefault(mag, []).append((len(grid), len(grid)))
    for mag, rows in grid_rows.items():
        total, legit = t_grids.grid_data_columns(TILE, mag)
        write_xlsx(os.path.join(cohort, f"Grids_{mag}", "Grid_data.xlsx"),
                   {"file": files, total: [r[0] for r in rows], legit: [r[1] for r in rows]})
    write_xlsx(os.path.join(cohort, "slides_data_TCGA.xlsx"), {
        "file": files, "id": ["TCGA"] * len(files),
        "patient barcode": [f"patient_{i}" for i in range(len(files))],
        "ER status": ER, "PR status": PR, "test fold idx": FOLDS,
        "Manipulated Objective Power": OBJECTIVE,
    })
    return cohort


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these CPU runs are tiny, and the test runner's
    other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cohort_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohort"))
    write_cohort(root)
    return root


def _tables(root, **kw):
    kw = dict(dict(tile_size=TILE, train=False, train_type="Infer", infer_folds=[1],
                   desired_magnification=20), **kw)
    return (j_load_slide_table("TCGA", data_root=root, **kw),
            load_slide_table("TCGA", data_root=root, **kw))


def _assert_same_chunk(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
        else:
            assert g == w, f.name


# -- the walker ----------------------------------------------------------------

@pytest.mark.parametrize("mag,tpi,budget,resume,ahead", [
    (20, 7, 10, 0, 0), (20, 500, 500, 0, 2), (10, 4, 500, 1, 1), (10, 500, 3, 0, 0)])
def test_slide_walker_matches_jax(cohort_root, mag, tpi, budget, resume, ahead):
    jt, tt = _tables(cohort_root, desired_magnification=mag)
    assert len(tt) == 3
    jw = JSlideWalker(jt, tiles_per_iter=tpi, num_tiles=budget, resume_slide=resume,
                      rng=np.random.default_rng(4))
    tw = SlideWalker(tt, tiles_per_iter=tpi, num_tiles=budget, resume_slide=resume,
                     rng=np.random.default_rng(4), threads=ahead)
    assert tw.open_ahead == ahead
    assert len(tw) == len(jw) and tw.num_tiles == jw.num_tiles
    assert tw.slides_with_not_enough == jw.slides_with_not_enough
    want, got = list(jw.walk()), list(tw.walk())
    assert len(got) == len(want) == len(tw)
    for g, w in zip(got, want):
        _assert_same_chunk(g, w)
    assert (tw.stats.tiles_read, tw.stats.read_failures) == \
        (jw.stats.tiles_read, jw.stats.read_failures)
    assert tw.seconds["open"] > 0 and tw.seconds["walk"] > 0
    if ahead:  # a consumer that stops early leaves no thread behind
        walk = tw.walk()
        next(walk)
        walk.close()


def test_patch_locations_csv_bytes_and_replay(cohort_root, tmp_path):
    jt, tt = _tables(cohort_root)
    locs = {}
    for c in SlideWalker(tt, tiles_per_iter=500, num_tiles=9).walk():
        locs.setdefault(c.slide_name, []).extend(c.locations)
    locs[tt.file_names[1]] = locs[tt.file_names[1]][:5]  # a short row: padded columns
    JSlideWalker(jt).save_patch_locations(str(tmp_path / "j"), locs)
    SlideWalker(tt).save_patch_locations(str(tmp_path / "t"), locs)
    for name in ("patch_locs_x.csv", "patch_locs_y.csv"):
        got = (tmp_path / "t" / name).read_bytes()
        assert got == (tmp_path / "j" / name).read_bytes()
    assert b",\n" in (tmp_path / "t" / "patch_locs_x.csv").read_bytes()
    # each package replays the other's files; a larger budget replays what was saved
    for budget in (9, 500, 3):
        for jdir, tdir in (("j", "t"), ("t", "j")):
            want = list(JSlideWalker(jt, num_tiles=budget, tiles_per_iter=4,
                                     patch_dir=str(tmp_path / jdir)).walk())
            got = list(SlideWalker(tt, num_tiles=budget, tiles_per_iter=4,
                                   patch_dir=str(tmp_path / tdir)).walk())
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _assert_same_chunk(g, w)
    (tmp_path / "t" / "extra_x.csv").write_text("slide_name,0\n")
    with pytest.raises(IOError, match="ambiguous"):
        SlideWalker(tt, patch_dir=str(tmp_path / "t"))
    os.remove(tmp_path / "t" / "extra_x.csv")
    SlideWalker(tt).save_patch_locations(str(tmp_path / "short"), {tt.file_names[0]: [(1, 2)]})
    with pytest.raises(IOError, match="missing"):
        list(SlideWalker(tt, patch_dir=str(tmp_path / "short")).walk())


# -- the sampler ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "two_processes", "balanced", "mil", "loan"])
def test_sampler_batches_match_jax(cohort_root, case, tmp_path):
    kw = dict(train=True, train_type="REG", n_tiles=4, desired_magnification=10,
              infer_folds=(None,), test_fold=3)
    jt, tt = _tables(cohort_root, **kw)
    assert len(tt) == 4  # slide_2 has two tiles at --mag 10
    bag = 3 if case == "mil" else 1
    if case == "loan":  # a mask beside slide 0 only
        mask = np.zeros((24, 32, 3), np.uint8)
        mask[:12, :16, 0] = 250
        d = os.path.join(os.path.dirname(tt.slide_path(0)), "local_labels")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(mask).save(os.path.join(d, "slide_0-labels.png"))
    samplers = [cls(table, n_tiles=4, bag_size=bag, num_threads=3,
                    balanced_sampling=case == "balanced", loan=case == "loan")
                for cls, table in ((JWSITileSampler, jt), (WSITileSampler, tt))]
    assert len(samplers[1]) == len(samplers[0])
    pcount = 2 if case == "two_processes" else 1
    try:
        for epoch in range(2):
            for p in range(pcount):
                want, got = [list(s.batches(np.random.default_rng(10 + epoch), 3,
                                            process_index=p, process_count=pcount))
                             for s in samplers]
                assert len(got) == len(want) > 0
                for g, w in zip(got, want):
                    assert g.keys() == w.keys()
                    for k in w:
                        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        if case == "loan":
            assert got[0]["labels"].min() >= -1
        one = [s.sample_slide(2, np.random.default_rng(1), 2) for s in samplers]
        assert np.array_equal(one[1][0] if case == "loan" else one[1],
                              one[0][0] if case == "loan" else one[0])
    finally:
        samplers[1].close()
        if case == "loan":
            os.remove(os.path.join(d, "slide_0-labels.png"))


# -- -ef and slide evaluation against the JAX package ------------------------------

NAME, DEPTH = "vit_small_patch8_224", 2


@pytest.fixture(scope="module")
def jax_model():
    from tpuwsi.models.registry import create_model as j_create_model
    from tpuwsi.models.vit import VisionTransformer as JViT

    base = j_create_model(NAME, num_classes=4, img_size=TILE, dtype=jnp.float32)
    cfg = dataclasses.replace(base.config, depth=DEPTH, pallas_interpret=True)
    model = JViT(cfg)
    variables = jax.device_get(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, TILE, TILE, 3), jnp.float32)))
    return model, cfg, variables


def _port_model(variables, num_classes=4):
    from tpuwsi_torch.models.convert import params_from_flax
    from tpuwsi_torch.models.registry import create_model

    model = create_model(NAME, num_classes=num_classes, img_size=TILE, dtype=torch.float32)
    return type(model)(dataclasses.replace(model.config, depth=DEPTH)), params_from_flax(variables)


def test_extract_features_over_the_table_matches_jax(cohort_root, jax_model, tmp_path):
    from tpuwsi.models.vit import VisionTransformer as JViT
    from tpuwsi.preprocess import make_recipe as j_make_recipe
    from tpuwsi_torch.cli.train import extract_features

    model, cfg, variables = jax_model
    feat_model = JViT(dataclasses.replace(cfg, num_classes=0))
    params = variables["params"]
    feat_vars = {"params": {k: v for k, v in params.items() if k != "head"}}
    w_h, b_h = params["head"]["kernel"], params["head"]["bias"]
    norm = j_make_recipe("none", train=False, tile_size=TILE)

    @jax.jit
    def feat_probs_step(images):
        feats = feat_model.apply(feat_vars, norm(jax.random.PRNGKey(0), images))
        logits = feats.astype(jnp.float32) @ w_h + b_h
        return jax.nn.softmax(logits, axis=-1), feats

    jt, tt = _tables(cohort_root, desired_magnification=10)
    ref = JSlideAggregator(extract_features=True)
    for chunk in JSlideWalker(jt, tiles_per_iter=5, num_tiles=8).walk():
        probs, feats = feat_probs_step(jnp.asarray(chunk.images))
        ref.add_chunk(chunk, np.asarray(probs), np.asarray(feats))
    ref.save_inference_data(str(tmp_path / "jax.data"))

    tmodel, tparams = _port_model(variables)
    agg = extract_features(SlideWalker(tt, tiles_per_iter=5, num_tiles=8).walk(), tmodel,
                           tparams, str(tmp_path), CPU, dispatch_ahead=2)
    assert [r.slide_name for r in agg.results] == [r.slide_name for r in ref.results]
    for got, want in zip(agg.results, ref.results):
        np.testing.assert_allclose(got.features, want.features, **TOL)
        np.testing.assert_allclose(got.tile_probs, want.tile_probs, **TOL)
        np.testing.assert_allclose(got.slide_score, want.slide_score, **TOL)
        assert got.tile_locations == want.tile_locations
    with open(tmp_path / "features" / "inference.data", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax.data", "rb") as f:
        want = pickle.load(f)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_allclose(g, w, equal_nan=True, **TOL)
        else:
            assert g == w


def _serving_args(root, target):
    return types.SimpleNamespace(
        dataset="TCGA", tile_size=TILE, target=target, test_fold=1, mag=20, data_root=root,
        tiles_per_iter=6, n_patches_test=9, eval_steps_per_dispatch=1, dispatch_ahead=2,
        workers=2)


@pytest.mark.parametrize("target", ["ER", "ER+PR"])
def test_evaluate_slide_table_matches_jax(cohort_root, jax_model, target):
    from tpuwsi.cli.train import evaluate_slides as j_evaluate_slides
    from tpuwsi.preprocess import make_recipe as j_make_recipe
    from tpuwsi.train.supervised import make_eval_step as j_make_eval_step
    from tpuwsi_torch.cli.train import evaluate_slide_table

    model, _, variables = jax_model
    norm = j_make_recipe("none", train=False, tile_size=TILE)
    step = j_make_eval_step(model.apply,
                            preprocess_fn=lambda im: norm(jax.random.PRNGKey(0), im))
    state = types.SimpleNamespace(params=variables, ema_params=None, batch_stats=None)
    args = _serving_args(cohort_root, target)
    jitted = jax.jit(lambda images: step(state, {"images": images}))
    want_metrics, want = j_evaluate_slides(args, state, lambda _, b: jitted(b["images"]))
    tmodel, tparams = _port_model(variables)
    got_metrics, got = evaluate_slide_table(args, tmodel, tparams, CPU)
    assert got_metrics.keys() == want_metrics.keys()
    for k in want_metrics:
        np.testing.assert_allclose(got_metrics[k], want_metrics[k], **TOL)
    assert [r.slide_name for r in got.results] == [r.slide_name for r in want.results]
    for g, w in zip(got.results, want.results):
        np.testing.assert_allclose(g.tile_probs, w.tile_probs, **TOL)
        assert g.label == w.label and g.tile_locations == w.tile_locations


# -- main on the CPU -----------------------------------------------------------------

EF_ARGV = ["-ef", "--dataset", "TCGA", "--model", "vit_tiny_patch8_224", "--tile-size",
           str(TILE), "-nt", "10", "-tpi", "8", "--workers", "2"]
SSL_ARGV = ["--ssl", "--dataset", "TCGA", "--model", "vit_tiny_patch16_224", "-b", "4",
            "--tile-size", str(TILE), "--n_patches_train", "4", "--epochs", "1",
            "--max-steps-per-epoch", "2", "--warmup-epochs", "0", "--lr", "1e-4",
            "--dino-out-dim", "64", "--dino-global-size", "32", "--dino-local-size", "16",
            "--dino-local-crops", "2", "--workers", "2"]


def _run_dir(out):
    return next(os.path.join(out, d) for d in os.listdir(out) if d.startswith("Exp_"))


@pytest.mark.parametrize("mag", ["20", "10"])
def test_main_extracts_features_on_cpu(cohort_root, tmp_path, mag):
    from tpuwsi_torch.cli.train import main

    out = str(tmp_path / "runs")
    agg = main(EF_ARGV + ["--data-root", cohort_root, "--mag", mag, "--output", out],
               device=CPU)
    feat_dir = os.path.join(_run_dir(out), "features")
    assert sorted(os.listdir(feat_dir)) == ["inference.data", "slide_0_features.pt",
                                            "slide_1_features.pt", "slide_2_features.pt"]
    n = [10, 10, 10] if mag == "20" else [10, 10, 2]  # slide_2: two tiles at --mag 10
    assert [r.features.shape for r in agg.results] == [(k, 192) for k in n]
    assert all(np.isfinite(r.features).all() for r in agg.results)
    saved = torch.load(os.path.join(feat_dir, "slide_0_features.pt"), weights_only=False)
    assert saved is not None
    for name in ("log.txt", "run_data.jsonl"):
        assert os.path.isfile(os.path.join(out, name))


def test_main_trains_wsi_mode_ssl_on_cpu(cohort_root, tmp_path):
    from tpuwsi_torch.cli.train import main

    out = str(tmp_path / "runs")
    losses = []
    state = main(SSL_ARGV + ["--data-root", cohort_root, "--mag", "10", "--output", out,
                             "--log-interval", "1", "-time"], device=CPU)
    assert state.step == 2
    run = _run_dir(out)
    assert os.listdir(os.path.join(run, "checkpoints")) == ["2"]
    with open(os.path.join(out, "log.txt")) as f:
        log = f.read()
    losses = [float(line.split(" loss ")[1].split()[0]) for line in log.splitlines()
              if "ssl epoch 0 step" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    # -time: the sampler's stage times, one line an epoch
    timed = [line for line in log.splitlines() if "ssl epoch 0 time dict" in line]
    assert len(timed) == 1
    assert float(timed[0].split("'Average time to extract a tile': ")[1].split(",")[0]) > 0


@pytest.mark.parametrize("extra,item", [
    (["--data-dir", "x"], "M3b"),
    (["--model-ema"], "M8"), (["--quantize", "int8"], "M8"),
])
def test_extract_features_refusals(cohort_root, tmp_path, extra, item):
    from tpuwsi_torch.cli.train import main

    out = tmp_path / "runs"
    with pytest.raises(NotImplementedError, match=item):
        main(EF_ARGV + ["--data-root", cohort_root, "--output", str(out)] + extra, device=CPU)
    assert not out.exists()


def test_unreadable_slide_formats_are_refused_before_any_file(cohort_root, tmp_path):
    """Slides in JPEG 2000 (M1c) are refused when the table is checked."""
    from jp2k_fixture import write_jp2k_svs

    from tpuwsi_torch.cli.train import main
    from tpuwsi_torch.utils.minixlsx import read_xlsx

    root = str(tmp_path / "svs")
    cohort = write_cohort(root)
    path = os.path.join(cohort, "slides_data_TCGA.xlsx")
    table = read_xlsx(path)
    table["file"] = [f.replace(".png", ".svs") for f in table["file"]]
    write_xlsx(path, table)
    for name in table["file"]:
        write_jp2k_svs(os.path.join(cohort, name), _slide(0)[:64, :64], tile=64)
    for mag in (20, 10):
        grid = read_xlsx(os.path.join(cohort, f"Grids_{mag}", "Grid_data.xlsx"))
        grid["file"] = table["file"]
        write_xlsx(os.path.join(cohort, f"Grids_{mag}", "Grid_data.xlsx"), grid)
    for argv in (EF_ARGV, SSL_ARGV):
        out = tmp_path / "runs"
        with pytest.raises(NotImplementedError, match="M1c"):
            main(argv + ["--data-root", root, "--output", str(out)], device=CPU)
        assert not out.exists()
