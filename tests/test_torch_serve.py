"""The port's serving slice held against the JAX package's own pieces.

Synthetic padded chunks of uint8 32-px tiles (two slides, labels 0 and 1;
one chunk partly masked) go through ``tpuwsi_torch.cli.train``'s
``extract_features`` and ``evaluate_slides`` on the CPU, and through
``make_recipe("none")`` → flax ViT (Pallas attention in interpret mode) →
``feats @ W + b`` → softmax → ``tpuwsi.infer.SlideAggregator``. fp32 on
both sides; tolerance 1e-4 on features and probabilities.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuwsi.infer import SlideAggregator
from tpuwsi.models.registry import create_model as j_create_model
from tpuwsi.models.vit import VisionTransformer as JViT
from tpuwsi.preprocess import make_recipe as j_make_recipe
from tpuwsi.train.supervised import make_eval_step as j_make_eval_step
from tpuwsi_torch.cli.train import evaluate_slides, extract_features
from tpuwsi_torch.infer.slide_walker import InferChunk
from tpuwsi_torch.models.convert import params_from_flax
from tpuwsi_torch.models.registry import create_model
from tpuwsi_torch.ops import attention as tattn
from tpuwsi_torch.preprocess.recipes import make_recipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME, TILE, TPI, DEPTH = "vit_small_patch8_224", 32, 6, 2
TOL = dict(atol=1e-4, rtol=1e-4)


def _chunks():
    """Slide a (label 0): 6 + 3 valid tiles; slide b (label 1): 6 tiles."""
    rng = np.random.default_rng(0)
    chunks = []
    for index, (name, label, counts) in enumerate(
            [("a.svs", 0, (6, 3)), ("b.svs", 1, (6,))]):
        total = sum(counts)
        for i, k in enumerate(counts):
            images = rng.integers(0, 256, (TPI, TILE, TILE, 3), dtype=np.uint8)
            # tiles of the label-1 slide are brighter: distinct slide scores
            images[:k] = np.clip(images[:k].astype(int) + 40 * label, 0, 255)
            chunks.append(InferChunk(
                images=images, mask=np.arange(TPI) < k, label=np.array([label]),
                slide_index=index, slide_name=name, patient_barcode=name[0],
                slide_dataset="synthetic", initial_num_tiles=total,
                is_last_batch=i == len(counts) - 1,
                locations=[(i * TPI + j, j) for j in range(k)]))
    return chunks


@pytest.fixture(scope="module")
def jax_slice(tmp_path_factory):
    """The JAX package's serving pieces on the same chunks."""
    base = j_create_model(NAME, num_classes=2, img_size=TILE, dtype=jnp.float32)
    cfg = dataclasses.replace(base.config, depth=DEPTH, pallas_interpret=True)
    model = JViT(cfg)
    feat_model = JViT(dataclasses.replace(cfg, num_classes=0))
    variables = jax.device_get(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, TILE, TILE, 3), jnp.float32)))
    params = variables["params"]
    feat_vars = {"params": {k: v for k, v in params.items() if k != "head"}}
    w_h, b_h = params["head"]["kernel"], params["head"]["bias"]
    norm = j_make_recipe("none", train=False, tile_size=TILE)

    @jax.jit
    def feat_probs_step(images):
        feats = feat_model.apply(feat_vars, norm(jax.random.PRNGKey(0), images))
        logits = feats.astype(jnp.float32) @ w_h + b_h
        return jax.nn.softmax(logits, axis=-1), feats

    step = j_make_eval_step(
        model.apply, preprocess_fn=lambda im: norm(jax.random.PRNGKey(0), im))
    state = types.SimpleNamespace(params=variables, ema_params=None, batch_stats=None)
    eval_step = jax.jit(lambda images: step(state, {"images": images}))

    feat_agg, eval_agg = SlideAggregator(extract_features=True), SlideAggregator()
    for chunk in _chunks():
        probs, feats = feat_probs_step(jnp.asarray(chunk.images))
        feat_agg.add_chunk(chunk, np.asarray(probs), np.asarray(feats))
        _, probs = eval_step(jnp.asarray(chunk.images))
        eval_agg.add_chunk(chunk, np.asarray(probs))
    data = str(tmp_path_factory.mktemp("jax") / "inference.data")
    feat_agg.save_inference_data(data)
    return variables, feat_agg, eval_agg, data


def _port_model(variables, **kw):
    model = create_model(NAME, num_classes=2, img_size=TILE, dtype=torch.float32, **kw)
    cfg = dataclasses.replace(model.config, depth=DEPTH)
    return type(model)(cfg), params_from_flax(variables)


def test_extract_features_matches_jax(jax_slice, tmp_path):
    variables, ref, _, ref_data = jax_slice
    model, params = _port_model(variables)
    before = tattn.LAUNCHES
    agg = extract_features(_chunks(), model, params, str(tmp_path), torch.device("cpu"),
                           dispatch_ahead=2)
    assert tattn.LAUNCHES == before
    assert [r.slide_name for r in agg.results] == [r.slide_name for r in ref.results]
    for got, want in zip(agg.results, ref.results):
        np.testing.assert_allclose(got.features, want.features, **TOL)
        np.testing.assert_allclose(got.tile_probs, want.tile_probs, **TOL)
        np.testing.assert_allclose(got.slide_score, want.slide_score, **TOL)
        assert got.tile_locations == want.tile_locations
    assert agg.slide_auc() == ref.slide_auc()
    feat_dir = tmp_path / "features"
    assert sorted(os.listdir(feat_dir)) == ["a_features.pt", "b_features.pt", "inference.data"]
    with open(feat_dir / "inference.data", "rb") as f:
        got = pickle.load(f)
    with open(ref_data, "rb") as f:
        want = pickle.load(f)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_allclose(g, w, equal_nan=True, **TOL)
        else:
            assert g == w


def test_extract_features_with_fused_mlp_matches_jax(jax_slice, tmp_path, monkeypatch):
    """The same slice with ``use_fused_mlp``: every block's MLP sub-block goes
    through ``fused_mlp_block`` (its plain version here) and the features
    still agree with the JAX package's."""
    from tpuwsi_torch.models import vit as tvit

    variables, ref, _, _ = jax_slice
    model, params = _port_model(variables, use_fused_mlp=True)
    assert model.config.use_fused_mlp
    calls = []
    real = tvit.fused_mlp_block
    monkeypatch.setattr(tvit, "fused_mlp_block",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    agg = extract_features(_chunks(), model, params, str(tmp_path), torch.device("cpu"))
    assert calls == [(TPI, 17, 384)] * (DEPTH * len(_chunks()))
    for got, want in zip(agg.results, ref.results):
        np.testing.assert_allclose(got.features, want.features, **TOL)
        np.testing.assert_allclose(got.tile_probs, want.tile_probs, **TOL)


def test_fused_mlp_model_round_trips_through_the_converters(jax_slice):
    """``params_from_flax`` → a model with the fused route → ``params_to_flax``
    gives back the tree it was given: the route adds and renames nothing."""
    from tpuwsi_torch.models.convert import params_to_flax

    variables = jax_slice[0]
    model, params = _port_model(variables, use_fused_mlp=True)
    model.load_state_dict(params)
    back = params_to_flax(model.state_dict())["params"]
    want = jax.tree_util.tree_map(np.asarray, variables["params"])
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    assert tree_b == tree_w
    for a, b in zip(flat_b, flat_w):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_evaluate_slides_matches_jax(jax_slice):
    variables, _, ref, _ = jax_slice
    model, params = _port_model(variables)
    metrics, agg = evaluate_slides(_chunks(), model, params, torch.device("cpu"))
    assert metrics == {"auc": ref.slide_auc(), "patch_auc": ref.patch_auc()}
    for got, want in zip(agg.results, ref.results):
        np.testing.assert_allclose(got.tile_probs, want.tile_probs, **TOL)


@pytest.mark.parametrize("norm_type", ["Ron", "Amir", "TCGA"])
def test_eval_recipe_matches_jax(norm_type):
    images = np.random.default_rng(5).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    ref = j_make_recipe("cbnfrsc", train=False, norm_type=norm_type)(
        jax.random.PRNGKey(0), jnp.asarray(images))
    out = make_recipe("cbnfrsc", train=False, norm_type=norm_type)(torch.from_numpy(images))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_train_recipe_is_not_ported_yet():
    # the named recipes train since the supervised slice; the timm stack does not
    with pytest.raises(NotImplementedError, match="M3b"):
        make_recipe("timm", train=True)


# A TCGA-layout cohort of four 96 x 128 PNG slides (test folds 1 and 2) written
# with the port's own writers, for -ef and WSI-mode --ssl in the subprocesses.
_COHORT = """
import os, struct, tempfile, zlib
import numpy as np, torch
torch.set_num_threads(1)  # tiny runs; the test runner's other workers share the cores
from tpuwsi_torch.io import grids
from tpuwsi_torch.io.cohorts import get_datasets_dir_dict
from tpuwsi_torch.io.slide_readers import ImageSlideReader
from tpuwsi_torch.utils.minixlsx import write_xlsx

def png(img):
    h, w, _ = img.shape
    raw = b"".join(b"\\x00" + img[r].tobytes() for r in range(h))
    chunk = lambda k, b: struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b))
    return (b"\\x89PNG\\r\\n\\x1a\\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))

root = tempfile.mkdtemp()
cohort = get_datasets_dir_dict("TCGA", data_root=root)["TCGA"]
os.makedirs(cohort)
rng = np.random.default_rng(0)
files = [f"s{i}.png" for i in range(4)]
counts = {20: [], 10: []}
for name in files:
    img = rng.integers(0, 200, (96, 128, 3), dtype=np.uint8)
    open(os.path.join(cohort, name), "wb").write(png(img))
    for mag in counts:
        grid = grids.build_tissue_grid(ImageSlideReader(img), 16 * 20 // mag)
        grids.save_grid_pickle(grids.grid_file_path(cohort, name, mag, 16), grid)
        counts[mag].append(len(grid))
for mag, n in counts.items():
    total, legit = grids.grid_data_columns(16, mag)
    write_xlsx(os.path.join(cohort, f"Grids_{mag}", "Grid_data.xlsx"),
               {"file": files, total: n, legit: n})
write_xlsx(os.path.join(cohort, "slides_data_TCGA.xlsx"), {
    "file": files, "id": ["TCGA"] * 4, "patient barcode": ["a", "b", "c", "d"],
    "ER status": ["Positive", "Negative"] * 2, "test fold idx": [1, 1, 2, 2],
    "Manipulated Objective Power": [20] * 4})
"""

_BANNED = ("jax", "jaxlib", "flax", "optax", "tpuwsi", "pandas", "PIL", "cv2")

_NO_JAX = _COHORT + """
import sys, tempfile
import numpy as np, torch
import tpuwsi_torch.core.device, tpuwsi_torch.ops._build
from tpuwsi_torch.cli.train import extract_features
from tpuwsi_torch.infer.slide_walker import InferChunk
from tpuwsi_torch.models.registry import create_model
model = create_model("vit_tiny_patch8_224", num_classes=2, img_size=16, dtype=torch.float32)
images = np.zeros((2, 16, 16, 3), np.uint8)
chunk = InferChunk(images, np.array([True, False]), np.array([1]), 0, "s.svs", "p", "d",
                   1, True, [(0, 0)])
with tempfile.TemporaryDirectory() as out:
    agg = extract_features([chunk], model, model.state_dict(), out, torch.device("cpu"))
assert agg.results[0].features.shape == (1, 192)
fused = create_model("vit_tiny_patch8_224", num_classes=2, img_size=16, dtype=torch.float32,
                     use_fused_mlp=True)
with tempfile.TemporaryDirectory() as out:
    agg_f = extract_features([chunk], fused, model.state_dict(), out, torch.device("cpu"))
assert np.allclose(agg_f.results[0].features, agg.results[0].features, atol=1e-4)
from tpuwsi_torch.ops.attention import fused_attention, mha_from_qkv
x = torch.ones(1, 512, 96, requires_grad=True)  # 512 tokens: the tiled flash pair
mha_from_qkv(x, 2).sum().backward()
assert x.grad.shape == x.shape
q = torch.ones(1, 2, 512, 16)
assert fused_attention(q, q, q, kv_lengths=torch.tensor([7])).shape == q.shape
from tpuwsi_torch.cli.train import main
for mag in ("20", "10"):  # crops, then 32-px regions resized to 16
    agg = main(["-ef", "--dataset", "TCGA", "--data-root", root, "--model",
                "vit_tiny_patch8_224", "--tile-size", "16", "-nt", "6", "-tpi", "4", "--mag", mag,
                "--output", os.path.join(root, "ef" + mag)], device=torch.device("cpu"))
    assert [r.features.shape for r in agg.results] == [(6, 192)] * 2
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not bad, bad
""" % (_BANNED,)


def test_port_runs_without_importing_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_NO_JAX_TRAINING = _COHORT + """
import sys
import numpy as np, torch
from tpuwsi_torch.cli.args import parse_args
from tpuwsi_torch.cli.train import ssl_step_bundle
args = parse_args(["--ssl", "--model", "vit_small_patch16_224_dino", "--epochs", "300",
                   "--warmup-epochs", "10", "--opt", "adamw", "--lr-base", "0.0005",
                   "--weight-decay", "0.04", "--dino-out-dim", "64", "--dino-global-size", "32",
                   "--dino-local-size", "16"])
b = ssl_step_bundle(args, 1000, 4, torch.device("cpu"),
                    vit_overrides=dict(patch_size=8, embed_dim=64, depth=2, num_heads=2,
                                       attn_save_probs=True))
images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 40, 40, 3),
                                                            dtype=np.uint8))
for _ in range(2):
    state, metrics = b.raw_step(b.state, {"images": images}, b.generator)
assert state.step == 2 and np.isfinite(metrics["loss"].item())
for flags in (dict(use_fused_mlp=True), dict(mlp_pallas_bwd=True)):
    f = ssl_step_bundle(args, 1000, 4, torch.device("cpu"),
                        vit_overrides=dict(patch_size=8, embed_dim=64, depth=2, num_heads=2,
                                           use_kernel_attention=True, **flags))
    state, metrics = f.raw_step(f.state, {"images": images}, f.generator)
    assert state.step == 1 and np.isfinite(metrics["loss"].item())
from tpuwsi_torch.cli.train import main
state = main(["--ssl", "--dataset", "TCGA", "--data-root", root, "--mag", "10", "--tile-size",
              "16", "--n_patches_train", "3", "--model", "vit_tiny_patch8_224", "-b", "2",
              "--epochs", "1", "--max-steps-per-epoch", "2", "--warmup-epochs", "0", "--lr",
              "1e-4", "--dino-out-dim", "64", "--dino-global-size", "16", "--dino-local-size",
              "8", "--dino-local-crops", "2", "--output", os.path.join(root, "ssl")],
             device=torch.device("cpu"))
assert state.step == 2
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not bad, bad
""" % (_BANNED,)


def test_training_slice_runs_without_importing_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_TRAINING], cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
