"""The port's supervised route held against the JAX package's on the CPU.

- the losses and step metrics against ``tpuwsi.train.losses`` and
  ``metrics`` at 1e-6 (smoothing, weights, the -1 mask of multi-target
  labels, the AUC's ties and masks);
- the schedule with an offset, and a 12-step trajectory of
  ``make_train_step`` (fp32 ViT, depth 2, width 64, 32 px; SGD with
  Nesterov momentum and the 1-D no-decay mask under warm-up cosine,
  smoothed CE, EMA at 0.9998) against the JAX step with optax, from the same
  initial weights (``params_from_flax``): parameters, EMA and per-step loss
  at 1e-4; again with --no-grad, where the backbone must keep its bits;
- ``main`` of both packages in WSI mode over the PNG cohort of
  ``test_torch_wsi.py`` (2 epochs of 2 steps, SGD, --model-ema, slide
  evaluation every epoch), the port started from the JAX run's initial
  weights: final parameters and EMA at 1e-4, ``summary.csv``'s columns,
  losses and eval AUC, the ledger's row;
- ``evaluate_folder`` against the JAX one, and folder mode's ``main``;
- checkpoints: --resume continues bit for bit, --recovery-interval keeps the
  latest two, ``-ef --initial-checkpoint`` gives the trained weights'
  features;
- a subprocess that runs the route and loads no jax, flax or tpuwsi module;
- the refusals (ROADMAP.md, M3b), each before any file is written, with the
  JAX CLI's own messages where it refuses first.
"""

import csv
import dataclasses
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_serve import _BANNED, _COHORT, REPO
from test_torch_wsi import write_cohort
from tpuwsi.train import losses as JL
from tpuwsi.train import metrics as JM
from tpuwsi_torch.models.convert import params_from_flax
from tpuwsi_torch.train import losses as TL
from tpuwsi_torch.train import metrics as TM

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
EXACT = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these CPU runs are tiny, and the test runner's
    other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- losses and metrics -------------------------------------------------------------

def _logits_labels(seed, b=9, c=3):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, c)) * 3).astype(np.float32)
    return logits, rng.integers(0, c, b)


LOSS_CASES = {
    "ce": (lambda l, y: JL.cross_entropy(l, y), lambda l, y: TL.cross_entropy(l, y)),
    "ce_smoothed": (lambda l, y: JL.cross_entropy(l, y, 0.1),
                    lambda l, y: TL.cross_entropy(l, y, 0.1)),
    "ce_weights": (lambda l, y: JL.cross_entropy(l, y, 0.2, weights=jnp.arange(9.0)),
                   lambda l, y: TL.cross_entropy(l, y, 0.2, weights=torch.arange(9.0))),
    "bce": (lambda l, y: JL.binary_cross_entropy(l, y),
            lambda l, y: TL.binary_cross_entropy(l, y)),
    "bce_smoothed_thresh": (lambda l, y: JL.binary_cross_entropy(l, y, 0.1, target_thresh=0.2),
                            lambda l, y: TL.binary_cross_entropy(l, y, 0.1, target_thresh=0.2)),
    "focal": (lambda l, y: JL.focal_loss(l, y), lambda l, y: TL.focal_loss(l, y)),
    "focal_alpha": (lambda l, y: JL.focal_loss(l, y, 1.5, alpha=[0.2, 0.3, 0.5]),
                    lambda l, y: TL.focal_loss(l, y, 1.5, alpha=[0.2, 0.3, 0.5])),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches_jax(case):
    jfn, tfn = LOSS_CASES[case]
    logits, labels = _logits_labels(1)
    want = float(jfn(jnp.asarray(logits), jnp.asarray(labels)))
    got = tfn(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, **EXACT)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_multi_target_loss_masks_unknown_labels(smoothing):
    logits, _ = _logits_labels(2, c=6)
    labels = np.random.default_rng(3).integers(-1, 2, (9, 3))
    labels[:, 1] = -1  # a head with no known label at all
    want = float(JL.multi_target_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                               smoothing))
    got = TL.multi_target_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                        smoothing)
    np.testing.assert_allclose(float(got), want, **EXACT)
    none = -np.ones((9, 3), np.int64)
    assert float(TL.multi_target_cross_entropy(torch.from_numpy(logits),
                                               torch.from_numpy(none))) == 0.0


AUC_CASES = {
    "distinct": (np.random.default_rng(4).random(40), None),
    "ties": (np.round(np.random.default_rng(5).random(40) * 4) / 4, None),
    "masked": (np.random.default_rng(6).random(40), np.arange(40) % 3 != 0),
    "ties_masked": (np.round(np.random.default_rng(7).random(40) * 3) / 3,
                    np.arange(40) % 4 != 1),
}


@pytest.mark.parametrize("case", sorted(AUC_CASES))
def test_auc_matches_jax_and_sklearns_rule(case):
    from tpuwsi_torch.infer.aggregate import roc_auc

    scores, mask = AUC_CASES[case]
    scores = scores.astype(np.float32)
    labels = np.random.default_rng(8).integers(0, 2, 40)
    jm = None if mask is None else jnp.asarray(mask)
    want = float(JM.auc_score(jnp.asarray(scores), jnp.asarray(labels), jm))
    got = TM.auc_score(torch.from_numpy(scores), torch.from_numpy(labels),
                       None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), want, **EXACT)
    keep = np.ones(40, bool) if mask is None else mask
    np.testing.assert_allclose(float(got), roc_auc(scores[keep], labels[keep]), **EXACT)


def test_auc_of_one_class_is_a_half():
    scores = torch.rand(6)
    assert float(TM.auc_score(scores, torch.ones(6, dtype=torch.int64))) == 0.5
    mask = torch.tensor([True, True, False, False, False, False])
    assert float(TM.auc_score(scores, torch.tensor([1, 1, 0, 0, 0, 0]), mask)) == 0.5


@pytest.mark.parametrize("k,masked", [(1, False), (2, False), (1, True)])
def test_accuracy_topk_matches_jax(k, masked):
    logits, labels = _logits_labels(9, b=12, c=4)
    logits[3] = logits[3, 0]  # a row of ties: the lower index wins
    mask = np.arange(12) % 5 != 2 if masked else None
    want = float(JM.accuracy_topk(jnp.asarray(logits), jnp.asarray(labels), k,
                                  None if mask is None else jnp.asarray(mask)))
    got = TM.accuracy_topk(torch.from_numpy(logits), torch.from_numpy(labels), k,
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), want, **EXACT)


def test_slide_scores_and_average_meter_match_jax():
    rng = np.random.default_rng(10)
    probs = rng.random(20).astype(np.float32)
    ids = rng.integers(0, 5, 20)
    ids[ids == 3] = 4  # slide 3 has no tile
    mask = rng.random(20) > 0.3
    ws, wh = JM.slide_scores_from_tiles(jnp.asarray(probs), jnp.asarray(ids), 5,
                                        jnp.asarray(mask))
    gs, gh = TM.slide_scores_from_tiles(torch.from_numpy(probs), torch.from_numpy(ids), 5,
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **EXACT)
    assert np.array_equal(gh.numpy(), np.asarray(wh)) and not gh[3]
    jmeter, tmeter = JM.AverageMeter(), TM.AverageMeter()
    for v, n in ((1.0, 2), (4.0, 1), (2.5, 3)):
        jmeter.update(v, n)
        tmeter.update(torch.tensor(v), n)
    assert (tmeter.val, tmeter.sum, tmeter.count, tmeter.avg) == \
        (jmeter.val, jmeter.sum, jmeter.count, jmeter.avg)


# -- the optimizer and the step -------------------------------------------------------

def test_schedule_with_an_offset_matches_jax():
    from tpuwsi.train.optim import OptimConfig as JOptimConfig
    from tpuwsi.train.optim import make_schedule as jmake_schedule
    from tpuwsi_torch.train.optim import OptimConfig, make_schedule

    kw = dict(opt="sgd", epochs=4, warmup_epochs=1, steps_per_epoch=5, warmup_lr=1e-3,
              min_lr=1e-4, schedule_offset_steps=3)
    jsched = jmake_schedule(JOptimConfig(**kw), 0.2)
    tsched = make_schedule(OptimConfig(**kw), 0.2)
    for count in range(22):  # optax reckons in fp32, the port in Python floats
        np.testing.assert_allclose(tsched(count), float(jsched(count)), rtol=1e-5)


B, STEPS = 8, 12
TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2, num_classes=2)


def _jax_tiny():
    from tpuwsi.models.vit import ViTConfig, VisionTransformer

    model = VisionTransformer(ViTConfig(**TINY, dtype=jnp.float32, use_pallas_attention=False))
    return model, model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))


def _port_tiny():
    from tpuwsi_torch.models.vit import ViTConfig, VisionTransformer

    return VisionTransformer(ViTConfig(**TINY, dtype=torch.float32, attn_save_probs=True))


@pytest.mark.parametrize("no_grad", [False, True])
def test_train_step_trajectory_matches_jax(no_grad):
    from tpuwsi.preprocess import make_recipe as j_make_recipe
    from tpuwsi.train import create_train_state as j_create_train_state
    from tpuwsi.train import make_optimizer as j_make_optimizer
    from tpuwsi.train import make_train_step as j_make_train_step
    from tpuwsi.train.optim import OptimConfig as JOptimConfig
    from tpuwsi.train.optim import freeze_non_head as j_freeze_non_head
    from tpuwsi_torch.preprocess.recipes import make_recipe
    from tpuwsi_torch.train.optim import OptimConfig, freeze_non_head, make_optimizer
    from tpuwsi_torch.train.state import create_train_state
    from tpuwsi_torch.train.supervised import make_train_step

    okw = dict(opt="sgd", lr=0.05, momentum=0.9, weight_decay=0.01, epochs=3, warmup_epochs=1,
               steps_per_epoch=4, warmup_lr=1e-3)
    jmodel, variables = _jax_tiny()
    tx, _ = j_make_optimizer(JOptimConfig(**okw), variables, B)
    if no_grad:
        tx = j_freeze_non_head(tx, variables)
    jnorm = j_make_recipe("none", train=True, tile_size=32)
    jstep = jax.jit(j_make_train_step(
        jmodel.apply, tx, augment_fn=jnorm, loss_fn=lambda l, y: JL.cross_entropy(l, y, 0.1),
        ema_decay=0.9998))
    jstate = j_create_train_state(variables, tx, ema=True)

    model = _port_tiny()
    model.load_state_dict(params_from_flax(variables))
    optimizer, _ = make_optimizer(OptimConfig(**okw), B)
    if no_grad:
        freeze_non_head(model)
    state = create_train_state(model, optimizer, ema=True)
    step = make_train_step(model, optimizer, augment_fn=make_recipe("none", train=True),
                           loss_fn=lambda l, y: TL.cross_entropy(l, y, 0.1), ema_decay=0.9998)
    init = {k: v.clone() for k, v in model.state_dict().items()}

    rng = np.random.default_rng(11)
    for i in range(STEPS):
        images = rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
        labels = rng.integers(0, 2, B)
        jstate, jm = jstep(jstate, {"images": jnp.asarray(images),
                                    "labels": jnp.asarray(labels)}, jax.random.PRNGKey(1))
        state, m = step(state, {"images": torch.from_numpy(images),
                                "labels": torch.from_numpy(labels)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
        np.testing.assert_allclose(float(m["acc"]), float(jm["acc"]), **EXACT)
        np.testing.assert_allclose(float(m["auc"]), float(jm["auc"]), **TOL)
    assert state.step == STEPS == int(jstate.step)
    for name, want in (("params", jstate.params), ("ema", jstate.ema_params)):
        got = (state.model if name == "params" else state.ema).state_dict()
        want = params_from_flax(jax.device_get(want))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=f"{name} {k}",
                                       **TOL)
    for k, v in model.state_dict().items():
        if no_grad and not k.startswith("head"):
            assert torch.equal(v, init[k]), k  # the backbone keeps its bits
        elif k.startswith("head"):
            assert not torch.equal(v, init[k]), k


def _assert_same(a, b, where="state"):
    """Two state_dict()s hold the same keys, values and bits."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def test_state_dict_restores_bit_for_bit():
    from tpuwsi_torch.train.optim import OptimConfig, make_optimizer
    from tpuwsi_torch.train.state import create_train_state
    from tpuwsi_torch.train.supervised import make_train_step
    from tpuwsi_torch.preprocess.recipes import make_recipe

    def fresh():
        torch.manual_seed(0)
        model = _port_tiny()
        opt, _ = make_optimizer(OptimConfig(opt="nesterov", lr=0.1, steps_per_epoch=4), B)
        state = create_train_state(model, opt, ema=True,
                                   generator=torch.Generator().manual_seed(3))
        return state, make_train_step(model, opt, augment_fn=make_recipe("pcbnfrs", True),
                                      ema_decay=0.99)

    rng = np.random.default_rng(12)
    batches = [{"images": torch.from_numpy(rng.integers(0, 256, (B, 32, 32, 3), np.uint8)),
                "labels": torch.from_numpy(rng.integers(0, 2, B))} for _ in range(4)]
    a, step_a = fresh()
    for b in batches[:2]:
        step_a(a, b, a.generator)
    b_state, step_b = fresh()
    b_state.load_state_dict(a.state_dict())
    for b in batches[2:]:
        step_a(a, b, a.generator)
        step_b(b_state, b, b_state.generator)
    _assert_same(a.state_dict(), b_state.state_dict())
    assert a.step == b_state.step == 4


# -- main of both packages in WSI mode ------------------------------------------------

MAIN_ARGV = ["--dataset", "TCGA", "--model", "vit_tiny_patch16_224", "--tile-size", "32",
             "-b", "4", "--epochs", "2", "--max-steps-per-epoch", "2", "--warmup-epochs", "1",
             "--opt", "sgd", "--lr", "0.05", "--weight-decay", "0.01", "--model-ema",
             "--eval_rate", "1", "--n_patches_test", "4", "-tpi", "4", "-tf", "1",
             "--mag", "10", "--n_patches_train", "4", "--workers", "2", "--seed", "0",
             "--log-interval", "1", "--transform_type", "none"]


def _tiny_models(monkeypatch):
    """Both packages' create_model: fp32, depth 2."""
    from tpuwsi.models import registry as jregistry
    from tpuwsi.models.vit import VisionTransformer as JViT
    from tpuwsi_torch.models import registry as tregistry

    jreal, treal = jregistry.create_model, tregistry.create_model

    def jcreate(name, **kw):
        kw["dtype"] = jnp.float32
        return JViT(dataclasses.replace(jreal(name, **kw).config, depth=2))

    def tcreate(name, **kw):
        kw["dtype"] = torch.float32
        m = treal(name, **kw)
        return type(m)(dataclasses.replace(m.config, depth=2)).eval()

    monkeypatch.setattr(jregistry, "create_model", jcreate)
    monkeypatch.setattr(tregistry, "create_model", tcreate)


def _run_dir(out):
    return next(os.path.join(out, d) for d in os.listdir(out) if d.startswith("Exp_"))


def _summary(out):
    with open(os.path.join(_run_dir(out), "summary.csv")) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def cohort_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohort"))
    write_cohort(root)
    return root


# folder mode without a val/ split (--val-split's 80/20 split of the 12
# images), BCE with --no-grad under AdamW: 2 epochs of 2 steps
FOLDER_ARGV = ["--model", "vit_tiny_patch16_224", "--img-size", "32", "-b", "4", "--epochs",
               "2", "--warmup-epochs", "0", "--opt", "adamw", "--lr", "1e-2", "--model-ema",
               "--model-ema-decay", "0.5", "--transform_type", "none", "--eval_rate", "1",
               "--workers", "2", "--seed", "0", "--no-grad", "--bce-loss"]


@pytest.fixture(scope="module")
def both_mains(cohort_root, image_folder, tmp_path_factory):
    """The JAX main, then the port's from the JAX run's initial weights: in
    WSI mode over the cohort, and in folder mode over ``image_folder``'s
    train/ tree."""
    import tpuwsi.train as jtrain
    from tpuwsi_torch.cli import train as ttrain

    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("mains")
    runs = {}
    try:
        _tiny_models(mp)
        init = {}
        real_create = jtrain.create_train_state

        def recording(params, *a, **kw):
            init.setdefault("params", jax.device_get(params))
            return real_create(params, *a, **kw)

        mp.setattr(jtrain, "create_train_state", recording)
        mp.setattr(ttrain, "init_dino_weights",
                   lambda model, seed: model.load_state_dict(params_from_flax(init["params"])))
        from tpuwsi.cli.train import main as jmain

        for name, argv in (("", MAIN_ARGV + ["--data-root", cohort_root]),
                           ("f", FOLDER_ARGV + ["--data-dir",
                                                os.path.join(image_folder, "train")])):
            init.clear()
            runs["j" + name] = jmain(argv + ["--output", str(tmp / ("j" + name))])
            runs["t" + name] = ttrain.main(argv + ["--output", str(tmp / ("t" + name))],
                                           device=CPU)
    finally:
        mp.undo()
    out = {k + "out": str(tmp / k) for k in runs}
    return types.SimpleNamespace(**runs, **out)


def test_main_matches_jax_main_in_wsi_mode(both_mains):
    j, t = both_mains.j, both_mains.t
    assert t.step == int(j.step) == 4
    for name, want, got in (("params", j.params, t.model), ("ema", j.ema_params, t.ema)):
        want, got = params_from_flax(jax.device_get(want)), got.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=f"{name} {k}",
                                       **TOL)


def test_main_writes_the_jax_mains_summary_and_ledger(both_mains):
    from tpuwsi_torch.utils.ledger import ExperimentLedger

    rows = {side: _summary(getattr(both_mains, side + "out")) for side in ("j", "t")}
    assert len(rows["t"]) == len(rows["j"]) == 2
    for t, j in zip(rows["t"], rows["j"]):
        assert list(t) == list(j)
        assert "eval_auc" in t and "train_lr" in t
        for k in j:
            np.testing.assert_allclose(float(t[k]), float(j[k]), err_msg=k, **TOL)
    ledgers = {side: ExperimentLedger(getattr(both_mains, side + "out")).all_experiments()[1]
               for side in ("j", "t")}
    for rec in ledgers.values():
        rec.pop("Location")
    assert ledgers["t"].keys() == ledgers["j"].keys()
    for k, v in ledgers["j"].items():
        if isinstance(v, float):
            np.testing.assert_allclose(ledgers["t"][k], v, err_msg=k, **TOL)
        else:
            assert ledgers["t"][k] == v, k
    run = _run_dir(both_mains.tout)
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["2", "4"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = f.read().splitlines()
    assert any("eval_slide_roc_points" in line for line in lines)


# -- checkpoints ---------------------------------------------------------------------

def _port_main(monkeypatch, argv, out):
    from tpuwsi_torch.cli.train import main

    _tiny_models(monkeypatch)
    return main(argv + ["--output", str(out)], device=CPU)


def test_resume_continues_bit_for_bit_and_ef_reads_the_checkpoint(cohort_root, tmp_path,
                                                                  monkeypatch):
    from tpuwsi_torch.cli.args import parse_args
    from tpuwsi_torch.cli.train import extract_features, feature_model, infer_slide_table
    from tpuwsi_torch.infer.slide_walker import SlideWalker

    argv = MAIN_ARGV + ["--data-root", cohort_root, "--transform_type", "pcbnfrs",
                        "--recovery-interval", "1"]
    whole = _port_main(monkeypatch, argv, tmp_path / "whole")
    ckpts = os.path.join(_run_dir(str(tmp_path / "whole")), "checkpoints")
    assert sorted(os.listdir(os.path.join(ckpts, "recovery"))) == ["2", "4"]
    # resume from the first epoch's checkpoint: the latest step under a copy
    shutil.copytree(ckpts, tmp_path / "epoch0")
    shutil.rmtree(tmp_path / "epoch0" / "4")
    resumed = _port_main(monkeypatch, argv + ["--resume", str(tmp_path / "epoch0")],
                         tmp_path / "resumed")
    assert resumed.step == whole.step == 4
    _assert_same(whole.state_dict(), resumed.state_dict())
    assert len(_summary(str(tmp_path / "resumed"))) == 1  # the second epoch only

    # -ef over the test fold with the trained parameters, and the same by hand
    ef = ["-ef", "--dataset", "TCGA", "--data-root", cohort_root, "--model",
          "vit_tiny_patch16_224", "--tile-size", "32", "-nt", "5", "-tpi", "4", "--mag", "10",
          "--workers", "2"]
    ef += ["--initial-checkpoint", ckpts]
    agg = _port_main(monkeypatch, ef, tmp_path / "ef")
    args = parse_args(ef)
    model, params = feature_model(args)
    for k, v in whole.model.state_dict().items():
        assert torch.equal(params[k], v), k
    model.load_state_dict(whole.model.state_dict())
    ref = extract_features(SlideWalker(infer_slide_table(args), tiles_per_iter=4,
                                       num_tiles=5).walk(),
                           model, whole.model.state_dict(), str(tmp_path / "byhand"), CPU)
    assert [r.slide_name for r in agg.results] == [r.slide_name for r in ref.results]
    for g, w in zip(agg.results, ref.results):
        np.testing.assert_array_equal(g.features, w.features)


# -- folder mode ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(13)
    for split, n in (("train", 6), ("val", 4)):
        for c, base in (("neg", 60), ("pos", 190)):
            os.makedirs(root / split / c)
            for i in range(n):
                img = np.clip(rng.normal(base, 30, (32, 32, 3)), 0, 255).astype(np.uint8)
                Image.fromarray(img).save(root / split / c / f"{i}.png")
    return str(root)


def test_evaluate_folder_matches_jax(image_folder):
    from tpuwsi.cli.train import evaluate_folder as j_evaluate_folder
    from tpuwsi.io.folder import load_folder_datasets as j_load
    from tpuwsi.preprocess import make_recipe as j_make_recipe
    from tpuwsi.train.supervised import make_eval_step as j_make_eval_step
    from tpuwsi_torch.cli.train import evaluate_folder
    from tpuwsi_torch.io.folder import load_folder_datasets

    jmodel, variables = _jax_tiny()
    norm = j_make_recipe("none", train=False, tile_size=32)
    step = j_make_eval_step(jmodel.apply,
                            preprocess_fn=lambda im: norm(jax.random.PRNGKey(0), im))
    state = types.SimpleNamespace(params=variables, ema_params=None, batch_stats=None)
    jitted = jax.jit(lambda images: step(state, {"images": images}))
    want = j_evaluate_folder(j_load(image_folder)[1], state, lambda _, b: jitted(b["images"]),
                             3, steps_per_dispatch=1)
    model = _port_tiny()
    got = evaluate_folder(load_folder_datasets(image_folder)[1], model, 3, CPU,
                          params=params_from_flax(variables))
    assert got.keys() == want.keys() == {"top1", "top5", "loss", "auc"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_main_trains_folder_mode(both_mains):
    """Folder mode's main against the JAX main: the 80/20 split, the batch
    order of each epoch, BCE under AdamW with the backbone frozen, the EMA,
    ``evaluate_folder`` every epoch and ``summary.csv``."""
    j, t = both_mains.jf, both_mains.tf
    assert t.step == int(j.step) == 4  # 10 of the 12 images train, batches of 4
    for name, want, got in (("params", j.params, t.model), ("ema", j.ema_params, t.ema)):
        want, got = params_from_flax(jax.device_get(want)), got.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=f"{name} {k}",
                                       **TOL)
    trains = {name: p.requires_grad for name, p in t.model.named_parameters()}
    assert trains == {name: "head" in name for name in trains} and not all(trains.values())
    rows = {side: _summary(getattr(both_mains, side + "fout")) for side in ("j", "t")}
    assert len(rows["t"]) == len(rows["j"]) == 2
    for tr, jr in zip(rows["t"], rows["j"]):
        assert list(tr) == list(jr) == ["epoch", "train_acc", "train_auc", "train_loss",
                                        "train_lr", "eval_top1", "eval_top5", "eval_loss",
                                        "eval_auc"]
        for k in jr:
            np.testing.assert_allclose(float(tr[k]), float(jr[k]), err_msg=k, **TOL)


# -- without jax, and the refusals ---------------------------------------------------------

_NO_JAX_SUPERVISED = _COHORT + """
import sys
from tpuwsi_torch.cli.train import main
state = main(["--dataset", "TCGA", "--data-root", root, "--model", "vit_tiny_patch8_224",
              "--tile-size", "16", "-b", "2", "--epochs", "1", "--max-steps-per-epoch", "2",
              "--transform_type", "pcbnfrsc", "--model-ema", "--n_patches_train", "2",
              "--n_patches_test", "3", "-tpi", "4", "--output", os.path.join(root, "sup")],
             device=torch.device("cpu"))
assert state.step == 2
agg = main(["-ef", "--dataset", "TCGA", "--data-root", root, "--model", "vit_tiny_patch8_224",
            "--tile-size", "16", "-nt", "3", "-tpi", "4", "--output", os.path.join(root, "ef"),
            "--resume", os.path.join(root, "sup", [d for d in os.listdir(os.path.join(root, "sup"))
                                                   if d.startswith("Exp_")][0], "checkpoints")],
           device=torch.device("cpu"))
assert len(agg.results) == 2
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not bad, bad
""" % (_BANNED,)


def test_supervised_route_runs_without_importing_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SUPERVISED], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


M3B = [
    ["--transform_type", "timm"], ["--mixup", "0.2"], ["--cutmix", "1.0"],
    ["--cutmix-minmax", "0.2", "0.8"], ["--aa", "rand-m9-mstd0.5"], ["--reprob", "0.25"],
    ["--sched", "plateau"], ["--sched", "step"], ["--lr-noise", "0.4"], ["--opt", "lamb"],
    ["--opt", "rmsprop"], ["--clip-grad", "1", "--clip-mode", "value"],
    ["--clip-grad", "1", "--clip-mode", "agc"], ["--layer-decay", "0.75"], ["-im"],
    ["--save-images"], ["--log-wandb"], ["--data-dir", "x", "--aug-repeats", "3"],
]


@pytest.mark.parametrize("extra", M3B, ids=lambda e: " ".join(e))
def test_m3b_options_are_refused_before_any_file(cohort_root, tmp_path, extra):
    from tpuwsi_torch.cli.train import main

    out = tmp_path / "runs"
    with pytest.raises(NotImplementedError, match="M3b"):
        main(["--dataset", "TCGA", "--data-root", cohort_root] + extra + ["--output", str(out)],
             device=CPU)
    assert not out.exists()


@pytest.mark.parametrize("extra", [["--aug-repeats", "2"], ["--target", "ER+PR", "--focal"]],
                         ids=lambda e: " ".join(e))
def test_the_jax_clis_own_exits_come_first(cohort_root, tmp_path, monkeypatch, extra):
    from tpuwsi.cli.train import main as jmain
    from tpuwsi_torch.cli.train import main as tmain

    _tiny_models(monkeypatch)
    argv = MAIN_ARGV + ["--data-root", cohort_root] + extra
    with pytest.raises(SystemExit) as want:
        jmain(argv + ["--output", str(tmp_path / "j")])
    with pytest.raises(SystemExit) as got:
        tmain(argv + ["--output", str(tmp_path / "t")], device=CPU)
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "t").exists()


@pytest.mark.parametrize("extra", [["--aug-splits", "1"], ["--jsd-loss"],
                                   ["--target", "ER+PR", "--mixup", "0.2"]],
                         ids=lambda e: " ".join(e))
def test_other_jax_cli_exits_before_any_file(cohort_root, tmp_path, extra):
    from tpuwsi_torch.cli.train import main

    out = tmp_path / "runs"
    with pytest.raises(SystemExit):
        main(MAIN_ARGV + ["--data-root", cohort_root] + extra + ["--output", str(out)],
             device=CPU)
    assert not out.exists()
