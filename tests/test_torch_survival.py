"""The port's survival training held against the JAX package on the CPU.

- ``cox_partial_likelihood`` (tied times, all censored, its gradient) and
  ``concordance_index`` (tied risks, no comparable pair) at 1e-6;
- ``load_survival_slide_table`` equal field by field over a cohort whose
  cells reach pandas' rules (a blank censor flag and follow-up time, an
  excluded slide, unknown 5-year status), for each fold rule, the censor
  filters and the censor balance; ``survival_batches`` equal over two
  epochs; ``SurvivalSlideWalker``'s chunks equal;
- three steps of ``make_survival_train_step`` in each mode against the JAX
  step (fp32 ViT, depth 2, width 64, 32 px) from the same weights, at 1e-4;
- ``SurvivalAggregator``'s slide C-index and binary AUC, equal exactly;
- ``main -tar Survival_Time`` and ``Survival_Binary`` of both packages over
  a PNG cohort of ten slides (2 epochs of 2 steps, evaluation every epoch),
  the port from the JAX run's initial weights: final weights and
  ``summary.csv`` at 1e-4, the same checkpoint steps, the ledger;
- --resume continues bit for bit; --no-grad trains the head alone;
  --steps-per-dispatch keeps the bits; the options the port does not run
  are refused by name before any file is written.
"""

import csv
import math
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_slide_tables import _assert_same_table
from test_torch_supervised import TINY, _assert_same, _run_dir, _tiny_models
from test_torch_wsi import _assert_same_chunk, _slide
from tpuwsi.infer.survival_walker import SurvivalAggregator as JSurvivalAggregator
from tpuwsi.infer.survival_walker import SurvivalSlideWalker as JSurvivalSlideWalker
from tpuwsi.io import survival as j_survival
from tpuwsi.io.wsi import WSITileSampler as JWSITileSampler
from tpuwsi.train import losses as JL
from tpuwsi.train import survival as JS
from tpuwsi_torch.infer.survival_walker import SurvivalAggregator, SurvivalSlideWalker
from tpuwsi_torch.io import grids as t_grids
from tpuwsi_torch.io import survival as t_survival
from tpuwsi_torch.io.cohorts import get_datasets_dir_dict
from tpuwsi_torch.io.slide_readers import ImageSlideReader
from tpuwsi_torch.io.wsi import WSITileSampler
from tpuwsi_torch.models.convert import params_from_flax
from tpuwsi_torch.train import losses as TL
from tpuwsi_torch.train import survival as TS
from tpuwsi_torch.utils.minixlsx import write_xlsx

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
EXACT = dict(atol=1e-6, rtol=1e-6)
TILE = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these CPU runs are tiny, and the test runner's
    other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the loss and the C-index -------------------------------------------------------

_COX = {
    "random": (np.random.default_rng(0).normal(0, 1, 9), np.arange(9.0)[::-1],
               np.array([1, 0, 1, 1, 0, 1, 0, 1, 1])),
    "tied-times": (np.random.default_rng(1).normal(0, 2, 8),
                   np.array([5.0, 5.0, 3.0, 3.0, 3.0, 9.0, 1.0, 5.0]),
                   np.array([1, 1, 0, 1, 1, 0, 1, 0])),
    "all-censored": (np.random.default_rng(2).normal(0, 1, 6), np.arange(6.0),
                     np.zeros(6)),
    "one": (np.array([0.3]), np.array([2.0]), np.array([1])),
}


@pytest.mark.parametrize("case", sorted(_COX))
def test_cox_partial_likelihood_matches_jax(case):
    risk, times, events = (np.asarray(a, np.float32) for a in _COX[case])
    want, want_grad = jax.value_and_grad(JL.cox_partial_likelihood)(
        jnp.asarray(risk), jnp.asarray(times), jnp.asarray(events))
    r = torch.tensor(risk, requires_grad=True)
    got = TL.cox_partial_likelihood(r, torch.from_numpy(times), torch.from_numpy(events))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **EXACT)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(want_grad), **EXACT)


_CINDEX = {
    "random": (np.random.default_rng(3).normal(0, 1, 10), np.random.default_rng(4).random(10),
               np.array([1, 0, 1, 1, 1, 0, 0, 1, 1, 0])),
    "tied-risks": (np.array([0.5, 0.5, 0.1, 0.5, 0.9, 0.1]),
                   np.array([1.0, 2.0, 3.0, 3.0, 0.5, 2.0]), np.array([1, 1, 0, 1, 1, 1])),
    "no-pair": (np.array([0.1, 0.2]), np.array([3.0, 3.0]), np.array([1, 1])),
}


@pytest.mark.parametrize("case", sorted(_CINDEX))
def test_concordance_index_matches_jax(case):
    risk, times, events = (np.asarray(a, np.float32) for a in _CINDEX[case])
    want = JS.concordance_index(jnp.asarray(risk), jnp.asarray(times), jnp.asarray(events))
    got = TS.concordance_index(torch.from_numpy(risk), torch.from_numpy(times),
                               torch.from_numpy(events))
    np.testing.assert_allclose(float(got), float(want), **EXACT)


# -- the survival cohort ------------------------------------------------------------

# ten PNG slides of the ABCTB cohort (objective 20): test fold 1 is slides 0-3,
# of which slide 3 has no follow-up time; slide 5 is excluded and slide 8 has
# a blank censor flag; 20-month and 30-month times tie; two statuses unknown
N_SLIDES = 10
SURVIVAL = {
    "Censored": [False, True, False, False, False, True, False, True, None, False],
    "Follow-up Months Since Diagnosis": [12.0, 30.0, 30.0, None, 40.0, 7.0, 20.0, 20.0, 15.0,
                                         60.0],
    "survival status": ["Positive", "Negative", "Positive", None, "Negative", "Positive",
                        "Negative", "Positive", "Negative", None],
    "Exclude for time prediction?": [None] * 5 + ["Exclude"] + [None] * 4,
}
FOLDS = [1, 1, 1, 1, 2, 2, 2, 2, 3, 3]


def write_survival_cohort(root: str) -> str:
    cohort = get_datasets_dir_dict("ABCTB", data_root=root)["ABCTB"]
    os.makedirs(cohort, exist_ok=True)
    files = [f"slide_{i}.png" for i in range(N_SLIDES)]
    grid_rows = []
    for i, name in enumerate(files):
        img = _slide(100 + i)
        Image.fromarray(img).save(os.path.join(cohort, name))
        grid = t_grids.build_tissue_grid(ImageSlideReader(img), TILE * 2, preview_downsample=4)
        t_grids.save_grid_pickle(t_grids.grid_file_path(cohort, name, 10, TILE), grid)
        grid_rows.append(len(grid))
    total, legit = t_grids.grid_data_columns(TILE, 10)
    write_xlsx(os.path.join(cohort, "Grids_10", "Grid_data.xlsx"),
               {"file": files, total: grid_rows, legit: grid_rows})
    write_xlsx(os.path.join(cohort, "slides_data_ABCTB.xlsx"), {
        "file": files, "id": ["ABCTB"] * N_SLIDES,
        "patient barcode": [f"patient_{i}" for i in range(N_SLIDES)], **SURVIVAL,
        "test fold idx": FOLDS, "Manipulated Objective Power": [20] * N_SLIDES,
    })
    return cohort


@pytest.fixture(scope="module")
def cohort_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("survival"))
    write_survival_cohort(root)
    return root


_FLAGS = [
    dict(),
    dict(train=False),
    dict(test_fold=0),
    dict(train_type="Infer", infer_folds=[1]),
    dict(train_type="Infer", infer_folds=[1, 0]),
    dict(train_type="Infer_All_Folds"),
    dict(train_type="MIL", bag_size=8),
    dict(n_tiles=100),
    dict(is_all_censored=True),
    dict(is_all_not_censored=True, train_type="Infer_All_Folds"),
    dict(censor_balance=True),
    dict(censor_balance=True, rng="seed"),
]


@pytest.mark.parametrize("flags", _FLAGS, ids=[str(f) for f in _FLAGS])
def test_load_survival_slide_table_matches_jax(cohort_root, flags):
    flags = dict(flags, tile_size=TILE, data_root=cohort_root)
    seeded = flags.pop("rng", None) == "seed"
    tables = []
    for mod in (j_survival, t_survival):
        kw = dict(flags, rng=np.random.default_rng(7)) if seeded else flags
        tables.append(mod.load_survival_slide_table("ABCTB", **kw))
    want, got = tables
    _assert_same_table(got, want)
    assert t_survival.SURVIVAL_COLUMNS == j_survival.SURVIVAL_COLUMNS


def test_survival_tables_select_the_valid_slides(cohort_root):
    kw = dict(tile_size=TILE, data_root=cohort_root)
    train = t_survival.load_survival_slide_table("ABCTB", **kw)
    test = t_survival.load_survival_slide_table("ABCTB", train=False, **kw)
    assert train.file_names == [f"slide_{i}.png" for i in (4, 6, 7, 9)]
    assert test.file_names == [f"slide_{i}.png" for i in (0, 1, 2)]
    assert train.censored == [False, False, True, False]


def test_survival_batches_and_walker_match_jax(cohort_root):
    kw = dict(tile_size=TILE, data_root=cohort_root)
    tables = [mod.load_survival_slide_table("ABCTB", **kw) for mod in (j_survival, t_survival)]
    samplers = [JWSITileSampler(tables[0], n_tiles=4, bag_size=1),
                WSITileSampler(tables[1], n_tiles=4, bag_size=1)]
    try:
        for epoch in range(2):
            want, got = (list(mod.survival_batches(s, np.random.default_rng(epoch), 3))
                         for mod, s in zip((j_survival, t_survival), samplers))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in w:
                    assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
            assert {int(b) for batch in got for b in batch["binary_targets"]} == {-1, 0, 1}
    finally:
        samplers[1].close()
    kw["train"] = False
    walkers = [JSurvivalSlideWalker(j_survival.load_survival_slide_table("ABCTB", **kw),
                                    tiles_per_iter=3, num_tiles=5),
               SurvivalSlideWalker(t_survival.load_survival_slide_table("ABCTB", **kw),
                                   tiles_per_iter=3, num_tiles=5, threads=2)]
    want, got = (list(w.walk()) for w in walkers)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _assert_same_chunk(g, w)


def test_survival_aggregator_matches_jax():
    rng = np.random.default_rng(8)
    aggs = (JSurvivalAggregator(), SurvivalAggregator())
    times = [10.0, 20.0, 20.0, 5.0, 30.0, 12.0]
    for s in range(6):
        for c in range(2):
            k = 4 if c == 0 else 2
            chunk = types.SimpleNamespace(
                mask=np.arange(4) < k, locations=[(s, c, j) for j in range(k)],
                is_last_batch=c == 1, slide_name=f"s{s}", patient_barcode=f"p{s}",
                binary_target=[1, 0, -1, 1, 0, 1][s], time_target=times[s],
                censored=s in (1, 4))
            risks = rng.normal(0, 1, 4).astype(np.float32)
            if s == 5:
                risks[:] = 0.25  # slides 2 and 5 tie in risk
            if s == 2:
                risks[:] = 0.25
            for a in aggs:
                a.add_chunk(chunk, risks)
    want, got = aggs
    assert got.slide_c_index() == want.slide_c_index()
    assert got.slide_binary_auc() == want.slide_binary_auc()
    for g, w in zip(got.results, want.results):
        assert g.slide_risk == w.slide_risk and g.tile_locations == w.tile_locations
    assert SurvivalAggregator().slide_c_index() == 0.5


# -- the step -----------------------------------------------------------------------

B = 6
# The Cox loss does not change when every risk of the batch moves by the same
# amount, so the gradients of the head's bias and of the final norm's bias are
# zero in exact arithmetic: under Adam's normalised step their rounding noise
# would move them by up to the learning rate a step, in either package. Cox is
# held against the JAX step under Nesterov SGD, the 5-year status under AdamW.
OPT = {"cox": dict(opt="nesterov", lr=0.05), "binary": dict(opt="adamw", lr=2e-3)}


@pytest.mark.parametrize("mode", ["cox", "binary"])
def test_survival_step_trajectory_matches_jax(mode):
    from tpuwsi.preprocess import make_recipe as j_make_recipe
    from tpuwsi.train import create_train_state as j_create_train_state
    from tpuwsi.train import make_optimizer as j_make_optimizer
    from tpuwsi.train.optim import OptimConfig as JOptimConfig
    from tpuwsi_torch.models.vit import ViTConfig, VisionTransformer
    from tpuwsi_torch.preprocess.recipes import make_recipe
    from tpuwsi_torch.train.optim import OptimConfig, make_optimizer
    from tpuwsi_torch.train.state import create_train_state

    tiny = dict(TINY, num_classes=1 if mode == "cox" else 2)
    okw = dict(OPT[mode], weight_decay=0.05, epochs=2, warmup_epochs=1, steps_per_epoch=2,
               warmup_lr=1e-4)
    from tpuwsi.models.vit import ViTConfig as JViTConfig
    from tpuwsi.models.vit import VisionTransformer as JViT

    jmodel = JViT(JViTConfig(**tiny, dtype=jnp.float32, use_pallas_attention=False))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    tx, _ = j_make_optimizer(JOptimConfig(**okw), variables, B)
    jstep = jax.jit(JS.make_survival_train_step(
        jmodel.apply, tx, mode=mode, augment_fn=j_make_recipe("none", train=True, tile_size=32)))
    jstate = j_create_train_state(variables, tx)

    model = VisionTransformer(ViTConfig(**tiny, dtype=torch.float32, attn_save_probs=True))
    model.load_state_dict(params_from_flax(variables))
    optimizer, _ = make_optimizer(OptimConfig(**okw), B)
    state = create_train_state(model, optimizer)
    step = TS.make_survival_train_step(model, optimizer, mode=mode,
                                       augment_fn=make_recipe("none", train=True))
    rng = np.random.default_rng(12)
    metric = "c_index" if mode == "cox" else "auc"
    for i in range(3):
        batch = {"images": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
                 "censored": rng.random(B) < 0.3,
                 "time_targets": rng.choice([3.0, 7.0, 7.0, 12.0], B).astype(np.float32),
                 "binary_targets": rng.integers(-1, 2, B)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(1))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(m) == sorted(jm) == sorted(["loss", metric])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
        np.testing.assert_allclose(float(m[metric]), float(jm[metric]), **TOL)
    want = params_from_flax(jax.device_get(jstate.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **TOL)
    with pytest.raises(ValueError, match="mode"):
        TS.make_survival_train_step(model, optimizer, mode="weibull")


# -- main of both packages ----------------------------------------------------------

MAIN_ARGV = ["--dataset", "ABCTB", "--model", "vit_tiny_patch16_224", "--tile-size", "32",
             "-b", "4", "--epochs", "2", "--max-steps-per-epoch", "2", "--warmup-epochs", "1",
             "--weight-decay", "0.01", "--eval_rate", "1",
             "--n_patches_test", "4", "-tpi", "3", "-tf", "1", "--mag", "10",
             "--n_patches_train", "4", "--workers", "2", "--seed", "0", "--log-interval", "1",
             "--transform_type", "none"]
# the optimizer of each target (OPT's reasons); for Survival_Binary also
# options the JAX survival loop does not read, which the port ignores too
EXTRA = {"Survival_Time": ["--opt", "nesterov", "--lr", "0.05"],
         "Survival_Binary": ["--opt", "adamw", "--lr", "1e-3", "--mixup", "0.2", "--model-ema",
                             "--smoothing", "0.1", "--cooldown-epochs", "1"]}


def _summary(out):
    with open(os.path.join(_run_dir(out), "summary.csv")) as f:
        return list(csv.DictReader(f))


def _checkpoint_steps(out):
    ckpts = os.path.join(_run_dir(out), "checkpoints")
    return sorted(int(d) for d in os.listdir(ckpts) if d.isdigit())


@pytest.fixture(scope="module")
def both_mains(cohort_root, tmp_path_factory):
    """The JAX main, then the port's from the JAX run's initial weights, for
    each survival target."""
    import tpuwsi.train as jtrain
    from tpuwsi.cli.train import main as jmain
    from tpuwsi_torch.cli import train as ttrain

    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("survival_mains")
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
        for target, extra in EXTRA.items():
            argv = MAIN_ARGV + ["--data-root", cohort_root, "-tar", target] + extra
            init.clear()
            for side, main in (("j", jmain), ("t", lambda a: ttrain.main(a, device=CPU))):
                out = str(tmp / (side + target))
                runs[side + target] = types.SimpleNamespace(
                    state=main(argv + ["--output", out]), out=out)
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("target", ["Survival_Time", "Survival_Binary"])
def test_main_matches_jax_main(both_mains, target):
    from tpuwsi_torch.utils.ledger import ExperimentLedger

    j, t = both_mains["j" + target], both_mains["t" + target]
    assert t.state.step == int(j.state.step) == 4
    want = params_from_flax(jax.device_get(j.state.params))
    got = t.state.model.state_dict()
    assert got.keys() == want.keys()
    assert got["head.weight"].shape[0] == (1 if target == "Survival_Time" else 2)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **TOL)
    rows = {side: _summary(r.out) for side, r in (("j", j), ("t", t))}
    assert len(rows["t"]) == len(rows["j"]) == 2
    metric = "c_index" if target == "Survival_Time" else "auc"
    for g, w in zip(rows["t"], rows["j"]):
        assert list(g) == list(w)
        assert f"train_{metric}" in g and "eval_c_index" in g and "eval_auc" in g
        for k in w:
            np.testing.assert_allclose(float(g[k]), float(w[k]), err_msg=k, **TOL)
    assert _checkpoint_steps(t.out) == _checkpoint_steps(j.out) == [2, 4]
    ledgers = [ExperimentLedger(r.out).all_experiments()[1] for r in (j, t)]
    for rec in ledgers:
        rec.pop("Location")
    assert ledgers[1] == ledgers[0] and ledgers[1]["Last Epoch"] == 1


def test_resume_continues_bit_for_bit(cohort_root, tmp_path, monkeypatch):
    """The run's state after 2 epochs equals, in every bit, a run resumed from
    its first epoch's checkpoint after that run's first epoch: the resumed
    run starts its epochs at 0 as the JAX loop does, so it takes --seed 1 to
    draw the first run's second epoch."""
    from tpuwsi_torch.cli.train import main
    from tpuwsi_torch.train.checkpoint import load_checkpoint

    _tiny_models(monkeypatch)
    argv = MAIN_ARGV + ["--data-root", cohort_root, "-tar", "Survival_Time", "--transform_type",
                        "pcbnfrs", "--drop-path", "0.1", "--recovery-interval", "1", "--opt",
                        "adamw", "--lr", "1e-3"]
    whole = main(argv + ["--output", str(tmp_path / "whole")], device=CPU)
    ckpts = os.path.join(_run_dir(str(tmp_path / "whole")), "checkpoints")
    assert sorted(os.listdir(os.path.join(ckpts, "recovery"))) == ["2", "4"]
    shutil.copytree(ckpts, tmp_path / "epoch0")
    shutil.rmtree(tmp_path / "epoch0" / "4")
    seed = argv.index("--seed") + 1
    resumed_argv = argv[:seed] + ["1"] + argv[seed + 1:]
    main(resumed_argv + ["--resume", str(tmp_path / "epoch0"), "--epochs", "2", "--output",
                         str(tmp_path / "resumed")], device=CPU)
    after_one = load_checkpoint(os.path.join(_run_dir(str(tmp_path / "resumed")),
                                             "checkpoints"), step=4)
    _assert_same(after_one, whole.state_dict())


def test_no_grad_and_steps_per_dispatch(cohort_root, tmp_path, monkeypatch):
    """--no-grad trains the head alone (the backbone keeps its bits);
    --steps-per-dispatch 3 runs each chunk's steps one after another, the
    same bits as one step a dispatch."""
    from tpuwsi_torch.cli import train as ttrain

    _tiny_models(monkeypatch)
    init = {}
    real_init = ttrain.init_dino_weights

    def recording(model, seed):
        real_init(model, seed)
        init.update({k: v.clone() for k, v in model.state_dict().items()})

    monkeypatch.setattr(ttrain, "init_dino_weights", recording)
    argv = MAIN_ARGV + ["--data-root", cohort_root, "-tar", "Survival_Binary", "--opt", "adamw",
                        "--lr", "1e-3", "--no-grad", "--max-steps-per-epoch", "3"]
    states = [ttrain.main(argv + extra + ["--output", str(tmp_path / str(i))], device=CPU)
              for i, extra in enumerate(([], ["--steps-per-dispatch", "3"]))]
    assert states[0].step == states[1].step == 6
    _assert_same(states[0].state_dict(), states[1].state_dict())
    for k, v in states[0].model.state_dict().items():
        assert torch.equal(v, init[k]) != k.startswith("head"), k


_REFUSED = [
    (["--transform_type", "timm"], NotImplementedError, "M3b"),
    (["--opt", "lamb"], NotImplementedError, "M3b"),
    (["--sched", "step"], NotImplementedError, "M3b"),
    (["--clip-grad", "1.0", "--clip-mode", "agc"], NotImplementedError, "M3b"),
    (["--layer-decay", "0.75"], NotImplementedError, "M3b"),
    (["--model-parallel", "2"], NotImplementedError, "M7"),
    (["--model", "resnet50"], NotImplementedError, "M6"),
    (["--in-chans", "1"], SystemExit, "in-chans"),
]


@pytest.mark.parametrize("extra,error,match", _REFUSED, ids=[" ".join(r[0]) for r in _REFUSED])
def test_unported_options_are_refused_before_any_file(cohort_root, tmp_path, extra, error,
                                                      match):
    from tpuwsi_torch.cli.train import main

    out = tmp_path / "runs"
    with pytest.raises(error, match=match) as got:
        main(MAIN_ARGV + ["--data-root", cohort_root, "-tar", "Survival_Binary", "--output",
                          str(out)] + extra, device=CPU)
    assert not out.exists()
    if error is SystemExit:  # the JAX CLI's own message
        from tpuwsi.cli.train import main as jmain

        with pytest.raises(SystemExit) as want:
            jmain(MAIN_ARGV + ["--data-root", cohort_root, "-tar", "Survival_Binary",
                               "--output", str(tmp_path / "j")] + extra)
        assert str(got.value) == str(want.value)


def test_infer_survival_slides_scores_every_slide(cohort_root):
    from tpuwsi_torch.infer.survival_walker import infer_survival_slides

    table = t_survival.load_survival_slide_table("ABCTB", tile_size=TILE, train=False,
                                                 data_root=cohort_root)
    walker = SurvivalSlideWalker(table, tiles_per_iter=3, num_tiles=5)
    agg = infer_survival_slides(
        walker, lambda images: torch.from_numpy(images).float().mean(dim=(1, 2, 3)))
    assert [r.slide_name for r in agg.results] == table.file_names
    assert all(len(r.tile_risks) == 5 for r in agg.results)
    assert 0.0 <= agg.slide_c_index() <= 1.0 and not math.isnan(agg.slide_binary_auc())
