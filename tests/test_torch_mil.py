"""The port's MIL over feature bags held against the JAX package on the CPU.

- ``GatedAttentionMIL`` (gated and not, partial and fully masked bags, a
  temperature, the attention before and after the softmax), ``MeanPoolMIL``
  and ``tile_scores_from_head`` against ``tpuwsi.models.mil`` from the same
  weights (``mil_params_from_flax``), at 1e-5;
- ``FeaturesMILDataset``'s entries and bags over two epochs of draws, equal
  exactly for every option (the 6-, 7- and 8-tuple layouts, per patient,
  ``fixed_tile_num``, ``data_limit``, ``carmel_only``, the paired
  Receptor+is_Tumor mode, ...), and the same errors; the combined dataset
  and the registry;
- ``train_mil_head`` for 3 epochs with evaluation against the JAX one from
  the JAX run's initial weights, at 1e-4, and ``steps_per_dispatch`` 1 and 8
  giving the same bits;
- ``cli.mil_train.main`` against the JAX ``main`` (--features, and the
  registry's paired set): the final evaluation and ``slide_scores.xlsx``'s
  cells at 1e-5, the checkpoint;
- the port's ``-ef`` ``inference.data`` read back by the port's and the
  JAX package's ``FeaturesMILDataset``, and trained on.

Features are 8-16 wide, bags of 3-6 tiles, the -ef run a depth-12 ViT-Ti at
32 px: the whole file takes about 35 s in one process.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuwsi.mil import combined as j_combined
from tpuwsi.mil import features as j_features
from tpuwsi.mil import locator as j_locator
from tpuwsi.models import mil as j_mil
from tpuwsi_torch.mil import combined as t_combined
from tpuwsi_torch.mil import features as t_features
from tpuwsi_torch.mil import locator as t_locator
from tpuwsi_torch.models import mil as t_mil
from tpuwsi_torch.models.convert import mil_params_from_flax, mil_params_to_flax

CPU = torch.device("cpu")
MODEL_TOL = dict(atol=1e-5, rtol=1e-5)
TRAIN_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these CPU runs are tiny, and the test runner's
    other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the heads ----------------------------------------------------------------------

def _bags(seed, b=3, n=7, d=16):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (b, n, d)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[0, 5:] = False
    mask[1, :] = False  # a fully masked bag: uniform attention
    return feats, mask


@pytest.mark.parametrize("gated,temperature", [(True, 1.0), (False, 1.0), (True, 0.5)])
@pytest.mark.parametrize("with_mask", [True, False])
def test_gated_attention_mil_matches_jax(gated, temperature, with_mask):
    feats, mask = _bags(1)
    jmodel = j_mil.GatedAttentionMIL(hidden_dim=12, num_classes=3, gated=gated,
                                     temperature=temperature)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(feats), jnp.asarray(mask))
    model = t_mil.GatedAttentionMIL(16, hidden_dim=12, num_classes=3, gated=gated,
                                    temperature=temperature)
    model.load_state_dict(mil_params_from_flax(jax.device_get(params)))
    jm = jnp.asarray(mask) if with_mask else None
    tm = torch.from_numpy(mask) if with_mask else None
    want = jmodel.apply(params, jnp.asarray(feats), jm, return_attention=True)
    with torch.no_grad():
        got = model(torch.from_numpy(feats), tm, return_attention=True)
        np.testing.assert_allclose(model(torch.from_numpy(feats), tm).numpy(),
                                   np.asarray(want[0]), **MODEL_TOL)
    for g, w, name in zip(got, want, ("logits", "before", "after")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **MODEL_TOL)
    if with_mask:
        np.testing.assert_allclose(got[2][1].numpy(), np.full(7, 1 / 7), **MODEL_TOL)
        assert float(got[1][0, 6]) == float(np.float32(t_mil.NEG_INF))


def test_mean_pool_mil_matches_jax():
    feats, mask = _bags(3)
    jmodel = j_mil.MeanPoolMIL(num_classes=2)
    params = jmodel.init(jax.random.PRNGKey(4), jnp.asarray(feats), jnp.asarray(mask))
    model = t_mil.MeanPoolMIL(16)
    model.load_state_dict(mil_params_from_flax(jax.device_get(params)))
    for m in (mask, None):
        want = jmodel.apply(params, jnp.asarray(feats), None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = model(torch.from_numpy(feats), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("receptor_slice", [None, 8])
def test_tile_scores_from_head_matches_jax(receptor_slice):
    rng = np.random.default_rng(5)
    feats = rng.normal(0, 1, (9, 16)).astype(np.float32)
    kernel = rng.normal(0, 1, (16, 2)).astype(np.float32)
    want = j_mil.tile_scores_from_head(jnp.asarray(feats), jnp.asarray(kernel), receptor_slice)
    got = t_mil.tile_scores_from_head(torch.from_numpy(feats), torch.from_numpy(kernel.T.copy()),
                                      receptor_slice)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_mil_params_round_trip_and_init():
    model = t_mil.GatedAttentionMIL(16, hidden_dim=12)
    t_mil.init_mil_weights(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    back = mil_params_from_flax(mil_params_to_flax(sd))
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    assert all(float(v.abs().max()) <= 0.04 for k, v in sd.items() if k.endswith("weight"))
    assert all(not v.any() for k, v in sd.items() if k.endswith("bias"))
    jparams = j_mil.GatedAttentionMIL(hidden_dim=12).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 16)), jnp.ones((1, 3), bool))
    assert jax.tree_util.tree_structure(mil_params_to_flax(sd)) == \
        jax.tree_util.tree_structure(jax.device_get(jparams))


# -- feature bags -------------------------------------------------------------------

def _write_data(path, names, feats, targets=None, layout=8, locs=None, seed=0):
    """An inference .data pickle: features (n, 1, max_tiles, D), NaN past
    each slide's tiles."""
    n, _, t, _ = feats.shape
    targets = np.arange(n) % 2 if targets is None else np.asarray(targets)
    pscores = np.random.default_rng(seed).random((n, t)).astype(np.float32)
    base = (targets, targets, np.linspace(0, 1, n), pscores, list(names), feats)
    if layout == 6:
        data = base
    elif layout == 7:
        data = base + (0,)
    elif layout == 8:
        if locs is None:
            locs = np.stack([np.stack([np.arange(t) * 10, np.arange(t) * 7], 1)] * n).astype(float)
        data = base + (0, locs)
    else:
        data = base[:5]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def _ragged_feats(rng, counts, max_tiles, dim):
    feats = rng.normal(0, 1, (len(counts), 1, max_tiles, dim)).astype(np.float32)
    for i, c in enumerate(counts):
        feats[i, :, c:] = np.nan
    return feats


NAMES = ["TCGA-AA-0001-01.svs", "TCGA-AA-0001-02.svs", "TCGA-BB-0002-01.svs", "c1.mrxs",
         "c2.ndpi", "10-14248_1_1_a.mrxs", "c3.mrxs", "TCGA-BB-0002-03.svs"]
COUNTS = [9, 3, 12, 7, 1, 10, 12, 5]
TARGETS = [1, 1, 0, 1, 0, 0, 1, 1]


@pytest.fixture(scope="module")
def feature_files(tmp_path_factory):
    """One feature set in two files (8- and 6-tuple layouts), a paired
    is_Tumor set (features + 100 at the same locations) and a 7-tuple file."""
    root = tmp_path_factory.mktemp("bags")
    rng = np.random.default_rng(0)
    feats = _ragged_feats(rng, COUNTS, 12, 8)
    locs = rng.integers(0, 1000, (8, 12, 2)).astype(float)
    _write_data(str(root / "set" / "a.data"), NAMES[:5], feats[:5], TARGETS[:5],
                locs=locs[:5], seed=1)
    _write_data(str(root / "set" / "b.data"), NAMES[5:], feats[5:], TARGETS[5:], layout=6,
                seed=2)
    # the paired set: the first file's slides, the is_Tumor features at the same locations
    _write_data(str(root / "receptor" / "a.data"), NAMES[:5], feats[:5], TARGETS[:5],
                locs=locs[:5])
    _write_data(str(root / "tumor" / "a.data"), NAMES[:5], feats[:5] + 100.0, TARGETS[:5],
                locs=locs[:5])
    _write_data(str(root / "seven.data"), NAMES[:3], feats[:3], TARGETS[:3], layout=7)
    return root


_DS_CASES = {
    "default": dict(bag_size=4, minimum_tiles_in_slide=1),
    "minimum-10": dict(bag_size=4, minimum_tiles_in_slide=10),
    "minimum-5": dict(bag_size=6, minimum_tiles_in_slide=5),
    "per-patient": dict(bag_size=4, minimum_tiles_in_slide=1, is_per_patient=True),
    "per-patient-fixed": dict(bag_size=4, minimum_tiles_in_slide=1, is_per_patient=True,
                              fixed_tile_num=4),
    "fixed": dict(bag_size=5, minimum_tiles_in_slide=1, fixed_tile_num=6),
    "data-limit-train": dict(bag_size=4, minimum_tiles_in_slide=1, data_limit=4,
                             is_train=True),
    "data-limit-eval": dict(bag_size=4, minimum_tiles_in_slide=1, data_limit=4),
    "carmel": dict(bag_size=4, minimum_tiles_in_slide=1, carmel_only=True),
    "no-sampling": dict(bag_size=4, minimum_tiles_in_slide=1, sample_tiles=False),
    "all-tiles": dict(bag_size=4, minimum_tiles_in_slide=1, is_all_tiles=True),
    "lookups": dict(bag_size=4, minimum_tiles_in_slide=1, is_per_patient=True,
                    barcode_lookup={"c1.mrxs": "P1", "c3.mrxs": "P1"},
                    slide_target_lookup={"c1.mrxs": 1}),
    "paired": dict(bag_size=4, minimum_tiles_in_slide=2, location="paired"),
    "paired-per-patient": dict(bag_size=4, minimum_tiles_in_slide=2, is_per_patient=True,
                               location="paired"),
    "paired-fixed": dict(bag_size=3, minimum_tiles_in_slide=2, fixed_tile_num=4,
                         location="paired"),
    "seven-tuple": dict(bag_size=4, minimum_tiles_in_slide=1, location="seven"),
    "file-list": dict(bag_size=4, minimum_tiles_in_slide=1, location="list"),
}


def _location(root, which):
    return {None: str(root / "set"), "paired": (str(root / "receptor"), str(root / "tumor")),
            "seven": str(root / "seven.data"),
            "list": [str(root / "set" / "b.data"), str(root / "set" / "a.data")]}[which]


def _equal(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), where
    else:
        assert a == b, where


@pytest.mark.parametrize("case", sorted(_DS_CASES))
def test_features_dataset_bags_match_jax(feature_files, case):
    kw = dict(_DS_CASES[case])
    loc = _location(feature_files, kw.pop("location", None))
    want = j_features.FeaturesMILDataset(loc, **kw)
    got = t_features.FeaturesMILDataset(loc, **kw)
    assert len(got) == len(want) > 0
    for field in ("slide_names", "labels", "targets", "scores", "num_tiles", "tile_scores",
                  "features", "tile_locations", "bad_patient_list", "skipped_few_tiles",
                  "paired_is_tumor", "patient_data"):
        _equal(getattr(got, field), getattr(want, field), field)
    for i in range(len(want)):
        _equal(got._entry(i), want._entry(i), f"entry {i}")
    rngs = [np.random.default_rng(3), np.random.default_rng(3)]
    for epoch in range(2):
        for shuffle in (True, False):
            batches = [list(ds.bags(r, 3, shuffle=shuffle)) for ds, r in zip((want, got), rngs)]
            _equal(batches[1], batches[0], f"epoch {epoch} shuffle {shuffle}")
    _equal(list(got.bags(np.random.default_rng(4), 3, drop_last=True)),
           list(want.bags(np.random.default_rng(4), 3, drop_last=True)), "drop_last")


def _corrupt(src, root, what):
    """A copy of the paired set under ``src`` with one fault; → its
    (receptor, tumor)."""
    import shutil

    for d in ("receptor", "tumor"):
        shutil.copytree(src / d, root / what / d, dirs_exist_ok=True)
    path = root / what / "tumor" / "a.data"
    with open(path, "rb") as f:
        data = list(pickle.load(f))
    if what == "locations":
        data[7] = data[7] + 1.0
    elif what == "missing":
        data[4] = [f"other{i}.mrxs" for i in range(len(data[4]))]
    elif what == "short":
        data[5] = data[5].copy()
        data[5][0, :, 2:] = np.nan  # the is_Tumor set has fewer tiles
    with open(path, "wb") as f:
        pickle.dump(tuple(data), f)
    return str(root / what / "receptor"), str(root / what / "tumor")


@pytest.mark.parametrize("fault", ["locations", "missing", "short", "malformed", "empty-dir",
                                   "no-tumor-files", "target-lookup", "per-patient-locations"])
def test_features_dataset_errors_match_jax(feature_files, tmp_path, fault):
    kw = dict(bag_size=4, minimum_tiles_in_slide=1)
    if fault in ("locations", "missing", "short"):
        loc = _corrupt(feature_files, tmp_path, fault)
    elif fault == "per-patient-locations":
        loc = _corrupt(feature_files, tmp_path, "locations")
        kw["is_per_patient"] = True
    elif fault == "malformed":
        loc = _write_data(str(tmp_path / "m.data"), NAMES[:2],
                          np.zeros((2, 1, 3, 4), np.float32), layout=5)
    elif fault == "empty-dir":
        os.makedirs(tmp_path / "empty")
        loc = str(tmp_path / "empty")
    elif fault == "no-tumor-files":
        os.makedirs(tmp_path / "empty")
        loc = (str(feature_files / "receptor"), str(tmp_path / "empty"))
    else:
        loc = str(feature_files / "set")
        kw["slide_target_lookup"] = {"c1.mrxs": 0}
    errors = []
    for mod in (j_features, t_features):
        with pytest.raises((ValueError, KeyError, IOError)) as e:
            mod.FeaturesMILDataset(loc, **kw)
        errors.append((e.type, str(e.value).replace(str(tmp_path), "")))
    assert errors[1] == errors[0]


def test_load_inference_file_and_patients_match_jax(feature_files):
    for path in (feature_files / "set" / "a.data", feature_files / "set" / "b.data",
                 feature_files / "seven.data"):
        _equal(t_features.load_inference_file(str(path)),
               j_features.load_inference_file(str(path)), str(path))
    for name in NAMES + ["plain"]:
        for lookup in (None, {"c1.mrxs": "P9"}):
            assert (t_features.patient_of_slide(name, lookup)
                    == j_features.patient_of_slide(name, lookup))


def test_combined_dataset_and_locator_match_jax(feature_files, tmp_path, monkeypatch):
    sets = {}
    for mod, comb in ((j_features, j_combined), (t_features, t_combined)):
        a = mod.FeaturesMILDataset(str(feature_files / "set"), bag_size=3,
                                   minimum_tiles_in_slide=1)
        b = mod.FeaturesMILDataset(str(feature_files / "receptor"), bag_size=3,
                                   minimum_tiles_in_slide=1)
        c = comb.CombinedFeaturesMILDataset({"A": a, "B": b}, bag_size=3)
        sets[mod] = (c.keys, list(c.bags(np.random.default_rng(5), 2)),
                     c.sample(1, np.random.default_rng(6)))
    _equal(sets[t_features], sets[j_features], "combined")
    with pytest.raises(ValueError, match="at least two"):
        t_combined.CombinedFeaturesMILDataset({"A": None})

    registry = {"CAT": {"ER": {"1": {
        "TrainSet Location": {"train": "/r/train", "test": "/r/test"},
        "REG Model Location": "/ckpt",
        "is_Tumor": {"TrainSet Location": {"train": "/t/train", "test": "/t/test"}}}}}}
    path = tmp_path / "registry.json"
    path.write_text(json.dumps(registry))
    monkeypatch.setenv(t_locator.DEFAULT_REGISTRY_ENV, str(path))
    assert t_locator.DEFAULT_REGISTRY_ENV == j_locator.DEFAULT_REGISTRY_ENV
    jl, tl = j_locator.FeatureLocator(), t_locator.FeatureLocator()
    for is_train in (True, False):
        assert (tl.dataset_properties_to_location("CAT", "ER", 1, is_train)
                == jl.dataset_properties_to_location("CAT", "ER", 1, is_train))
        assert (tl.paired_locations("CAT", "ER", 1, is_train)
                == jl.paired_locations("CAT", "ER", 1, is_train))
    for loc in (jl, tl):
        with pytest.raises(KeyError, match="register it"):
            loc.dataset_properties_to_location("CAT", "PR", 1)
    tl.register("CAT", "PR", 2, {"TrainSet Location": "/x"})
    tl.save(str(tmp_path / "saved.json"))
    assert j_locator.FeatureLocator(path=str(tmp_path / "saved.json")).registry == tl.registry


# -- training -----------------------------------------------------------------------

# The softmax over a bag's scores does not change when every score moves by
# the same amount, so the gradient of ``att_w.bias`` is zero in exact
# arithmetic: what reaches it is rounding, which Adam's normalised step turns
# into moves of up to the learning rate a step in either package. Its value
# is held to that bound; every other parameter to the stated tolerance.
SHIFT_FREE = "att_w.bias"


def _assert_params_match(got, want, init, lr, steps, tol):
    assert got.keys() == want.keys()
    for k in want:
        if k == SHIFT_FREE:
            bound = lr * steps * (1 + 1e-4) + 1e-6
            for v in (got[k], want[k]):
                assert float((v - init[k]).abs().max()) <= bound, k
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **tol)

def _separable(root, n=14, tiles=10, dim=8, seed=0, tumor=None):
    """``n`` slides whose class-1 tiles are shifted in two dimensions; with
    ``tumor`` (a path) also their is_Tumor set, other features at the same
    tile locations."""
    rng = np.random.default_rng(seed)
    targets = np.arange(n) % 2
    counts = rng.integers(3, tiles + 1, n)
    feats = _ragged_feats(rng, counts, tiles, dim)
    feats[targets == 1, :, :, :2] += 1.5
    names = [f"s{seed}_{i}.svs" for i in range(n)]
    if tumor is not None:
        other = _ragged_feats(rng, counts, tiles, dim)
        _write_data(str(tumor), names, other, targets)
    return _write_data(str(root), names, feats, targets)


@pytest.fixture
def jax_init(monkeypatch):
    """Record the JAX run's initial MIL weights and load them into the port's
    next model."""
    import tpuwsi.mil.train as j_train
    import tpuwsi_torch.mil.train as t_train

    init = {}
    real = j_train.create_train_state

    def recording(params, *a, **kw):
        init["params"] = jax.device_get(params)
        return real(params, *a, **kw)

    monkeypatch.setattr(j_train, "create_train_state", recording)
    monkeypatch.setattr(t_train, "init_mil_weights", lambda model, generator: model.load_state_dict(
        mil_params_from_flax(init["params"])))
    return init


def test_train_mil_head_matches_jax(tmp_path, jax_init):
    from tpuwsi.mil.train import train_mil_head as j_train_mil_head
    from tpuwsi_torch.mil.train import train_mil_head

    kw = dict(bag_size=6, minimum_tiles_in_slide=1)
    tr, ev = _separable(tmp_path / "tr.data"), _separable(tmp_path / "ev.data", n=8, seed=1)
    logs = {"j": [], "t": [], "t8": []}
    jmodel, jstate = j_train_mil_head(
        j_features.FeaturesMILDataset(tr, is_train=True, **kw), hidden_dim=6, epochs=3,
        batch_size=4, lr=3e-3, seed=2, eval_dataset=j_features.FeaturesMILDataset(ev, **kw),
        log_fn=lambda e, m: logs["j"].append(m))
    states = {}
    for tag, spd in (("t", 1), ("t8", 8)):
        model, states[tag] = train_mil_head(
            t_features.FeaturesMILDataset(tr, is_train=True, **kw), hidden_dim=6, epochs=3,
            batch_size=4, lr=3e-3, seed=2, eval_dataset=t_features.FeaturesMILDataset(ev, **kw),
            log_fn=lambda e, m, tag=tag: logs[tag].append(m), steps_per_dispatch=spd,
            device=CPU)
    assert states["t"].step == int(jstate.step) == 3 * 4
    want = mil_params_from_flax(jax.device_get(jstate.params))
    got = states["t"].model.state_dict()
    _assert_params_match(got, want, mil_params_from_flax(jax_init["params"]), 3e-3, 12,
                         TRAIN_TOL)
    assert len(logs["t"]) == len(logs["j"]) == 3
    for g, w in zip(logs["t"], logs["j"]):
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TRAIN_TOL)
    assert logs["t8"] == logs["t"]
    for k, v in states["t8"].model.state_dict().items():
        assert torch.equal(v, got[k]), k


def test_mil_step_uses_optax_adamw_on_every_leaf():
    """One step of ``make_mil_train_step`` against optax.adamw(lr) (weight
    decay 1e-4 on the biases too) from the same weights."""
    import optax

    from tpuwsi.mil.train import make_mil_train_step as j_make_step
    from tpuwsi.train.state import create_train_state as j_create_state
    from tpuwsi_torch.mil.train import make_mil_train_step
    from tpuwsi_torch.train.optim import AdamW
    from tpuwsi_torch.train.state import create_train_state

    feats, mask = _bags(7, b=4)
    labels = np.array([0, 1, 1, 0])
    jmodel = j_mil.GatedAttentionMIL(hidden_dim=5)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(mask))
    params = jax.tree_util.tree_map(lambda p: p + 0.3, params)  # biases away from 0
    tx = optax.adamw(1e-2)
    jstate = j_create_state(params, tx)
    model = t_mil.GatedAttentionMIL(16, hidden_dim=5)
    model.load_state_dict(mil_params_from_flax(jax.device_get(params)))
    opt = AdamW(lambda c: 1e-2, 0.9, 0.999, 1e-8, 1e-4, None, decay_1d=True)
    state = create_train_state(model, opt)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    jstep, step = jax.jit(j_make_step(jmodel, tx)), make_mil_train_step(model, opt)
    for _ in range(2):
        jstate, jm = jstep(jstate, {"features": jnp.asarray(feats), "mask": jnp.asarray(mask),
                                    "labels": jnp.asarray(labels)})
        state, m = step(state, {"features": torch.from_numpy(feats),
                                "mask": torch.from_numpy(mask),
                                "labels": torch.from_numpy(labels)})
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k, **MODEL_TOL)
    _assert_params_match(model.state_dict(), mil_params_from_flax(jax.device_get(jstate.params)),
                         init, 1e-2, 2, MODEL_TOL)


# -- the entry point ----------------------------------------------------------------

def _xlsx_cells(path):
    from tpuwsi_torch.utils.minixlsx import read_xlsx

    return read_xlsx(path)


def _assert_same_sheet(got, want, tol, shifts=(0.0, 0.0)):
    """Cell by cell; the scores before the softmax less each run's
    ``att_w.bias`` (``shifts``: the port's, the JAX run's)."""
    assert list(got) == list(want)
    for name in want:
        shift = shifts if name.startswith("attn_before") else (0.0, 0.0)
        for g, w in zip(got[name], want[name]):
            if isinstance(g, float):
                g, w = g - shift[0], w - shift[1]
            if isinstance(w, str):
                assert g == w, name
            elif w is None or (isinstance(w, float) and np.isnan(w)):
                assert g is None or np.isnan(g), name
            else:
                np.testing.assert_allclose(g, w, err_msg=name, **tol)


@pytest.mark.parametrize("source", ["features", "registry-paired"])
def test_main_matches_jax_main(tmp_path, monkeypatch, jax_init, source):
    from tpuwsi.cli.mil_train import main as jmain
    from tpuwsi_torch.cli.mil_train import main
    from tpuwsi_torch.train.checkpoint import load_checkpoint

    if source == "features":
        tr, ev = _separable(tmp_path / "tr.data"), _separable(tmp_path / "ev.data", n=8, seed=1)
        argv = ["--features", tr, "--test-features", ev, "--minimum-tiles", "2"]
    else:
        sets = {}
        for split, n, seed in (("train", 14, 0), ("test", 8, 1)):
            sets[split] = (str(tmp_path / "receptor" / split / "a.data"),
                           str(tmp_path / "tumor" / split / "a.data"))
            _separable(sets[split][0], n=n, seed=seed, tumor=sets[split][1])
        path = tmp_path / "registry.json"
        locs = {"TrainSet Location": {k: v[0] for k, v in sets.items()},
                "is_Tumor": {"TrainSet Location": {k: v[1] for k, v in sets.items()}}}
        path.write_text(json.dumps({"CAT": {"ER": {"1": locs}}}))
        monkeypatch.setenv("TPUWSI_FEATURE_REGISTRY", str(path))
        argv = ["--dataset", "CAT", "-tar", "ER", "-tf", "1", "--paired-is-tumor",
                "--minimum-tiles", "2"]
    argv += ["--bag-size", "5", "--epochs", "3", "-b", "3", "--lr", "3e-3", "--hidden-dim",
             "6", "--seed", "1", "--export-xlsx"]
    _, jstate, jfinal = jmain(argv + ["--output", str(tmp_path / "j")])
    model, state, final = main(argv + ["--output", str(tmp_path / "t")], device=CPU)
    assert state.step == int(jstate.step)
    assert list(final) == list(jfinal) and final["eval_n_slides"] == jfinal["eval_n_slides"]
    for k in jfinal:
        np.testing.assert_allclose(final[k], jfinal[k], err_msg=k, **MODEL_TOL)
    shifts = (float(model.att_w.bias.detach()), float(jstate.params["params"]["att_w"]["bias"][0]))
    _assert_same_sheet(_xlsx_cells(str(tmp_path / "t" / "slide_scores.xlsx")),
                       _xlsx_cells(str(tmp_path / "j" / "slide_scores.xlsx")), MODEL_TOL, shifts)
    saved = load_checkpoint(str(tmp_path / "t" / "checkpoints"))
    assert saved["step"] == state.step
    for k, v in model.state_dict().items():
        assert torch.equal(saved["params"][k], v), k


def test_ef_inference_data_reads_back_and_trains(tmp_path, monkeypatch):
    """``-ef`` over the PNG cohort of ``test_torch_wsi.py`` (test fold 1):
    the port's ``inference.data`` holds each slide's features, the port's and
    the JAX package's ``FeaturesMILDataset`` read the same bags from it, and
    the port's MIL trainer runs over it."""
    from test_torch_wsi import write_cohort
    from tpuwsi_torch.cli.mil_train import main as mil_main
    from tpuwsi_torch.cli.train import main

    root = str(tmp_path / "cohort")
    write_cohort(root)
    agg = main(["-ef", "--dataset", "TCGA", "--data-root", root, "--model",
                "vit_tiny_patch8_224", "--tile-size", "32", "-nt", "6", "-tpi", "4", "--mag",
                "10", "--output", str(tmp_path / "ef")], device=CPU)
    data = next(os.path.join(d, "inference.data") for d, _, files in os.walk(tmp_path / "ef")
                if "inference.data" in files)
    kw = dict(bag_size=4, minimum_tiles_in_slide=1)
    got = t_features.FeaturesMILDataset(data, **kw)
    want = j_features.FeaturesMILDataset(data, **kw)
    assert got.slide_names == [r.slide_name for r in agg.results]
    for f, r in zip(got.features, agg.results):
        np.testing.assert_array_equal(f, r.features.astype(np.float32))
    _equal(list(got.bags(np.random.default_rng(0), 2)), list(want.bags(np.random.default_rng(0), 2)),
           "bags")
    _, state, final = mil_main(["--features", data, "--test-features", data, "--minimum-tiles",
                                "1", "--bag-size", "4", "--epochs", "2", "-b", "2", "--output",
                                str(tmp_path / "mil"), "--export-xlsx"], device=CPU)
    assert state.step == 2 * -(-len(got) // 2)
    assert final["eval_n_slides"] == len(got)
    assert os.path.isfile(tmp_path / "mil" / "slide_scores.xlsx")
