"""tpuwsi_torch's DINO trainer held against the JAX package on the CPU.

- ``CheckpointManager``: the steps kept, ``best_step`` and ``latest_step``
  equal Orbax's (through ``tpuwsi.train.checkpoint``) for the same
  ``(step, metrics)`` sequences; a save and restore of the DINO state is
  bit-exact, and a step after a restore gives the bits of a step without.
- ``knn_classify``: the JAX probe's probabilities at 1e-5, its labels exactly.
- ``remat_blocks``: the ViT's gradients with recomputation equal those
  without, bit for bit, with stochastic depth, attention and MLP dropout
  drawn from one generator; and they match the JAX package's remat ViT at
  1e-4. ``return_last_attention`` and ``intermediate_layers`` at 1e-4.
- ``main(..., device=cpu)``: one step, ``summary.csv`` with the probe; the
  refusals with the JAX CLI's messages; the unported modes by name.
- The whole loop against the JAX ``main``: the same folder, the JAX initial
  weights carried across with ``params_from_flax``, a deterministic
  multi-crop put in both packages by this test, drop-path 0, fp32, depth 3:
  per-step losses at 1e-4 and the same probe accuracy over 2 epochs x 2 steps.
- A subprocess runs the PNG-folder loop with no jax, flax, tpuwsi or PIL
  module loaded.
"""

import csv
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpuwsi.models import vit as jvit
from tpuwsi.ssl_dino import knn as jknn
from tpuwsi_torch.models import vit as tvit
from tpuwsi_torch.models.convert import params_from_flax, params_to_flax
from tpuwsi_torch.ssl_dino import knn as tknn
from tpuwsi_torch.train.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TINY_ARGV = ["--ssl", "--model", "vit_tiny_patch16_224", "-b", "4", "--warmup-epochs", "0",
             "--lr", "1e-4", "--dino-out-dim", "128", "--dino-global-size", "32",
             "--dino-local-size", "16", "--dino-local-crops", "2"]
BENCH_ARGV = ["--ssl", "--model", "vit_small_patch16_224_dino", "--epochs", "3",
              "--warmup-epochs", "1", "--opt", "adamw", "--lr-base", "0.0005",
              "--weight-decay", "0.04", "--dino-out-dim", "64", "--dino-global-size", "32",
              "--dino-local-size", "16", "--dino-local-crops", "2"]
TINY_VIT = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2)


@pytest.fixture
def patch_folder(tmp_path):
    """test_cli.py's folder: two classes of 8 noisy 32-px tiles, 40 and 200 grey."""
    rng = np.random.default_rng(0)
    for cls, base in (("neg", 40), ("pos", 200)):
        os.makedirs(tmp_path / "train" / cls)
        for i in range(8):
            arr = np.clip(rng.normal(base, 20, (32, 32, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(tmp_path / "train" / cls / f"{i}.png")
    return str(tmp_path / "train")


# -- checkpoints ---------------------------------------------------------------

CKPT_CASES = [
    # max_history, mode, rank_by_metric, [(step, metrics)]
    (2, "min", True, [(3, {"loss": 1.0}), (6, {"loss": 0.5}), (9, {"loss": 2.0}),
                      (12, {"loss": 0.7}), (15, {"loss": 0.1})]),
    (3, "max", True, [(1, {"auc": 0.5}), (2, {"auc": 0.9}), (3, {"auc": 0.5}), (4, {}),
                      (5, {"auc": 0.9}), (6, {"auc": 0.1}), (7, {"auc": 0.5})]),
    (2, "min", True, [(1, {"loss": 2.0}), (2, {"loss": 2.0}), (3, {"loss": 2.0}),
                      (2, {"loss": 0.0}), (4, {"loss": 3.0, "knn_acc": 1.0})]),
    (2, "max", False, [(1, {}), (2, {"auc": 1.0}), (3, {}), (4, {"auc": 0.0})]),
    (1, "max", True, [(10, {"auc": 0.2}), (20, {"auc": 0.1}), (30, {"auc": 0.3})]),
    (10, "min", True, [(3, {"loss": 4.5}), (6, {"loss": 4.4})]),
]


@pytest.mark.parametrize("max_history,mode,rank,seq", CKPT_CASES)
def test_checkpoint_manager_keeps_orbaxs_steps(tmp_path, max_history, mode, rank, seq):
    from tpuwsi.train.checkpoint import CheckpointManager as JCheckpointManager

    metric = "loss" if mode == "min" else "auc"
    j = JCheckpointManager(str(tmp_path / "j"), max_history=max_history, metric_name=metric,
                           mode=mode, rank_by_metric=rank)
    t = CheckpointManager(str(tmp_path / "t"), max_history=max_history, metric_name=metric,
                          mode=mode, rank_by_metric=rank)
    try:
        for step, metrics in seq:
            j.save(step, {"w": jnp.full((2,), float(step))}, metrics)
            t.save(step, {"w": torch.full((2,), float(step))}, metrics)
            j.wait()
            kept = sorted(int(d) for d in os.listdir(tmp_path / "j") if d.isdigit())
            assert t.all_steps() == kept == sorted(j._mgr.all_steps()), step
            assert sorted(os.listdir(tmp_path / "t")) == sorted(str(s) for s in kept)
            assert t.best_step() == j.best_step(), step
            assert t.latest_step() == j.latest_step(), step
        for step in t.all_steps():
            assert t.restore(step)["w"][0].item() == float(step)
        reopened = CheckpointManager(str(tmp_path / "t"), max_history=max_history,
                                     metric_name=metric, mode=mode, rank_by_metric=rank)
        assert reopened.all_steps() == t.all_steps()
        assert reopened.best_step() == t.best_step()
    finally:
        j.close()
        t.close()


def _bundle(seed: int, extra=()):
    from tpuwsi_torch.cli.args import parse_args
    from tpuwsi_torch.cli.train import ssl_step_bundle

    args = parse_args(BENCH_ARGV + ["--seed", str(seed), "--drop-path", "0.2", *extra])
    return ssl_step_bundle(args, 4, 4, CPU, vit_overrides=TINY_VIT)


def _flat(sd, prefix=""):
    for k, v in sd.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        elif isinstance(v, (list, tuple)):
            yield from _flat(dict(enumerate(v)), f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_same_state(a, b):
    fa, fb = dict(_flat(a.state_dict())), dict(_flat(b.state_dict()))
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_state_round_trip_is_bit_exact(tmp_path):
    images = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, 40, 40, 3), dtype=np.uint8))
    b = _bundle(seed=1)
    for _ in range(2):
        b.raw_step(b.state, {"images": images}, b.generator)
    mgr = CheckpointManager(str(tmp_path / "ck"), metric_name="loss", mode="min")
    assert mgr.save(b.state.step, b.state, {"loss": 1.0})
    assert not mgr.save(b.state.step, b.state, {"loss": 0.0})  # not after the latest
    fresh = _bundle(seed=9)  # other weights, other generator
    assert not torch.equal(fresh.model.backbone.pos_embed, b.model.backbone.pos_embed)
    assert mgr.restore(target=fresh.state) is fresh.state
    mgr.close()
    _assert_same_state(b.state, fresh.state)
    assert fresh.state.step == 2 and fresh.state.opt_state.count == 2
    assert fresh.state.student is fresh.model  # restored in place
    _, m1 = b.raw_step(b.state, {"images": images}, b.generator)
    _, m2 = fresh.raw_step(fresh.state, {"images": images}, fresh.generator)
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_same_state(b.state, fresh.state)
    from tpuwsi_torch.train.checkpoint import load_checkpoint

    saved = load_checkpoint(str(tmp_path / "ck"))
    assert saved["step"] == 2 and set(saved) == {"step", "student", "teacher", "opt_state",
                                                 "center", "generator"}


def test_ledger_and_summary_match_reference(tmp_path):
    from tpuwsi.utils import ledger as jledger, runlog as jrunlog
    from tpuwsi_torch.utils import ledger as tledger, runlog as trunlog

    records = {}
    for side, mod in (("j", jledger), ("t", tledger)):
        led = mod.ExperimentLedger(str(tmp_path / side))
        first = led.create("ER", test_fold=2, DataSet="TCGA", Model="vit")
        second = led.create("ER", name="dino", subname="a", **{"Tile Size": 256})
        led.update(first["Experiment"], **{"Last Epoch": 3})
        with pytest.raises(KeyError):
            led.update(9)
        assert os.path.isdir(first["Location"]) and os.path.isdir(second["Location"])
        records[side] = ({k: {f: v for f, v in r.items() if f != "Location"}
                          for k, r in led.all_experiments().items()},
                         [os.path.relpath(x["Location"], tmp_path / side)
                          for x in (first, second)], led.resume(1)["Last Epoch"])
        for epoch in range(2):
            mod_runlog = jrunlog if side == "j" else trunlog
            mod_runlog.update_summary(epoch, {"loss": 1.5 - epoch},
                                      {"knn_acc": 0.25 * epoch},
                                      str(tmp_path / f"{side}.csv"), write_header=epoch == 0)
    assert records["t"] == records["j"]
    assert records["t"][1] == ["Exp_1-ER-TestFold_2", os.path.join("Exp_2-dino-TestFold_1", "a")]
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    # run_data.xlsx: both exports read back by the JAX package's reader alike
    from tpuwsi.utils.minixlsx import read_xlsx as j_read_xlsx

    exported = {side: j_read_xlsx(mod.ExperimentLedger(str(tmp_path / side)).export_xlsx())
                for side, mod in (("j", jledger), ("t", tledger))}
    for frame in exported.values():
        frame["Location"] = [os.path.relpath(p, os.path.dirname(p.rsplit("Exp_", 1)[0]))
                             for p in frame["Location"]]
    assert exported["t"].columns.tolist() == exported["j"].columns.tolist()
    assert exported["t"].equals(exported["j"])


# -- kNN ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,temperature,num_classes", [(20, 0.07, None), (5, 0.1, 4),
                                                       (1, 0.07, 3), (50, 0.5, None)])
def test_knn_matches_jax(k, temperature, num_classes):
    rng = np.random.default_rng(k)
    tr = rng.standard_normal((40, 16)).astype(np.float32)
    te = rng.standard_normal((13, 16)).astype(np.float32)
    labels = rng.integers(0, 3, 40)
    want_l, want_p = jknn.knn_classify(jnp.asarray(tr), jnp.asarray(labels), jnp.asarray(te),
                                       k=k, temperature=temperature, num_classes=num_classes)
    got_l, got_p = tknn.knn_classify(torch.from_numpy(tr), torch.from_numpy(labels),
                                     torch.from_numpy(te), k=k, temperature=temperature,
                                     num_classes=num_classes)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5, rtol=1e-5)
    test_labels = rng.integers(0, 3, 13)
    assert tknn.knn_accuracy(torch.from_numpy(tr), torch.from_numpy(labels),
                             torch.from_numpy(te), torch.from_numpy(test_labels), k=k) == \
        jknn.knn_accuracy(jnp.asarray(tr), jnp.asarray(labels), jnp.asarray(te),
                          jnp.asarray(test_labels), k=k)


# -- the ViT: recomputation, attention map, intermediate layers ------------------------

GEOM = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2)


def _port_grads(cfg, x, seed=5):
    torch.manual_seed(0)
    model = tvit.VisionTransformer(cfg)
    gen = torch.Generator().manual_seed(seed)
    out = model(x, deterministic=False, generator=gen)
    grads = torch.autograd.grad(out.square().sum(), list(model.parameters()))
    return out, grads, gen.get_state()


@pytest.mark.parametrize("policy", ["auto", None, "dots_saveable"])
@pytest.mark.parametrize("save_probs", [False, True])
def test_remat_gradients_equal_the_stored_ones(policy, save_probs):
    cfg = tvit.ViTConfig(**GEOM, dtype=torch.float32, drop_path_rate=0.3, attn_drop_rate=0.2,
                         drop_rate=0.1, attn_save_probs=save_probs, num_classes=3)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 32, 32, 3),
                                                                  dtype=np.float32))
    out0, g0, s0 = _port_grads(cfg, x)
    out1, g1, s1 = _port_grads(dataclasses.replace(cfg, remat_blocks=True, remat_policy=policy),
                               x)
    assert torch.equal(out0, out1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert torch.equal(s0, s1)  # the recompute left the generator where the forward had


def test_remat_policy_names():
    assert tvit.REMAT_POLICIES["auto"] is None and tvit.REMAT_POLICIES[None] is None
    for bad in ("dots_saveable+attn_out", "save_only_these_names",
                "offload_dot_with_no_batch_dims", "nothing_saveable", "everything_saveable"):
        with pytest.raises(ValueError, match="no counterpart") as e:
            tvit.VisionTransformer(tvit.ViTConfig(**GEOM, remat_blocks=True, remat_policy=bad))
        assert "'dots_saveable'" in str(e.value)
    # an unknown name is refused only where recomputation is on, as in the reference
    tvit.VisionTransformer(tvit.ViTConfig(**GEOM, remat_policy="save_only_these_names"))


def _flax_pair(remat=False, **kw):
    cfg = jvit.ViTConfig(**GEOM, dtype=jnp.float32, use_pallas_attention=True,
                         pallas_interpret=True, remat_blocks=remat, **kw)
    model = jvit.VisionTransformer(cfg)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(
        lambda v: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32), variables)
    port = tvit.VisionTransformer(tvit.ViTConfig(**GEOM, dtype=torch.float32,
                                                 remat_blocks=remat, **kw))
    port.load_state_dict(params_from_flax(variables))
    return model, variables, port


@pytest.mark.parametrize("num_classes", [0, 2])
def test_remat_gradients_match_jax(num_classes):
    model, variables, port = _flax_pair(remat=True, num_classes=num_classes)
    x = np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(np.float32)

    def loss(params):
        return jnp.sum(model.apply({"params": params}, jnp.asarray(x), deterministic=False) ** 2)

    want = jax.device_get(jax.grad(loss)(variables["params"]))
    out = port(torch.from_numpy(x), deterministic=False, generator=torch.Generator())
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(out.square().sum(), list(port.parameters()))
    got = params_to_flax(dict(zip(names, grads)))["params"]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_got.keys() == flat_want.keys()
    for key in flat_want:
        np.testing.assert_allclose(flat_got[key], flat_want[key], atol=1e-4, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(key))


@pytest.mark.parametrize("depth_back", [1, 2])
def test_attention_map_and_intermediate_layers_match_jax(depth_back):
    model, variables, port = _flax_pair()
    x = np.random.default_rng(3).standard_normal((3, 32, 32, 3)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = model.apply(variables, xj, return_last_attention=True)
    with torch.no_grad():
        got = port(xt, return_last_attention=True)
    assert got.shape == (3, 2, 17, 17) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    want = model.apply(variables, xj, intermediate_layers=depth_back)
    with torch.no_grad():
        got = port(xt, intermediate_layers=depth_back)
    assert len(got) == len(want) == depth_back
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    with torch.no_grad():  # the last of them is the model's own normed tokens
        np.testing.assert_array_equal(got[-1].numpy(), port(xt, return_all_tokens=True).numpy())
        # the reference returns the map where both are asked
        both = port(xt, return_last_attention=True, intermediate_layers=depth_back)
    assert both.shape == (3, 2, 17, 17)


def test_grad_checkpointing_reaches_the_models():
    from tpuwsi_torch.models.registry import create_model

    assert create_model("vit_tiny_patch16_224", grad_checkpointing=True).config.remat_blocks
    b = _bundle(seed=0, extra=["--grad-checkpointing"])
    assert b.model.backbone.config.remat_blocks
    images = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, 40, 40, 3), dtype=np.uint8))
    ref = _bundle(seed=0)
    for _ in range(2):
        _, m1 = b.raw_step(b.state, {"images": images}, b.generator)
        _, m2 = ref.raw_step(ref.state, {"images": images}, ref.generator)
        assert torch.equal(m1["loss"], m2["loss"])  # drop-path 0.2, the same masks
    _assert_same_state(b.state, ref.state)


# -- the entry point ---------------------------------------------------------------

def _run_dir(out):
    return [os.path.join(out, e) for e in os.listdir(out) if e.startswith("Exp_")][0]


def test_main_trains_and_probes_on_cpu(patch_folder, tmp_path):
    from tpuwsi_torch.cli.train import main

    out = str(tmp_path / "runs_knn")
    state = main(TINY_ARGV + ["--data-dir", patch_folder, "--epochs", "1",
                              "--max-steps-per-epoch", "1", "--knn-eval-rate", "1",
                              "--output", out], device=CPU)
    assert state.step == 1
    run_dir = _run_dir(out)
    with open(os.path.join(run_dir, "summary.csv")) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["epoch", "train_loss", "eval_knn_acc"]
    assert 0.0 <= float(rows[0]["eval_knn_acc"]) <= 1.0
    assert os.listdir(os.path.join(run_dir, "checkpoints")) == ["1"]
    assert os.path.isfile(os.path.join(out, "log.txt"))
    assert os.path.isfile(os.path.join(out, "run_data.jsonl"))
    with open(os.path.join(out, "log.txt")) as f:
        log = f.read()
    assert "ssl epoch 0 knn@20 acc" in log and "waiting on the data" in log


REFUSED = [
    ["--pretrained"],
    ["--drop-connect", "0.1"],
    ["--model", "resnet50", "--model-parallel", "2"],
    ["--ssl", "--dataset", "TCGA", "--knn-eval-rate", "1", "--data-root", "nope"],
    ["--ssl", "--input-size", "3", "32", "48", "--data-dir", "x"],
]


@pytest.mark.parametrize("argv", REFUSED)
def test_refusals_match_the_jax_cli(argv, tmp_path):
    from tpuwsi.cli.train import main as jmain
    from tpuwsi_torch.cli.train import main as tmain

    with pytest.raises(SystemExit) as want:
        jmain(argv + ["--output", str(tmp_path / "j")])
    with pytest.raises(SystemExit) as got:
        tmain(argv + ["--output", str(tmp_path / "t")], device=CPU)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("argv,item", [
    (["--ssl", "--dataset", "TMA_HE_02_008"], "M1"),  # M1b: the TMA cohorts' JPEG cores
    (["--mixup", "0.2"], "M3b"),
    (["-ef", "--dataset", "TMA_HE_01_011"], "M1"),
    (["--target", "Survival_Time"], "M5"),
    (["--ssl", "--data-dir", "x", "--model-parallel", "2"], "M7"),
])
def test_unported_modes_raise_by_name(argv, item, tmp_path):
    from tpuwsi_torch.cli.train import main

    out = tmp_path / "runs"
    with pytest.raises(NotImplementedError, match=item):
        main(argv + ["--output", str(out)], device=CPU)
    assert not out.exists()  # refused before any file was written


def test_main_needs_a_card_or_the_cpu_by_name(patch_folder, tmp_path, monkeypatch):
    from tpuwsi_torch.cli.train import main

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="M7"):
        main(TINY_ARGV + ["--data-dir", patch_folder, "--output", str(tmp_path)], device=CPU)
    monkeypatch.delenv("WORLD_SIZE")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(TINY_ARGV + ["--data-dir", patch_folder, "--output", str(tmp_path / "x")])
        assert not (tmp_path / "x").exists()


# -- the whole loop against the JAX main ----------------------------------------------

def _det_views(xp, flip, stack, normalize, n_local):
    """Two global views (the tile, mirrored) and n_local fixed 16-px corners."""
    def fn(_, images):
        x = images.astype(xp.float32) / 255.0 if xp is jnp else images.float() / 255.0
        g = stack([x, flip(x)], 1)
        corners = [x[:, :16, :16], x[:, 16:, 16:], x[:, :16, 16:], x[:, 16:, :16]]
        return normalize(g, "Ron"), normalize(stack(corners[:n_local], 1), "Ron")
    return fn


def test_loop_matches_jax_main(patch_folder, tmp_path, monkeypatch):
    from tpuwsi.cli import train as jtrain
    from tpuwsi.core import compile as jcompile
    from tpuwsi.preprocess import multicrop as jmc
    from tpuwsi.preprocess.normalize import normalize as jnormalize
    from tpuwsi_torch.cli import train as ttrain
    from tpuwsi_torch.preprocess import multicrop as tmc
    from tpuwsi_torch.preprocess.normalize import normalize as tnormalize

    argv = TINY_ARGV + ["--data-dir", patch_folder, "--epochs", "2", "--max-steps-per-epoch",
                        "2", "--knn-eval-rate", "1", "--drop-path", "0", "--log-interval", "1"]
    jcfg, tcfg = jtrain.ssl_backbone_config, ttrain.ssl_backbone_config
    monkeypatch.setattr(jtrain, "ssl_backbone_config", lambda a, f: dataclasses.replace(
        jcfg(a, f), dtype=jnp.float32, depth=3))
    monkeypatch.setattr(ttrain, "ssl_backbone_config", lambda a, f: dataclasses.replace(
        tcfg(a, f), dtype=torch.float32, depth=3))
    monkeypatch.setattr(jmc, "make_multicrop", lambda cfg: _det_views(
        jnp, lambda x: x[:, :, ::-1], lambda v, a: jnp.stack(v, axis=a), jnormalize,
        cfg.n_local))
    monkeypatch.setattr(tmc, "make_multicrop", lambda cfg: _det_views(
        torch, lambda x: torch.flip(x, dims=[2]), lambda v, a: torch.stack(v, dim=a),
        tnormalize, cfg.n_local))

    jax_losses, bundles = [], []
    real_sched, real_jbundle = jcompile.scheduled_step, jtrain.ssl_step_bundle

    def recording_sched(fn):
        step = real_sched(fn)

        def run(state, batch, rng):
            state, metrics = step(state, batch, rng)
            jax_losses.append(float(metrics["loss"]))
            return state, metrics
        return run

    monkeypatch.setattr(jcompile, "scheduled_step", recording_sched)
    monkeypatch.setattr(jtrain, "ssl_step_bundle",
                        lambda *a, **kw: bundles.append(real_jbundle(*a, **kw)) or bundles[-1])
    jtrain.main(argv + ["--output", str(tmp_path / "j")])
    jparams = jax.device_get(bundles[0].params)

    port_losses, real_tbundle = [], ttrain.ssl_step_bundle

    def recording_bundle(*a, **kw):
        b = real_tbundle(*a, **kw)
        step = b.raw_step

        def run(state, batch, generator):
            state, metrics = step(state, batch, generator)
            port_losses.append(metrics["loss"].item())
            return state, metrics
        b.raw_step = run
        return b

    monkeypatch.setattr(ttrain, "ssl_step_bundle", recording_bundle)
    monkeypatch.setattr(ttrain, "init_dino_weights",
                        lambda model, seed: model.load_state_dict(params_from_flax(jparams)))
    state = ttrain.main(argv + ["--output", str(tmp_path / "t")], device=CPU)

    assert state.step == 4 and len(port_losses) == len(jax_losses) == 4
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    rows = {}
    for side in ("j", "t"):
        with open(os.path.join(_run_dir(str(tmp_path / side)), "summary.csv")) as f:
            rows[side] = list(csv.DictReader(f))
    assert len(rows["t"]) == len(rows["j"]) == 2
    for t, j in zip(rows["t"], rows["j"]):
        assert t["eval_knn_acc"] == j["eval_knn_acc"]
        np.testing.assert_allclose(float(t["train_loss"]), float(j["train_loss"]), rtol=1e-4)
    steps = {side: sorted(os.listdir(os.path.join(_run_dir(str(tmp_path / side)),
                                                  "checkpoints")))
             for side in ("j", "t")}
    assert steps["t"] == steps["j"] == ["2", "4"]


_NO_JAX_LOOP = r"""
import os, struct, sys, tempfile, zlib
import numpy as np, torch

def png(img):
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))  # filter None
    chunk = lambda k, b: struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))

root = tempfile.mkdtemp()
rng = np.random.default_rng(0)
for c, base in (("a", 40), ("b", 200)):
    os.makedirs(os.path.join(root, "data", c))
    for i in range(5):
        img = np.clip(rng.normal(base, 20, (32, 32, 3)), 0, 255).astype(np.uint8)
        open(os.path.join(root, "data", c, f"{i}.png"), "wb").write(png(img))
from tpuwsi_torch.cli.train import main
state = main(["--ssl", "--data-dir", os.path.join(root, "data"), "--model",
              "vit_tiny_patch16_224", "-b", "4", "--epochs", "1", "--max-steps-per-epoch", "1",
              "--warmup-epochs", "0", "--lr", "1e-4", "--dino-out-dim", "64",
              "--dino-global-size", "32", "--dino-local-size", "16", "--dino-local-crops", "2",
              "--knn-eval-rate", "1", "--output", os.path.join(root, "runs")],
             device=torch.device("cpu"))
assert state.step == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "tpuwsi", "PIL"))
assert not bad, bad
"""


def test_folder_loop_runs_without_jax_or_pil():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_LOOP], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
