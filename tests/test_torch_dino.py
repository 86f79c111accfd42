"""tpuwsi_torch's DINO head, loss, training step and step bundle held against
the JAX package on the CPU, in fp32, at a tiny geometry.

Inputs and weights come from a numpy seed or from the JAX model's own init
and go through both packages; weights cross over through
``params_from_flax`` and come back through ``params_to_flax``. Tolerances:
1e-5 on the head and the loss (the same fp32 math in another summation
order); over the 12-step trajectory 1e-4 relative on each step's loss, 1e-5
on the centre and 1e-4 on every student and teacher leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuwsi.models.dino_head import DINOHead as JDINOHead
from tpuwsi.models.vit import ViTConfig as JViTConfig, VisionTransformer as JViT
from tpuwsi.ssl_dino import dino as jdino
from tpuwsi.train.optim import OptimConfig as JOptimConfig, make_optimizer as jmake_optimizer
from tpuwsi_torch.models.convert import params_from_flax, params_to_flax
from tpuwsi_torch.models.dino_head import DINOHead
from tpuwsi_torch.models.vit import ViTConfig, VisionTransformer
from tpuwsi_torch.ssl_dino import dino as tdino
from tpuwsi_torch.train.ema import cosine_momentum_schedule
from tpuwsi_torch.train.optim import OptimConfig, make_optimizer, make_schedule

BENCH_ARGV = ["--ssl", "--model", "vit_small_patch16_224_dino", "--epochs", "300",
              "--warmup-epochs", "10", "--opt", "adamw", "--lr-base", "0.0005",
              "--weight-decay", "0.04"]
HEAD = dict(out_dim=96, hidden_dim=48, bottleneck_dim=16, gelu_approx=True)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("norm_last_layer", [True, False])
@pytest.mark.parametrize("nlayers,use_bn", [(3, False), (1, False), (2, True)])
def test_dino_head_matches_jax(nlayers, use_bn, norm_last_layer):
    rng = np.random.default_rng(nlayers)
    x = rng.standard_normal((6, 24), dtype=np.float32)
    jhead = JDINOHead(nlayers=nlayers, use_bn=use_bn, norm_last_layer=norm_last_layer, **HEAD)
    variables = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _np_tree(variables["params"])
    # a gain away from 1 shows whether g is applied
    params["last_layer"]["g"] = rng.uniform(0.5, 1.5, params["last_layer"]["g"].shape
                                            ).astype(np.float32)
    ref = jhead.apply({**variables, "params": params}, jnp.asarray(x))
    head = DINOHead(24, nlayers=nlayers, use_bn=use_bn, norm_last_layer=norm_last_layer, **HEAD)
    sd = params_from_flax({"backbone": _tiny_backbone_tree(), "head": params})
    head.load_state_dict({k[5:]: v for k, v in sd.items() if k.startswith("head.")},
                         strict=False)
    out = head(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    out.sum().backward()
    assert (head.last_layer.g.grad is None) == norm_last_layer


_TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2, gelu_approx=True)


def _tiny_backbone_tree():
    model = JViT(JViTConfig(dtype=jnp.float32, use_pallas_attention=False, **_TINY))
    return _np_tree(model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))["params"])


@pytest.mark.parametrize("pair_bf16", [False, True])
@pytest.mark.parametrize("teacher_temp", [0.04, 0.07])
def test_dino_loss_matches_jax(teacher_temp, pair_bf16):
    rng = np.random.default_rng(5)
    s = rng.standard_normal((5, 4, 64), dtype=np.float32)
    t = rng.standard_normal((2, 4, 64), dtype=np.float32)
    c = 0.1 * rng.standard_normal((1, 64), dtype=np.float32)
    ref_loss, ref_center = jdino.dino_loss(
        *map(jnp.asarray, (s, t, c)), 0.1, teacher_temp, 2,
        pair_dtype=jnp.bfloat16 if pair_bf16 else jnp.float32)
    st = torch.from_numpy(s).requires_grad_()
    loss, center = tdino.dino_loss(
        st, torch.from_numpy(t), torch.from_numpy(c), 0.1, teacher_temp, 2,
        pair_dtype=torch.bfloat16 if pair_bf16 else torch.float32)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(center.numpy(), np.asarray(ref_center), atol=1e-6)
    ref_grad = jax.grad(lambda x: jdino.dino_loss(
        x, jnp.asarray(t), jnp.asarray(c), 0.1, teacher_temp, 2,
        pair_dtype=jnp.bfloat16 if pair_bf16 else jnp.float32)[0])(jnp.asarray(s))
    loss.backward()
    # the bf16 cast rounds the cotangent once in each package
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(ref_grad),
                               atol=2e-4 if pair_bf16 else 1e-6)


def test_schedules_match_jax():
    jcfg = JOptimConfig(opt="adamw", lr=3e-3, sched="cosine", epochs=3, warmup_epochs=1,
                        steps_per_epoch=5, min_lr=1e-5)
    cfg = OptimConfig(**dataclasses.asdict(jcfg))
    _, jsched = jmake_optimizer(jcfg, {"w": jnp.zeros((2, 2))}, 4)
    sched = make_schedule(cfg, cfg.resolved_lr(4))
    for count in range(18):
        np.testing.assert_allclose(sched(count), float(jsched(count)), rtol=1e-5)
    assert OptimConfig(base_lr=5e-4, lr_base_scale="sqrt").resolved_lr(96) == pytest.approx(
        JOptimConfig(base_lr=5e-4, lr_base_scale="sqrt").resolved_lr(96))
    dcfg = dict(warmup_teacher_temp=0.04, teacher_temp=0.07, warmup_teacher_temp_steps=5,
                ema_base=0.99, total_steps=12)
    jt = jdino.teacher_temp_schedule(jdino.DINOConfig(**dcfg))
    tt = tdino.teacher_temp_schedule(tdino.DINOConfig(**dcfg))
    jm = jdino.cosine_momentum_schedule(0.99, 1.0, 12)
    tm = cosine_momentum_schedule(0.99, 1.0, 12)
    for step in range(14):
        np.testing.assert_allclose(tt(step), float(jt(step)), rtol=1e-6)
        np.testing.assert_allclose(tm(step), float(jm(step)), rtol=1e-6)


@pytest.mark.parametrize("opt,what", [("rmsprop", "optimizer"), ("lamb", "optimizer")])
def test_unported_optimizers_raise(opt, what):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer(OptimConfig(opt=opt), 96)


@pytest.mark.parametrize("kw", [dict(sched="step"), dict(weight_decay_end=0.4),
                                dict(layer_decay=0.75), dict(clip_grad=1.0, clip_mode="agc")])
def test_unported_optimizer_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer(OptimConfig(opt="adamw", **kw), 96)


# (peak lr, warm-up lr, clip): at this init the gradient norm starts in the
# thousands, so the step's clip at 3.0 bites (at the faster rate the norm
# falls under 3.0 within the 12 steps, so both branches run); the clip at 1e4
# never does
@pytest.mark.parametrize("lr,warmup_lr,clip_grad,clip_bites", [
    (2e-3, 1e-5, 3.0, True), (4e-3, 1e-4, 3.0, True), (2e-3, 1e-5, 1e4, False)])
def test_dino_trajectory_matches_jax(lr, warmup_lr, clip_grad, clip_bites):
    n_steps, batch = 12, 4
    rng = np.random.default_rng(11)
    g_views = rng.standard_normal((batch, 2, 32, 32, 3), dtype=np.float32)
    l_views = rng.standard_normal((batch, 3, 16, 16, 3), dtype=np.float32)
    dkw = dict(out_dim=HEAD["out_dim"], n_local=3, teacher_temp=0.07, warmup_teacher_temp=0.04,
               warmup_teacher_temp_steps=6, ema_base=0.9, total_steps=n_steps,
               freeze_last_layer_steps=2)
    okw = dict(opt="adamw", lr=lr, warmup_lr=warmup_lr, sched="cosine", epochs=2,
               warmup_epochs=1, steps_per_epoch=6, clip_grad=clip_grad, weight_decay=0.04)

    jmodel = jdino.DINOModel(
        backbone=JViT(JViTConfig(dtype=jnp.float32, use_pallas_attention=True,
                                 pallas_interpret=True, attn_save_probs=True, **_TINY)),
        head=JDINOHead(**HEAD))
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    tx, _ = jmake_optimizer(JOptimConfig(**okw), jparams, batch)
    jcfg = jdino.DINOConfig(**dkw)
    jstate = jdino.create_dino_state(jparams, tx, jcfg)
    jstep = jax.jit(jdino.make_dino_train_step(jmodel.apply, tx, jcfg))
    jbatch = {"globals": jnp.asarray(g_views), "locals": jnp.asarray(l_views)}

    model = tdino.DINOModel(
        VisionTransformer(ViTConfig(dtype=torch.float32, attn_save_probs=True, **_TINY)),
        DINOHead(64, **HEAD))
    model.load_state_dict(params_from_flax(_np_tree(jparams)))
    optimizer, _ = make_optimizer(OptimConfig(**okw), batch)
    cfg = tdino.DINOConfig(**dkw)
    state = tdino.create_dino_state(model, optimizer, cfg)
    step = tdino.make_dino_train_step(model, optimizer, cfg)
    tbatch = {"globals": torch.from_numpy(g_views), "locals": torch.from_numpy(l_views)}

    norms = []
    for i in range(n_steps):
        jstate, jmetrics = jstep(jstate, jbatch, jax.random.PRNGKey(3))
        state, metrics = step(state, tbatch)
        np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(metrics["teacher_temp"], float(jmetrics["teacher_temp"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(metrics["ema_momentum"], float(jmetrics["ema_momentum"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center), atol=1e-5)
        norms.append(metrics["grad_norm"].item())
    assert state.step == int(jstate.step) == n_steps
    assert (max(norms) > clip_grad) == clip_bites

    for name, tree, module in (("student", jstate.student_params, state.student),
                               ("teacher", jstate.teacher_params, state.teacher)):
        want = dict(_flat(_np_tree(tree)["params"]))
        got = dict(_flat(params_to_flax(module.state_dict())["params"]))
        assert got.keys() == want.keys()
        for key in want:
            a, b = got[key], want[key]
            if key.endswith("attn/qkv/bias"):
                # the key bias has an analytically zero gradient (a constant
                # added to every key's score cancels in the softmax): what it
                # gets is rounding noise, which Adam scales up to +-lr
                a, b = np.delete(a, np.s_[64:128]), np.delete(b, np.s_[64:128])
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=f"{name} {key}")


def _plain(cfg, rename=()):
    out = {}
    for k, v in dataclasses.asdict(cfg).items():
        out[dict(rename).get(k, k)] = getattr(v, "__name__", None) or str(v).replace(
            "torch.", "") if not isinstance(v, (int, float, bool, str, tuple, type(None))) else v
    return out


@pytest.mark.parametrize("accelerated", [False, True])
@pytest.mark.parametrize("extra", [[], ["--drop-path", "0", "--dino-local-crops", "4"]])
def test_ssl_configs_match_reference(extra, accelerated):
    from tpuwsi.cli import train as jtrain
    from tpuwsi.cli.args import parse_args as jparse
    from tpuwsi_torch.cli import train as ttrain
    from tpuwsi_torch.cli.args import parse_args as tparse

    jargs, targs = jparse(BENCH_ARGV + extra), tparse(BENCH_ARGV + extra)
    assert vars(jargs) == vars(targs)
    want = _plain(jtrain.ssl_backbone_config(jargs, accelerated))
    got = _plain(ttrain.ssl_backbone_config(targs, accelerated),
                 rename=[("use_kernel_attention", "use_pallas_attention")])
    assert got == {k: want[k] for k in got}  # every field the port has
    assert _plain(ttrain.ssl_multicrop_config(targs, accelerated)) == _plain(
        jtrain.ssl_multicrop_config(jargs, accelerated))


def test_ssl_step_bundle_on_cpu():
    from tpuwsi_torch.cli.args import parse_args
    from tpuwsi_torch.cli.train import ssl_step_bundle
    from tpuwsi_torch.ops import attention

    args = parse_args(BENCH_ARGV + ["--dino-out-dim", "128", "--dino-global-size", "32",
                                    "--dino-local-size", "16"])
    tiny = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2)
    b = ssl_step_bundle(args, 1000, 96, torch.device("cpu"), vit_overrides=tiny)
    cfg = b.model.backbone.config
    assert cfg.dtype == torch.bfloat16 and cfg.ln_dtype == torch.float32
    assert not cfg.attn_save_probs and not cfg.use_kernel_attention  # the CPU's tuned switch
    assert cfg.drop_path_rate == 0.1 and cfg.gelu_approx and cfg.num_classes == 0
    assert b.dcfg.out_dim == 128 and b.dcfg.total_steps == 300_000
    assert b.dcfg.warmup_teacher_temp_steps == args.warmup_teacher_temp_epochs * 1000
    assert b.ocfg.clip_grad == 3.0 and b.ocfg.lr_base_scale == "sqrt"
    assert b.ocfg.resolved_lr(96) == pytest.approx(5e-4 * (96 / 512) ** 0.5)
    assert b.state.student is b.model and b.state.teacher is not b.model
    assert all(not p.requires_grad for p in b.state.teacher.parameters())
    assert b.params.keys() == b.model.state_dict().keys()
    images = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, 48, 48, 3), dtype=np.uint8))
    before = dict(attention.LAUNCHES)
    losses = []
    for _ in range(2):
        state, metrics = b.raw_step(b.state, {"images": images}, b.generator)
        losses.append(metrics["loss"].item())
    assert state.step == 2 and state.opt_state.count == 2
    assert np.isfinite(losses).all() and losses[0] != losses[1]
    assert state.center.abs().max() > 0
    assert attention.LAUNCHES == before
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device")  # the default device exists here
        ssl_step_bundle(args, 1000, 96, vit_overrides=tiny)
    # --grad-checkpointing recomputes each block in the backward (remat_blocks)
    remat = ssl_step_bundle(parse_args(BENCH_ARGV + ["--grad-checkpointing"]), 1000, 96,
                            torch.device("cpu"), vit_overrides=tiny)
    assert remat.model.backbone.config.remat_blocks and not cfg.remat_blocks
    assert remat.state.generator is remat.generator


def test_long_sequence_step_bundle_trajectory_matches_jax():
    """Three steps of the step that ``ssl_step_bundle`` assembles with a
    global size past 512 tokens (92 px at patch 4: 530 tokens a global view,
    17 a local one), on given views: the student's global views go through
    the flash pair's autograd.Function, the teacher's through its forward
    alone. Same tolerances and the same exclusion as the 12-step test."""
    from tpuwsi_torch.cli.args import parse_args
    from tpuwsi_torch.cli.train import ssl_step_bundle
    from tpuwsi_torch.ops import attention as tattn

    n_steps, batch = 3, 2
    geom = dict(patch_size=4, embed_dim=64, depth=2, num_heads=2)
    args = parse_args(BENCH_ARGV + ["--dino-out-dim", "96", "--dino-global-size", "92",
                                    "--dino-local-size", "16", "--dino-local-crops", "2",
                                    "--drop-path", "0", "--lr", "0.002", "--epochs", "2",
                                    "--warmup-epochs", "1"])
    b = ssl_step_bundle(args, 6, batch, torch.device("cpu"), vit_overrides=geom)
    cfg = b.model.backbone.config
    assert cfg.img_size == 92 and cfg.num_patches + 1 == 530 and cfg.dtype == torch.bfloat16
    # fp32 on both sides: the comparison is of the algorithm, not of bf16 roundings
    b = ssl_step_bundle(args, 6, batch, torch.device("cpu"),
                        vit_overrides=dict(geom, dtype=torch.float32))
    cfg = b.model.backbone.config

    rng = np.random.default_rng(21)
    g_views = rng.standard_normal((batch, 2, 92, 92, 3), dtype=np.float32)
    l_views = rng.standard_normal((batch, 2, 16, 16, 3), dtype=np.float32)
    jmodel = jdino.DINOModel(
        backbone=JViT(JViTConfig(dtype=jnp.float32, img_size=92, gelu_approx=True,
                                 use_pallas_attention=True, **geom)),
        head=JDINOHead(out_dim=96, gelu_approx=True))
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 92, 92, 3)))
    jcfg = jdino.DINOConfig(**dataclasses.asdict(b.dcfg))
    tx, _ = jmake_optimizer(JOptimConfig(**dataclasses.asdict(b.ocfg)), jparams, batch)
    jstate = jdino.create_dino_state(jparams, tx, jcfg)
    jstep = jax.jit(jdino.make_dino_train_step(jmodel.apply, tx, jcfg))
    jbatch = {"globals": jnp.asarray(g_views), "locals": jnp.asarray(l_views)}

    b.model.load_state_dict(params_from_flax(_np_tree(jparams)))
    state = tdino.create_dino_state(b.model, b.optimizer, b.dcfg)
    step = tdino.make_dino_train_step(b.model, b.optimizer, b.dcfg)  # given views
    tbatch = {"globals": torch.from_numpy(g_views), "locals": torch.from_numpy(l_views)}

    functions = []
    real_apply = tattn._MhaQkvFlash.apply
    tattn._MhaQkvFlash.apply = lambda *a: functions.append(a[0].shape[1]) or real_apply(*a)
    try:
        for i in range(n_steps):
            jstate, jmetrics = jstep(jstate, jbatch, jax.random.PRNGKey(3))
            state, metrics = step(state, tbatch, b.generator)
            np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]),
                                       rtol=1e-4, err_msg=f"step {i}")
            np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center),
                                       atol=1e-5)
    finally:
        tattn._MhaQkvFlash.apply = real_apply
    # the student's global forwards alone take the Function: depth per step
    assert functions == [530] * (cfg.depth * n_steps)

    for name, tree, module in (("student", jstate.student_params, state.student),
                               ("teacher", jstate.teacher_params, state.teacher)):
        want = dict(_flat(_np_tree(tree)["params"]))
        got = dict(_flat(params_to_flax(module.state_dict())["params"]))
        assert got.keys() == want.keys()
        for key in want:
            a, c = got[key], want[key]
            if key.endswith("attn/qkv/bias"):  # the key bias: see the 12-step test
                a, c = np.delete(a, np.s_[64:128]), np.delete(c, np.s_[64:128])
            np.testing.assert_allclose(a, c, atol=1e-4, rtol=1e-4, err_msg=f"{name} {key}")
