"""tpuwsi_torch's fused-MLP route held against the JAX package on the CPU.

Inputs and weights come from a numpy seed and go through both packages in
fp32. The JAX side runs its Pallas kernels in interpret mode; the port's
wrappers take their plain PyTorch versions, because the tensors lie on the
CPU. Tolerances: 1e-5 on values and 1e-4 on gradients of the three ops (fp32
sums in another order), 1e-4 on the ViT's outputs and parameter gradients,
and the DINO trajectory's own (1e-4 relative on each loss, 1e-5 on the
centre, 1e-4 on every leaf, the key bias left out as in
``test_torch_dino.py``). The card-only cases, each kernel against its plain
version, are in ``test_torch_mlp_card.py``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuwsi.models.dino_head import DINOHead as JDINOHead
from tpuwsi.models.vit import ViTConfig as JViTConfig, VisionTransformer as JViT
from tpuwsi.ops import mlp as jmlp
from tpuwsi.ssl_dino import dino as jdino
from tpuwsi.train.optim import OptimConfig as JOptimConfig, make_optimizer as jmake_optimizer
from tpuwsi_torch.models import vit as tvit
from tpuwsi_torch.models.convert import params_from_flax, params_to_flax
from tpuwsi_torch.ops import mlp as tmlp
from tpuwsi_torch.ssl_dino import dino as tdino

D, HIDDEN = 64, 256
OPS = {
    "fused_mlp": (jmlp.fused_mlp, tmlp.fused_mlp),
    "hybrid_mlp": (jmlp.hybrid_mlp, tmlp.hybrid_mlp),
    "fused_mlp_block": (jmlp.fused_mlp_block, tmlp.fused_mlp_block),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these CPU runs are tiny, and the test runner's
    other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _operands(name, lead, seed=0):
    """x, [gamma, beta,] w1, b1, w2, b2 and a cotangent, as float32 numpy."""
    rng = np.random.default_rng(seed)

    def normal(shape, std=1.0):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    x = normal((*lead, D))
    ln = [1.0 + normal((D,), 0.1), normal((D,), 0.1)] if name == "fused_mlp_block" else []
    weights = [normal((D, HIDDEN), 0.1), normal((HIDDEN,), 0.1), normal((HIDDEN, D), 0.1),
               normal((D,), 0.1)]
    return [x, *ln, *weights], normal((*lead, D))


@pytest.mark.parametrize("lead", [(2, 100), (7,)], ids=["2x100", "7"])
@pytest.mark.parametrize("approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("name", list(OPS))
def test_op_matches_jax(name, approx, lead):
    """Value and every gradient of the op; 100 and 7 rows are ragged against
    every row tile of the Pallas kernels."""
    jop, top = OPS[name]
    args, cot = _operands(name, lead)
    jargs = tuple(map(jnp.asarray, args))
    # jitted: interpret-mode kernels run op by op otherwise
    want = jax.jit(lambda a: jop(*a, approx=approx, interpret=True))(jargs)
    want_grads = jax.jit(jax.grad(
        lambda a: jnp.sum(jop(*a, approx=approx, interpret=True) * cot)))(jargs)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = top(*targs, approx=approx)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    for i, (t, w) in enumerate(zip(targs, want_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"gradient of argument {i}")


@pytest.mark.parametrize("approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("block", [False, True], ids=["mlp", "block"])
def test_plain_backward_matches_autograd(block, approx):
    """The hand-derived backward (GELU derivative, LayerNorm backward) against
    autograd through the plain forward, fp32."""
    args, cot = _operands("fused_mlp_block" if block else "fused_mlp", (37,), seed=3)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    dy = torch.from_numpy(cot)
    if block:
        x, g, be, w1, b1, w2, b2 = targs
        y = tmlp._mlp_block_fwd_reference(*targs, approx, 1e-6)
        dx, dg, dbe, dw1, db1, dw2, db2 = tmlp._mlp_block_bwd_reference(
            x, dy, g, be, w1, b1, w2, approx, 1e-6)
        got = [dx, dg, dbe, dw1, db1, dw2, db2]
    else:
        x, w1, b1, w2, b2 = targs
        y = tmlp._mlp_fwd_reference(*targs, approx)
        dx, dw1, db1, dw2, db2 = tmlp._mlp_bwd_reference(x, dy, w1, b1, w2, approx)
        got = [dx, dw1, db1, dw2, db2]
    want = torch.autograd.grad(y, targs, dy)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=f"gradient of argument {i}")


@pytest.mark.parametrize("name", list(OPS))
def test_bf16_compute_rounds_weight_gradients(name):
    """With bf16 compute the fc1/fc2 gradients reach the fp32 parameters
    rounded to bf16, as the reference's vjp returns them in the operands'
    dtype; the LayerNorm gradients stay fp32."""
    args, cot = _operands(name, (50,), seed=5)
    x = torch.from_numpy(args[0]).bfloat16()
    params = [torch.from_numpy(a).requires_grad_() for a in args[1:]]
    y = OPS[name][1](x, *params, approx=True)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(cot)).sum().backward()
    for p in params[-4:]:
        assert p.grad.dtype == torch.float32 and p.grad.abs().max() > 0
        assert torch.equal(p.grad, p.grad.bfloat16().float())
    for p in params[:-4]:  # gamma, beta
        assert p.grad.dtype == torch.float32
        assert not torch.equal(p.grad, p.grad.bfloat16().float())


def test_unsupported_inputs_raise():
    x = torch.zeros(4, 64, device="meta")
    w1, b1, w2, b2 = (torch.zeros(s, device="meta") for s in ((64, 256), (256,), (256, 64), (64,)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tmlp.fused_mlp(x, w1, b1, w2, b2)
    # what the kernels refuse is checked before any launch, so it shows here
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"widths \(384, 768\)"):
        tmlp._check_operands(x, w1, b1, w2, b2)
    x = torch.zeros(4, 384)
    w1, b1, w2, b2 = (torch.zeros(s) for s in ((384, 1536), (1536,), (1536, 384), (384,)))
    with pytest.raises(ValueError, match="bf16"):
        tmlp._check_operands(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="multiple of 64"):
        tmlp._check_operands(x.bfloat16(), w1[:, :100], b1[:100], w2[:100], b2)


# -- the ViT with each flag ----------------------------------------------------

GEOM = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2, gelu_approx=True,
            drop_path_rate=0.1)


def _uniform(shape):
    """The stochastic-depth draw both packages get: (depth, 2, B) uniforms,
    seeded by the batch size."""
    depth, two, b = shape[:3]
    return np.random.default_rng(b).random((depth, two, b)).astype(np.float32)


@pytest.fixture
def shared_drop_path(monkeypatch):
    """Both packages draw their stochastic-depth masks from ``_uniform``."""
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **kw: jnp.asarray(_uniform(shape)).reshape(shape))

    def masks(self, batch, device, generator):
        keep = 1.0 - torch.tensor(self.drop_path_rates)
        u = torch.from_numpy(_uniform((len(self.blocks), 2, batch)))
        return u < keep[:, None, None]

    monkeypatch.setattr(tvit.VisionTransformer, "drop_path_masks", masks)


@pytest.fixture
def op_calls(monkeypatch):
    """Counts of the port's three ops as the ViT calls them."""
    calls = []
    for name in OPS:
        real = getattr(tvit, name)
        monkeypatch.setattr(
            tvit, name, lambda *a, _real=real, _name=name, **kw: calls.append(_name) or _real(*a, **kw))
    return calls


def _vit_pair(flag):
    jcfg = JViTConfig(dtype=jnp.float32, use_pallas_attention=True, pallas_interpret=True,
                      **GEOM, **{flag: True})
    jmodel = JViT(jcfg)
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(1)  # non-trivial LayerNorm affine and biases
    variables = jax.tree_util.tree_map(
        lambda v: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32), variables)
    model = tvit.VisionTransformer(tvit.ViTConfig(dtype=torch.float32, **GEOM, **{flag: True}))
    model.load_state_dict(params_from_flax(variables))
    return jmodel, variables, model


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("flag", ["use_fused_mlp", "mlp_pallas_bwd"])
def test_vit_matches_flax(flag, training, shared_drop_path, op_calls):
    """Features and parameter gradients. In training block 0 (stochastic-depth
    rate 0) takes the sub-block op and block 1 (rate 0.1) the MLP op."""
    jmodel, variables, model = _vit_pair(flag)
    x = np.random.default_rng(7).standard_normal((3, 32, 32, 3)).astype(np.float32)
    cot = np.random.default_rng(8).standard_normal((3, 64)).astype(np.float32)

    def jloss(v):
        out = jmodel.apply(v, jnp.asarray(x), deterministic=not training,
                           rngs={"droppath": jax.random.PRNGKey(0)})
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables)
    out = model(torch.from_numpy(x), deterministic=not training,
                generator=torch.Generator().manual_seed(0))
    if flag == "mlp_pallas_bwd":
        assert op_calls == ["hybrid_mlp"] * 2
    else:
        assert op_calls == (["fused_mlp_block", "fused_mlp"] if training
                            else ["fused_mlp_block"] * 2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    (out * torch.from_numpy(cot)).sum().backward()
    got = dict(_flat(params_to_flax(
        {k: p.grad for k, p in model.named_parameters()})["params"]))
    want_flat = dict(_flat(jax.device_get(want_grads)["params"]))
    assert got.keys() == want_flat.keys()
    for key, w in want_flat.items():
        np.testing.assert_allclose(got[key], w, atol=1e-4, rtol=1e-4, err_msg=key)


def test_fused_route_keeps_the_parameter_tree():
    """The flags change no parameter name or shape: one state_dict loads into
    both routes, so ``models/convert.py`` needs nothing new."""
    plain = tvit.VisionTransformer(tvit.ViTConfig(**GEOM))
    fused = tvit.VisionTransformer(tvit.ViTConfig(**GEOM, use_fused_mlp=True, mlp_pallas_bwd=True))
    assert {k: v.shape for k, v in plain.state_dict().items()} == {
        k: v.shape for k, v in fused.state_dict().items()}
    fused.load_state_dict(plain.state_dict())


def test_tuned_configuration_leaves_the_fused_mlp_off():
    from tpuwsi.core.tuned import tuned_vit_kwargs as jtuned
    from tpuwsi_torch.core.tuned import tuned_vit_kwargs

    for on in (False, True):
        assert tuned_vit_kwargs(on)["use_fused_mlp"] is jtuned(on)["use_fused_mlp"] is False
    assert not tvit.ViTConfig().use_fused_mlp and not tvit.ViTConfig().mlp_pallas_bwd


# -- the slice as a whole ------------------------------------------------------

BENCH_ARGV = ["--ssl", "--model", "vit_small_patch16_224_dino", "--epochs", "2",
              "--warmup-epochs", "1", "--opt", "adamw", "--lr-base", "0.0005",
              "--weight-decay", "0.04", "--lr", "0.002", "--dino-out-dim", "96",
              "--dino-global-size", "32", "--dino-local-size", "16", "--dino-local-crops", "3"]


def test_fused_mlp_step_bundle_trajectory_matches_jax(shared_drop_path, op_calls):
    """Three steps of the step that ``ssl_step_bundle`` assembles with
    ``vit_overrides={"use_fused_mlp": True}`` at the recipe's stochastic
    depth (0.1), on given views: the teacher and the student's block 0 take
    the sub-block op, the student's block 1 the MLP op."""
    from tpuwsi_torch.cli.args import parse_args
    from tpuwsi_torch.cli.train import ssl_step_bundle

    n_steps, batch = 3, 2
    geom = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2)
    b = ssl_step_bundle(
        parse_args(BENCH_ARGV), 6, batch, torch.device("cpu"),
        # on the CPU the tuned switch turns the kernel route off; turn it on
        vit_overrides=dict(geom, dtype=torch.float32, use_kernel_attention=True,
                           use_fused_mlp=True))
    cfg = b.model.backbone.config
    assert cfg.use_fused_mlp and cfg.drop_path_rate == 0.1 and cfg.gelu_approx

    rng = np.random.default_rng(31)
    g_views = rng.standard_normal((batch, 2, 32, 32, 3), dtype=np.float32)
    l_views = rng.standard_normal((batch, 3, 16, 16, 3), dtype=np.float32)
    jmodel = jdino.DINOModel(
        backbone=JViT(JViTConfig(dtype=jnp.float32, img_size=32, gelu_approx=True,
                                 drop_path_rate=0.1, use_pallas_attention=True,
                                 pallas_interpret=True, use_fused_mlp=True, **geom)),
        head=JDINOHead(out_dim=96, gelu_approx=True))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    jcfg = jdino.DINOConfig(**dataclasses.asdict(b.dcfg))
    tx, _ = jmake_optimizer(JOptimConfig(**dataclasses.asdict(b.ocfg)), jparams, batch)
    jstate = jdino.create_dino_state(jparams, tx, jcfg)
    jstep = jax.jit(jdino.make_dino_train_step(jmodel.apply, tx, jcfg))
    jbatch = {"globals": jnp.asarray(g_views), "locals": jnp.asarray(l_views)}

    b.model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.device_get(jparams))))
    state = tdino.create_dino_state(b.model, b.optimizer, b.dcfg)
    step = tdino.make_dino_train_step(b.model, b.optimizer, b.dcfg)  # given views
    tbatch = {"globals": torch.from_numpy(g_views), "locals": torch.from_numpy(l_views)}

    for i in range(n_steps):
        jstate, jmetrics = jstep(jstate, jbatch, jax.random.PRNGKey(3))
        state, metrics = step(state, tbatch, b.generator)
        np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center), atol=1e-5)
    # per step: the teacher's two blocks; the student's block 0 and block 1,
    # once for the global and once for the local views
    per_step = {"fused_mlp_block": 2 + 2, "fused_mlp": 2, "hybrid_mlp": 0}
    assert {name: op_calls.count(name) for name in OPS} == {
        name: n * n_steps for name, n in per_step.items()}

    for name, tree, module in (("student", jstate.student_params, state.student),
                               ("teacher", jstate.teacher_params, state.teacher)):
        want = dict(_flat(jax.tree_util.tree_map(np.asarray, jax.device_get(tree))["params"]))
        got = dict(_flat(params_to_flax(module.state_dict())["params"]))
        assert got.keys() == want.keys()
        for key in want:
            a, c = got[key], want[key]
            if key.endswith("attn/qkv/bias"):  # the key bias: see test_torch_dino.py
                a, c = np.delete(a, np.s_[64:128]), np.delete(c, np.s_[64:128])
            np.testing.assert_allclose(a, c, atol=1e-4, rtol=1e-4, err_msg=f"{name} {key}")


@pytest.mark.parametrize("rows,f,sms", [(37824, 1536, 132), (21312, 1536, 132), (1, 1536, 132),
                                        (7, 64, 132), (1000, 320, 132), (37824, 1536, 16),
                                        (129, 1536, 1), (5 * 32 + 1, 256, 132)])
def test_dw_groups_cover_every_row_within_the_grid(rows, f, sms):
    """The row groups of the D = 384 backward's weight-gradient passes: a pure
    function of (rows, F, SMs) whose groups of 32-row stages cover every row
    once, in order, and whose grid fills at most the card."""
    groups = tmlp.mlp_dw_groups(rows, f, sms)
    assert groups == tmlp.mlp_dw_groups(rows, f, sms)
    stages = -(-rows // tmlp.MLP_DW_STAGE_ROWS)
    per = -(-stages // groups)
    assert 1 <= groups <= stages
    covered = [s for g in range(groups) for s in range(g * per, min((g + 1) * per, stages))]
    assert covered == list(range(stages))
    blocks_per_group = -(-(f // tmlp.MLP_DW_SLICE) // tmlp.MLP_DW_CLUSTER) * tmlp.MLP_DW_CLUSTER
    assert groups * blocks_per_group <= max(sms, blocks_per_group) < 2 ** 31
    if (rows, f, sms) == (37824, 1536, 132):
        assert groups == 5  # 24 slices in 6 clusters of 4: 120 of 132 SMs


class _FakeLib:
    """The two shape queries of the kernel library, without a card: rows of a
    row tile and hidden units of a weight-gradient slice, by width."""

    @staticmethod
    def tpuwsi_mlp_rows_per_tile(d):
        return {384: 64, 768: 32}[d]

    @staticmethod
    def tpuwsi_mlp_hidden_per_slice(d):
        return {384: 0, 768: 16}[d]


@pytest.fixture
def card_shapes(monkeypatch):
    """The backward wrappers' buffers and launch arguments on meta tensors:
    the library's shape queries and 132 SMs stand in for the card, and each
    launch is recorded instead of made."""
    from tpuwsi_torch.ops import _build

    monkeypatch.setattr(_build, "load", lambda: _FakeLib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    calls = []
    monkeypatch.setattr(tmlp, "_call",
                        lambda name, like, args, counts=None: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("rows", [1, 64, 5 * 64 + 1, 21312, 37824])
@pytest.mark.parametrize("d", [384, 768])
def test_backward_row_groups_by_width(card_shapes, rows, d):
    """At D = 384 both backwards, K5b and the sub-block's K6b, take the row
    groups of csrc/mlp_sm90.cu's weight-gradient passes (mlp_dw_groups); at
    D = 768 both keep those of the row-tiled kernels. The partial buffers
    are sized by them."""
    f = 4 * d
    x = torch.empty((rows, d), dtype=torch.bfloat16, device="meta")
    want = (tmlp.mlp_dw_groups(rows, f, 132) if d == 384 else
            max(1, min(-(-rows // 32), tmlp.DW_WAVES * 132 // (f // 16))))
    n_tiles = -(-rows // _FakeLib.tpuwsi_mlp_rows_per_tile(d))
    for row_sums in (1, 3):
        dx, grads, w_part, row_part, tiles, groups = tmlp._bwd_buffers(x, f, row_sums)
        assert (tiles, groups) == (n_tiles, want)
        assert tuple(w_part.shape) == (groups, 2 * d * f + f)
        assert tuple(row_part.shape) == (n_tiles, row_sums * d)
        assert grads.numel() == 2 * d * f + f + row_sums * d and dx.shape == x.shape


def _block_operands(rows, d, f, **changes):
    shapes = {"x": ((rows, d), torch.bfloat16), "dy": ((rows, d), torch.bfloat16),
              "g": ((d,), torch.float32), "be": ((d,), torch.float32),
              "w1": ((d, f), torch.bfloat16), "b1": ((f,), torch.bfloat16),
              "w2": ((f, d), torch.bfloat16), "b2": ((d,), torch.bfloat16)}
    shapes.update(changes)
    return {k: torch.empty(shape, dtype=dt, device="meta") for k, (shape, dt) in shapes.items()}


def test_block_backward_launch_arguments(card_shapes):
    """The sub-block backward at D = 384 hands its launch the Hopper row
    groups and 64-row tiles, and returns its gradients in their shapes."""
    rows, d, f = 37824, 384, 1536
    o = _block_operands(rows, d, f)
    dx, dg, dbe, dw1, db1, dw2, db2 = tmlp._launch_mlp_block_bwd(
        o["x"], o["dy"], o["g"], o["be"], o["w1"], o["b1"], o["w2"], True, 1e-6)
    (name, args), = card_shapes
    assert name == "mlp_block_bwd"
    assert args[12:17] == (rows, d, f, -(-rows // 64), tmlp.mlp_dw_groups(rows, f, 132)) == (
        rows, d, f, 591, 5)
    assert [tuple(t.shape) for t in (dx, dg, dbe, dw1, db1, dw2, db2)] == [
        (rows, d), (d,), (d,), (d, f), (f,), (f, d), (d,)]


@pytest.mark.parametrize("change,match", [
    ({"g": ((384,), torch.float16)}, "fp32"),                    # LayerNorm scale not fp32
    ({"be": ((768,), torch.float32)}, "fp32"),                   # LayerNorm bias of another width
    ({"x": ((5, 512), torch.bfloat16), "dy": ((5, 512), torch.bfloat16)}, r"widths \(384, 768\)"),
    ({"w1": ((384, 100), torch.bfloat16)}, "multiple of 64"),
    ({"x": ((2 ** 31 // 1536 + 1, 384), torch.bfloat16),
      "dy": ((2 ** 31 // 1536 + 1, 384), torch.bfloat16)}, "2\\^31"),  # rows x F past int32
    ({"dy": ((7, 384), torch.float32)}, "bf16"),
])
def test_block_wrappers_refuse_before_launching(card_shapes, change, match):
    """What the sub-block kernels do not take raises in the wrapper, before
    any launch. Shapes only: meta tensors hold no data."""
    o = _block_operands(7, 384, 1536, **change)
    with pytest.raises(ValueError, match=match):
        if "dy" in change:
            tmlp._launch_mlp_block_bwd(o["x"], o["dy"], o["g"], o["be"], o["w1"], o["b1"], o["w2"],
                                       True, 1e-6)
        else:
            tmlp._launch_mlp_block_fwd(o["x"], o["g"], o["be"], o["w1"], o["b1"], o["w2"], o["b2"],
                                       True, 1e-6)
    assert card_shapes == []
