"""tpuwsi_torch's hybrid-dense route and its row-tiled LN+GEMM / GEMM+residual
ops held against the JAX package on the CPU.

Inputs and weights come from a numpy seed and go through both packages in
fp32. The JAX side runs its Pallas kernels in interpret mode; the port's
wrappers take their plain PyTorch versions, because the tensors lie on the
CPU. Tolerances: 1e-5 on values and 1e-4 on gradients of the three ops (fp32
sums in another order), 1e-5 between each hand-derived plain backward and
autograd, 1e-4 on the ViT's outputs and parameter gradients, and the DINO
trajectory's own (1e-4 relative on each loss, 1e-5 on the centre, 1e-4 on
every leaf, the key bias left out as in ``test_torch_dino.py``). The
card-only cases, each kernel against its plain version, are in
``test_torch_mlp_card.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuwsi.models.dino_head import DINOHead as JDINOHead
from tpuwsi.models.vit import ViTConfig as JViTConfig, VisionTransformer as JViT
from tpuwsi.ops import dense as jdense, mlp as jmlp
from tpuwsi.ssl_dino import dino as jdino
from tpuwsi.train.optim import OptimConfig as JOptimConfig, make_optimizer as jmake_optimizer
from tpuwsi_torch.models import vit as tvit
from tpuwsi_torch.models.convert import params_from_flax, params_to_flax
from tpuwsi_torch.models.registry import create_model
from tpuwsi_torch.ops import dense as tdense, mlp as tmlp
from tpuwsi_torch.ops.attention import mha_from_qkv
from tpuwsi_torch.ssl_dino import dino as tdino

D, F = 64, 192
LEADS = pytest.mark.parametrize("lead", [(2, 100), (37,)], ids=["2x100", "37"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these CPU runs are tiny, and the test runner's
    other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(rng, shape, std=1.0):
    return (std * rng.standard_normal(shape)).astype(np.float32)


def _compare(jop, top, args, cot):
    """Value (1e-5) and the gradient of every argument that is not None
    (1e-4) of one op through both packages."""
    present = [a is not None for a in args]
    some = [a for a in args if a is not None]

    def fill(given):
        it = iter(given)
        return [next(it) if p else None for p in present]

    jsome = tuple(map(jnp.asarray, some))
    # jitted: interpret-mode kernels run op by op otherwise
    want = jax.jit(lambda a: jop(*fill(a)))(jsome)
    want_grads = jax.jit(jax.grad(lambda a: jnp.sum(jop(*fill(a)) * cot)))(jsome)
    tsome = [torch.from_numpy(a).requires_grad_() for a in some]
    got = top(*fill(tsome))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    for i, (t, w) in enumerate(zip(tsome, want_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"gradient of argument {i}")


@LEADS
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_hybrid_dense_matches_jax(bias, lead):
    """100 and 37 rows are ragged against the Pallas kernel's row tile."""
    rng = np.random.default_rng(0)
    args = [_normal(rng, (*lead, D)), _normal(rng, (D, F), 0.1),
            _normal(rng, (F,), 0.1) if bias else None]
    _compare(lambda x, w, b: jdense.hybrid_dense(x, w, b, interpret=True), tdense.hybrid_dense,
             args, _normal(rng, (*lead, F)))


@LEADS
def test_fused_ln_gemm_matches_jax(lead):
    rng = np.random.default_rng(1)
    args = [_normal(rng, (*lead, D)), 1.0 + _normal(rng, (D,), 0.1), _normal(rng, (D,), 0.1),
            _normal(rng, (D, F), 0.1), _normal(rng, (F,), 0.1)]
    _compare(lambda *a: jmlp.fused_ln_gemm(*a, interpret=True), tmlp.fused_ln_gemm, args,
             _normal(rng, (*lead, F)))


@LEADS
def test_fused_gemm_residual_matches_jax(lead):
    rng = np.random.default_rng(2)
    args = [_normal(rng, (*lead, D)), _normal(rng, (*lead, F)), _normal(rng, (F, D), 0.1),
            _normal(rng, (D,), 0.1)]
    _compare(lambda *a: jmlp.fused_gemm_residual(*a, interpret=True), tmlp.fused_gemm_residual,
             args, _normal(rng, (*lead, D)))


@pytest.mark.parametrize("kernel", ["dense_bwd", "ln_gemm_bwd", "gemm_res_bwd"])
def test_plain_backward_matches_autograd(kernel):
    """Each hand-derived plain backward against autograd through its plain
    forward (for ``dense_bwd``: through ``x @ w + b``), fp32, 1e-5."""
    rng = np.random.default_rng(3)
    rows = 37
    x, w, b = (torch.from_numpy(a).requires_grad_() for a in
               (_normal(rng, (rows, D)), _normal(rng, (D, F), 0.1), _normal(rng, (F,), 0.1)))
    g, be = (torch.from_numpy(a).requires_grad_() for a in
             (1.0 + _normal(rng, (D,), 0.1), _normal(rng, (D,), 0.1)))
    res = torch.from_numpy(_normal(rng, (rows, F))).requires_grad_()
    dy = torch.from_numpy(_normal(rng, (rows, F)))
    if kernel == "dense_bwd":
        got = tdense._dense_bwd_reference(x, dy, w)
        want = torch.autograd.grad(x @ w + b, (x, w, b), dy)
    elif kernel == "ln_gemm_bwd":
        got = tmlp._ln_gemm_bwd_reference(x, dy, g, be, w, 1e-6)
        want = torch.autograd.grad(tmlp._ln_gemm_fwd_reference(x, g, be, w, b, 1e-6),
                                   (x, g, be, w, b), dy)
    else:
        got = tmlp._gemm_res_bwd_reference(x, dy, w)
        want = torch.autograd.grad(tmlp._gemm_res_fwd_reference(res, x, w, b), (x, w, b), dy)
    assert len(got) == len(want)
    for i, (a, c) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.detach().numpy(), c.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("op", ["hybrid_dense", "fused_ln_gemm", "fused_gemm_residual"])
def test_bf16_compute_rounds_weight_gradients(op):
    """With bf16 compute dW and db reach the fp32 parameters rounded to bf16,
    as the reference's vjp returns them in the operands' dtype; the LayerNorm
    gradients stay fp32."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_normal(rng, (50, D))).bfloat16()
    w, b = (torch.from_numpy(a).requires_grad_() for a in
            (_normal(rng, (D, F), 0.1), _normal(rng, (F,), 0.1)))
    g, be = (torch.from_numpy(a).requires_grad_() for a in
             (1.0 + _normal(rng, (D,), 0.1), _normal(rng, (D,), 0.1)))
    res = torch.from_numpy(_normal(rng, (50, F))).bfloat16()
    y = {"hybrid_dense": lambda: tdense.hybrid_dense(x, w, b),
         "fused_ln_gemm": lambda: tmlp.fused_ln_gemm(x, g, be, w, b),
         "fused_gemm_residual": lambda: tmlp.fused_gemm_residual(res, x, w, b)}[op]()
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(_normal(rng, (50, F)))).sum().backward()
    for p in (w, b):
        assert p.grad.dtype == torch.float32 and p.grad.abs().max() > 0
        assert torch.equal(p.grad, p.grad.bfloat16().float())
    if op == "fused_ln_gemm":
        for p in (g, be):
            assert p.grad.dtype == torch.float32
            assert not torch.equal(p.grad, p.grad.bfloat16().float())


def test_unsupported_inputs_raise():
    """What the kernels refuse is checked before any launch, so it shows on
    CPU tensors."""
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdense.hybrid_dense(torch.zeros(4, 64, device="meta"),
                            torch.zeros(64, 64, device="meta"))
    bf = torch.bfloat16
    x, dy, w = torch.zeros(4, 64, dtype=bf), torch.zeros(4, 192, dtype=bf), torch.zeros(64, 192,
                                                                                        dtype=bf)
    with pytest.raises(ValueError, match=r"widths \(384, 768\)"):
        tdense._check_operands(x, dy, w)
    x, dy, w = torch.zeros(4, 384), torch.zeros(4, 1152), torch.zeros(384, 1152)
    with pytest.raises(ValueError, match="bf16"):
        tdense._check_operands(x, dy, w)
    tdense._check_operands(x.to(bf), dy.to(bf), w.to(bf))
    with pytest.raises(ValueError, match=r"output width in \(384, 1152\)"):
        tdense._check_operands(x.to(bf), dy[:, :768].to(bf), w[:, :768].to(bf))
    with pytest.raises(ValueError, match="contiguous"):
        tdense._check_operands(x.to(bf), dy.to(bf), torch.zeros(1152, 384, dtype=bf).t())
    g = torch.ones(384)
    with pytest.raises(ValueError, match="multiple of 64"):
        tmlp._check_dense_operands("LN+GEMM", x.to(bf), w[:, :100].to(bf), ln=(g, g))
    with pytest.raises(ValueError, match="fp32"):
        tmlp._check_dense_operands("LN+GEMM", x.to(bf), w.to(bf), ln=(g.to(bf), g))
    with pytest.raises(ValueError, match=r"output width in \(384, 768\)"):
        tmlp._check_dense_operands("GEMM+residual", x.to(bf), w.to(bf), tmlp.KERNEL_WIDTHS)


# -- the ViT with the flag -------------------------------------------------------

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
def dense_calls(monkeypatch):
    """Output widths of the port's ``hybrid_dense`` calls as the ViT makes them."""
    calls = []
    real = tvit.hybrid_dense
    monkeypatch.setattr(tvit, "hybrid_dense",
                        lambda x, w, b: calls.append(w.shape[1]) or real(x, w, b))
    return calls


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("flags", [("dense_pallas_bwd",), ("dense_pallas_bwd", "mlp_pallas_bwd")],
                         ids=["dense", "dense+mlp"])
def test_vit_matches_flax(flags, training, shared_drop_path, dense_calls):
    """Features and parameter gradients with the hybrid dense layers, alone and
    beside the hybrid MLP, 1e-4."""
    on = dict.fromkeys(flags, True)
    jmodel = JViT(JViTConfig(dtype=jnp.float32, use_pallas_attention=True, pallas_interpret=True,
                             **GEOM, **on))
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(1)  # non-trivial LayerNorm affine and biases
    variables = jax.tree_util.tree_map(
        lambda v: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32), variables)
    model = tvit.VisionTransformer(tvit.ViTConfig(dtype=torch.float32, **GEOM, **on))
    model.load_state_dict(params_from_flax(variables))
    x = np.random.default_rng(7).standard_normal((3, 32, 32, 3)).astype(np.float32)
    cot = np.random.default_rng(8).standard_normal((3, 64)).astype(np.float32)

    def jloss(v):
        out = jmodel.apply(v, jnp.asarray(x), deterministic=not training,
                           rngs={"droppath": jax.random.PRNGKey(0)})
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables)
    out = model(torch.from_numpy(x), deterministic=not training,
                generator=torch.Generator().manual_seed(0))
    assert dense_calls == [192, 64] * 2  # qkv and proj of each block
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    (out * torch.from_numpy(cot)).sum().backward()
    got = dict(_flat(params_to_flax(
        {k: p.grad for k, p in model.named_parameters()})["params"]))
    want_flat = dict(_flat(jax.device_get(want_grads)["params"]))
    assert got.keys() == want_flat.keys()
    for key, w in want_flat.items():
        np.testing.assert_allclose(got[key], w, atol=1e-4, rtol=1e-4, err_msg=key)


def test_flag_keeps_the_parameter_tree_and_the_eval_output():
    """The flag changes no parameter name or shape, so one state_dict (and one
    ``params_from_flax``) serves both routes; in eval the two routes run the
    same library GEMMs and give the same bits, which is why serving needs no
    kernel of this route."""
    plain = tvit.VisionTransformer(tvit.ViTConfig(**GEOM, dtype=torch.float32)).eval()
    hybrid = tvit.VisionTransformer(
        tvit.ViTConfig(**GEOM, dtype=torch.float32, dense_pallas_bwd=True)).eval()
    assert {k: v.shape for k, v in plain.state_dict().items()} == {
        k: v.shape for k, v in hybrid.state_dict().items()}
    jmodel = JViT(JViTConfig(dtype=jnp.float32, dense_pallas_bwd=True, **GEOM))
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 32, 32, 3))))
    state = params_from_flax(variables)
    plain.load_state_dict(state)
    hybrid.load_state_dict(state)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 32, 32, 3))
                         .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(plain(x), hybrid(x))
    assert create_model("vit_tiny_patch16_224", dense_pallas_bwd=True).config.dense_pallas_bwd
    assert not create_model("vit_tiny_patch16_224").config.dense_pallas_bwd


def test_tuned_configuration_leaves_the_hybrid_dense_off():
    from tpuwsi.core.tuned import tuned_vit_kwargs as jtuned
    from tpuwsi_torch.core.tuned import tuned_vit_kwargs

    for on in (False, True):  # the reference's tuned dict does not name the flag
        assert "dense_pallas_bwd" not in jtuned(on)
        assert "dense_pallas_bwd" not in tuned_vit_kwargs(on)
    assert not tvit.ViTConfig().dense_pallas_bwd and not JViTConfig().dense_pallas_bwd


def test_composed_attention_sub_block_matches_the_block():
    """``fused_gemm_residual(x, mha_from_qkv(fused_ln_gemm(x, ...)), ...)``, the
    composition of ``tpuwsi/models/vit.py:533``, against ``x + attn(norm1(x))``
    from the port's own ``Block``, value and every gradient, fp32, 1e-5."""
    torch.manual_seed(0)
    blk = tvit.Block(tvit.ViTConfig(**{**GEOM, "drop_path_rate": 0.0}, dtype=torch.float32))
    with torch.no_grad():
        for p in blk.parameters():  # non-trivial LayerNorm affine and biases
            p.add_(0.1 * torch.randn_like(p))
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_normal(rng, (3, 17, 64))).requires_grad_()
    cot = torch.from_numpy(_normal(rng, (3, 17, 64)))
    params = [blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight, blk.attn.qkv.bias,
              blk.attn.proj.weight, blk.attn.proj.bias]
    want = x + blk.attn(blk.norm1(x))
    want_grads = torch.autograd.grad(want, [x, *params], cot)
    qkv = tmlp.fused_ln_gemm(x, blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight.t(),
                             blk.attn.qkv.bias, eps=blk.norm1.eps)
    got = tmlp.fused_gemm_residual(x, mha_from_qkv(qkv, blk.attn.num_heads, training=True),
                                   blk.attn.proj.weight.t(), blk.attn.proj.bias)
    got_grads = torch.autograd.grad(got, [x, *params], cot)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5, rtol=1e-5)
    for i, (a, c) in enumerate(zip(got_grads, want_grads)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=f"gradient {i}")


# -- the slice as a whole ------------------------------------------------------

BENCH_ARGV = ["--ssl", "--model", "vit_small_patch16_224_dino", "--epochs", "2",
              "--warmup-epochs", "1", "--opt", "adamw", "--lr-base", "0.0005",
              "--weight-decay", "0.04", "--lr", "0.002", "--dino-out-dim", "96",
              "--dino-global-size", "32", "--dino-local-size", "16", "--dino-local-crops", "3"]


def test_dense_step_bundle_trajectory_matches_jax(shared_drop_path, dense_calls):
    """Three steps of the step that ``ssl_step_bundle`` assembles with
    ``vit_overrides={"dense_pallas_bwd": True}`` at the recipe's stochastic
    depth (0.1), on given views, against the JAX step with the same flag."""
    from tpuwsi_torch.cli.args import parse_args
    from tpuwsi_torch.cli.train import ssl_step_bundle

    n_steps, batch = 3, 2
    geom = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2)
    b = ssl_step_bundle(
        parse_args(BENCH_ARGV), 6, batch, torch.device("cpu"),
        # on the CPU the tuned switch turns the kernel route off; turn it on
        vit_overrides=dict(geom, dtype=torch.float32, use_kernel_attention=True,
                           dense_pallas_bwd=True))
    cfg = b.model.backbone.config
    assert cfg.dense_pallas_bwd and cfg.drop_path_rate == 0.1 and cfg.gelu_approx

    rng = np.random.default_rng(31)
    g_views = rng.standard_normal((batch, 2, 32, 32, 3), dtype=np.float32)
    l_views = rng.standard_normal((batch, 3, 16, 16, 3), dtype=np.float32)
    jmodel = jdino.DINOModel(
        backbone=JViT(JViTConfig(dtype=jnp.float32, img_size=32, gelu_approx=True,
                                 drop_path_rate=0.1, use_pallas_attention=True,
                                 pallas_interpret=True, dense_pallas_bwd=True, **geom)),
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
    # per step: qkv and proj of two blocks, in the teacher's pass and in the
    # student's two (global and local views)
    assert len(dense_calls) == n_steps * 3 * 2 * 2

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


# -- the kernels' launches, shapes and arguments only ---------------------------


class _FakeLib:
    """The library's shape queries as csrc/ builds them, for tests of the
    launch arguments."""
    tpuwsi_dense_rows_per_step = staticmethod(lambda k: 64 if k <= 384 else 32)
    tpuwsi_dense_cols_per_slice = staticmethod(lambda k: 64 if k <= 384 else 32)
    tpuwsi_mlp_rows_per_tile = staticmethod(lambda k: 64 if k <= 384 else 32)


@pytest.fixture
def launches(monkeypatch):
    """The dense wrappers with the library's shape queries and 132 SMs standing
    in for the card; each launch is recorded, ``(name, args)``, not made."""
    import types

    from tpuwsi_torch.ops import _build

    calls = []
    monkeypatch.setattr(_build, "load", lambda: _FakeLib)
    monkeypatch.setattr(_build, "launch", lambda name, like, args: calls.append((name, args)))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    return calls


def _bf16(*shape, device="cpu"):
    return torch.zeros(shape, dtype=torch.bfloat16, device=device)


@pytest.mark.parametrize("layout", ["kn", "nk"], ids=["w_kn", "w_nk"])
@pytest.mark.parametrize("k", [384, 768])
def test_dense_bwd_passes_the_weight_as_stored(launches, k, layout):
    """K7's launch by input width: a (K, N) weight goes as it is (layout 0);
    the transposed view of nn.Linear's (N, K) weight goes as that weight's own
    storage at K = 384 (layout 1, csrc/dense_sm90.cu reads it in place) and as
    a (K, N) copy at K = 768 (layout 0: dense.cu's row-tiled kernel reads W
    only so)."""
    n, rows = 3 * k, 5
    x, dy = _bf16(rows, k), _bf16(rows, n)
    stored = _bf16(k, n) if layout == "kn" else _bf16(n, k)
    w = stored if layout == "kn" else stored.t()
    dx, dw, db = tdense._launch_dense_bwd(x, dy, w)
    ((name, args),) = launches
    assert name == "dense_bwd" and len(args) == 11
    assert args[6:9] == (rows, k, n) and args[10] == (1 if (layout, k) == ("nk", 384) else 0)
    copied = layout == "nk" and k == 768
    assert (args[2] == stored.data_ptr()) != copied
    assert dx.shape == (rows, k) and dw.shape == (k, n) and db.shape == (n,)


@pytest.mark.parametrize("f", [384, 768])
@pytest.mark.parametrize("d", [384, 768])
def test_gemm_residual_launches_by_width(launches, d, f):
    """K9c (output width d) and K9d (input width f) at every pair of widths:
    the weight's own storage, the widths in the C functions' order, and K9d's
    row groups; dense.cu sends d = 384 (K9c) and f = 384 (K9d) to
    csrc/dense_sm90.cu, the others to its row-tiled kernels."""
    rows = 70
    res, a, dy, w, b = _bf16(rows, d), _bf16(rows, f), _bf16(rows, d), _bf16(f, d), _bf16(d)
    y = tmlp._launch_gemm_res_fwd(res, a, w, b)
    da, dw, db = tmlp._launch_gemm_res_bwd(a, dy, w)
    (fwd_name, fwd), (bwd_name, bwd) = launches
    assert fwd_name == "gemm_res_fwd" and fwd[2] == w.data_ptr() and fwd[5:] == (rows, f, d)
    assert bwd_name == "gemm_res_bwd" and len(bwd) == 10 and bwd[2] == w.data_ptr()
    steps = -(-rows // _FakeLib.tpuwsi_dense_rows_per_step(f))
    assert bwd[6:9] == (rows, f, d) and 1 <= bwd[9] <= steps
    assert y.shape == (rows, d) and da.shape == (rows, f) and dw.shape == (f, d)


@pytest.mark.parametrize("rows", [1, 64, 65, 21312, 37824, 128500])
@pytest.mark.parametrize("k,n", [(384, 1152), (384, 384), (768, 2304), (768, 768)],
                         ids=["s_qkv", "s_proj", "b_qkv", "b_proj"])
def test_dense_row_groups_follow_the_shapes_and_the_card(monkeypatch, launches, rows, k, n):
    """K7's row groups, on meta tensors: between 1 and one per row step, about
    DENSE_DW_WAVES blocks per SM over the output columns' slices, the same on
    every launch and for any contents, and at the step's global views the
    same as the attention sub-block's dW tails take (one dW kernel at width
    384)."""
    import types

    def groups(sms):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: types.SimpleNamespace(multi_processor_count=sms))
        x, dy, w = _bf16(rows, k, device="meta"), _bf16(rows, n, device="meta"), _bf16(
            k, n, device="meta")
        tdense._launch_dense_bwd(x, dy, w)
        return launches[-1][1][9]

    steps = -(-rows // _FakeLib.tpuwsi_dense_rows_per_step(k))
    slices = n // _FakeLib.tpuwsi_dense_cols_per_slice(k)
    for sms in (132, 114, 16):
        got = groups(sms)
        assert got == groups(sms) and 1 <= got <= steps
        blocks = tmlp.DENSE_DW_WAVES * sms  # the grid the groups aim at: at least one group
        assert got == steps or got * slices <= max(blocks, slices) < (got + 1) * slices
    if (rows, k) == (37824, 384):  # the K8b tails' numbers at (192, 197, 384)
        assert groups(132) == {1152: 14, 384: 44}[n]


@pytest.mark.parametrize("d", [384, 768])
def test_hybrid_dense_backward_reads_nn_linear_weight_in_place(monkeypatch, launches, d):
    """The ViT hands ``hybrid_dense`` its nn.Linear's ``weight.t()``. At
    D = 384 the backward passes that weight's own storage with layout 1 and
    copies nothing out of it; at D = 768 it makes the one (D, N) copy the
    row-tiled kernel needs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class Copies(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (aten.clone.default, aten._to_copy.default, aten.copy_.default):
                src = args[1] if func is aten.copy_.default else args[0]
                self.seen.append(src.untyped_storage().data_ptr())
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(tdense, "_use_plain", lambda x: False)  # the kernel's path, faked launch
    layer = torch.nn.Linear(d, 3 * d).to(torch.bfloat16)
    x = torch.zeros(2, 3, d, dtype=torch.bfloat16, requires_grad=True)
    y = tdense.hybrid_dense(x, layer.weight.t(), layer.bias)
    with Copies() as mode:
        y.backward(torch.zeros_like(y))
    ((name, args),) = launches
    copies = mode.seen.count(layer.weight.untyped_storage().data_ptr())
    if d == 384:
        assert args[2] == layer.weight.data_ptr() and args[10] == 1 and copies == 0
    else:
        assert args[2] != layer.weight.data_ptr() and args[10] == 0 and copies == 1
    assert layer.weight.grad.shape == (3 * d, d) and x.grad.shape == x.shape


@pytest.mark.parametrize("layout", ["kn", "nk"], ids=["w_kn", "w_nk"])
@pytest.mark.parametrize("k", [384, 768])
def test_ln_gemm_passes_the_weight_as_stored(launches, k, layout):
    """K9a's and K9b's launches by input width: the weight's own storage with
    layout 1 for nn.Linear's (N, K) at K = 384 (csrc/ln_gemm_sm90.cu reads it
    in place), a (K, N) weight as it is (layout 0), and a (K, N) copy at
    K = 768, whose row-tiled kernels read W only so; the widths, the row
    groups and the outputs' shapes in both directions."""
    from tpuwsi_torch.ops.mlp import _weight_operand

    n, rows = 3 * k, 70
    x, dy = _bf16(rows, k), _bf16(rows, n)
    g, be = torch.ones(k), torch.zeros(k)
    stored = _bf16(k, n) if layout == "kn" else _bf16(n, k)
    w_op, w_layout = _weight_operand(stored if layout == "kn" else stored.t())
    y = tmlp._launch_ln_gemm_fwd(x, g, be, w_op, _bf16(n), 1e-6, w_layout)
    dx, dg, dbe, dw, db = tmlp._launch_ln_gemm_bwd(x, dy, g, be, w_op, 1e-6, w_layout)
    (fwd_name, fwd), (bwd_name, bwd) = launches
    in_place = (layout, k) == ("nk", 384)
    assert w_layout == (1 if in_place else 0)
    assert (w_op.data_ptr() == stored.data_ptr()) == (layout == "kn" or in_place)
    assert fwd_name == "ln_gemm_fwd" and len(fwd) == 11 and fwd[3] == w_op.data_ptr()
    assert fwd[6:9] == (rows, k, n) and fwd[10] == w_layout
    assert bwd_name == "ln_gemm_bwd" and len(bwd) == 16 and bwd[4] == w_op.data_ptr()
    steps = -(-rows // _FakeLib.tpuwsi_dense_rows_per_step(k))
    assert bwd[10:13] == (rows, k, n) and 1 <= bwd[13] <= steps and bwd[15] == w_layout
    assert y.shape == (rows, n) and dx.shape == (rows, k) and dw.shape == (k, n)
    assert dg.shape == dbe.shape == (k,) and db.shape == (n,)


@pytest.mark.parametrize("d", [384, 768])
def test_fused_ln_gemm_reads_nn_linear_weight_in_place(monkeypatch, launches, d):
    """The composed sub-block hands ``fused_ln_gemm`` its nn.Linear's
    ``weight.t()``. At D = 384 K9a and K9b get that weight's own storage with
    layout 1 and nothing is copied out of it; at D = 768 one (D, N) copy
    serves both directions."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class Copies(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (aten.clone.default, aten._to_copy.default, aten.copy_.default):
                src = args[1] if func is aten.copy_.default else args[0]
                self.seen.append(src.untyped_storage().data_ptr())
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(tmlp, "_use_plain", lambda x: False)  # the kernels' path, faked launch
    layer = torch.nn.Linear(d, 3 * d).to(torch.bfloat16)
    g, be = torch.ones(d, requires_grad=True), torch.zeros(d, requires_grad=True)
    x = torch.zeros(2, 3, d, dtype=torch.bfloat16, requires_grad=True)
    with Copies() as mode:
        y = tmlp.fused_ln_gemm(x, g, be, layer.weight.t(), layer.bias)
        y.backward(torch.zeros_like(y))
    (fwd_name, fwd), (bwd_name, bwd) = launches
    copies = mode.seen.count(layer.weight.untyped_storage().data_ptr())
    assert (fwd_name, bwd_name) == ("ln_gemm_fwd", "ln_gemm_bwd") and fwd[3] == bwd[4]
    if d == 384:
        assert fwd[3] == layer.weight.data_ptr() and (fwd[10], bwd[15]) == (1, 1) and copies == 0
    else:
        assert fwd[3] != layer.weight.data_ptr() and (fwd[10], bwd[15]) == (0, 0) and copies == 1
    assert y.shape == (2, 3, 3 * d) and layer.weight.grad.shape == (3 * d, d)
    assert x.grad.shape == x.shape and g.grad.shape == be.grad.shape == (d,)


def test_ln_gemm_refusals_come_before_any_launch(launches):
    """What K9a and K9b do not take raises before a launch: an input width
    they are not built for, an output width that is not a multiple of 64,
    nn.Linear's layout at D = 768, fp32 LayerNorm vectors of the wrong width,
    a bf16 one, a misaligned x, rows x width past 2^31."""
    k, n = 384, 1152
    x, dy, w, b = _bf16(5, k), _bf16(5, n), _bf16(k, n), _bf16(n)
    g, be = torch.ones(k), torch.zeros(k)
    with pytest.raises(ValueError, match=r"widths \(384, 768\)"):
        tmlp._launch_ln_gemm_fwd(_bf16(5, 512), torch.ones(512), torch.zeros(512),
                                 _bf16(512, n), b, 1e-6)
    with pytest.raises(ValueError, match="a multiple of 64"):
        tmlp._launch_ln_gemm_bwd(x, _bf16(5, 100), g, be, _bf16(k, 100), 1e-6)
    with pytest.raises(ValueError, match=r"\(N, D\) weight at D in \(384,\) only"):
        tmlp._launch_ln_gemm_fwd(_bf16(5, 768), torch.ones(768), torch.zeros(768),
                                 _bf16(2304, 768), _bf16(2304), 1e-6, 1)
    with pytest.raises(ValueError, match=r"fp32 \(384,\) ln_scale"):
        tmlp._launch_ln_gemm_fwd(x, torch.ones(768), be, w, b, 1e-6)
    with pytest.raises(ValueError, match=r"fp32 \(384,\) ln_bias"):
        tmlp._launch_ln_gemm_bwd(x, dy, g, be.bfloat16(), w, 1e-6)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tmlp._launch_ln_gemm_fwd(_bf16(5 * k + 1)[1:].view(5, k), g, be, w, b, 1e-6)
    big = 2 ** 31 // n + 1
    with pytest.raises(ValueError, match="2\\^31"):
        tmlp._launch_ln_gemm_bwd(_bf16(big, k, device="meta"), _bf16(big, n, device="meta"),
                                 g, be, w, 1e-6)
    assert launches == []


def test_dense_refusals_come_before_any_launch(launches):
    """What the dense-layer kernels do not take raises before a launch: widths
    they are not built for, an output width K7 does not serve, fp32, a weight
    that is neither (K, N) nor nn.Linear's layout where it is read in place,
    a misaligned tensor, rows x width past 2^31."""
    bf, k = torch.bfloat16, 384
    x, dy, w = _bf16(5, k), _bf16(5, 3 * k), _bf16(k, 3 * k)
    with pytest.raises(ValueError, match=r"widths \(384, 768\)"):
        tdense._launch_dense_bwd(_bf16(5, 512), _bf16(5, 1536), _bf16(512, 1536))
    with pytest.raises(ValueError, match=r"output width in \(384, 1152\)"):
        tdense._launch_dense_bwd(x, _bf16(5, 768), _bf16(k, 768))
    with pytest.raises(ValueError, match="bf16"):
        tdense._launch_dense_bwd(x.float(), dy, w)
    with pytest.raises(ValueError, match=r"\(N, D\) weight at D in \(384,\) only"):
        tdense._check_operands(_bf16(5, 768), _bf16(5, 2304), _bf16(2304, 768), 1)
    with pytest.raises(ValueError, match="contiguous"):
        tdense._check_operands(x, dy, _bf16(3 * k, k).t(), 0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tdense._launch_dense_bwd(_bf16(5 * k + 1)[1:].view(5, k), dy, w)
    big = 2 ** 31 // (3 * k) + 1
    with pytest.raises(ValueError, match="2\\^31"):
        tdense._launch_dense_bwd(_bf16(big, k, device="meta"), _bf16(big, 3 * k, device="meta"),
                                 _bf16(k, 3 * k, device="meta"))
    with pytest.raises(ValueError, match=r"output width in \(384, 768\)"):
        tmlp._launch_gemm_res_fwd(_bf16(5, 512), x, _bf16(k, 512), _bf16(512))
    with pytest.raises(ValueError, match=r"widths \(384, 768\)"):
        tmlp._launch_gemm_res_bwd(_bf16(5, 512), _bf16(5, k), _bf16(512, k))
    assert launches == [] and bf == torch.bfloat16
