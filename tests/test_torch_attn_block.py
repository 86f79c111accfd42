"""tpuwsi_torch's attention sub-block op held against the JAX package on the CPU.

``fused_attention_block`` is ``x + MHA(LN(x) @ Wqkv + bqkv) @ Wproj + bproj``
as one op. Inputs and weights come from a numpy seed and go through both
packages in fp32. The JAX side runs its two Pallas kernels in interpret mode;
the port's wrapper takes the plain PyTorch versions, because the tensors lie
on the CPU. Tolerances: 1e-5 on values and 1e-4 on the seven gradients of
``sum(y ** 2)`` (fp32 sums in another order; the gradients pass through two
GEMMs, a softmax and a LayerNorm), 1e-5 between the hand-derived plain
backward and autograd and between the op and the port's own modules, 1e-4 on
a ViT walked with the op. The card-only cases, each kernel against its plain
version, are in ``test_torch_attn_block_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuwsi.ops import attention as jattn
from tpuwsi_torch.models import vit as tvit
from tpuwsi_torch.ops import attention as tattn, mlp as tmlp
from tpuwsi_torch.ops.attention import fused_attention_block, mha_from_qkv

NAMES = ("x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wproj", "bproj")


def _operands(b, n, d, seed):
    """x ~ N(0, 1); the weights' std is 0.1 up to width 128 and shrinks as
    1 / sqrt(D) beyond, so that qkv, the scores and y keep the magnitudes of
    the narrow cases (at std 0.1 and D = 768 y reaches 29 and the gradients
    3e4, where fp32 sums in another order differ by more than 1e-5)."""
    rng = np.random.default_rng(seed)
    wstd = 0.1 * min(1.0, (128 / d) ** 0.5)

    def normal(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return (normal((b, n, d), 1.0), 1.0 + normal((d,), 0.1), normal((d,), 0.1),
            normal((d, 3 * d), wstd), normal((3 * d,), 0.05), normal((d, d), wstd),
            normal((d,), 0.05))


# (5, 37, 48, 2): the reference packs three images per program under a
# block-diagonal mask and pads the batch to 6; the port takes the images as
# they are, so this case pins that packing is exact. (2, 33, 768, 12): ViT-B's
# width and heads, which the kernels take since the head-pair redesign
@pytest.mark.parametrize("b,n,d,h", [(5, 37, 48, 2), (2, 197, 96, 3), (3, 70, 128, 2),
                                     (2, 33, 768, 12)],
                         ids=["packed-37", "197", "head_dim-64", "vit-b"])
def test_fused_attention_block_matches_jax(b, n, d, h):
    """Values at 1e-5 and all seven gradients of sum(y ** 2) at 1e-4."""
    args = _operands(b, n, d, seed=n)
    jargs = tuple(map(jnp.asarray, args))
    want = jattn.fused_attention_block(*jargs, h, interpret=True)
    want_grads = jax.grad(
        lambda a: jnp.sum(jattn.fused_attention_block(*a, h, interpret=True) ** 2))(jargs)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = fused_attention_block(*targs, h)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    (got ** 2).sum().backward()
    for name, t, w in zip(NAMES, targs, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"gradient of {name}")


def test_plain_backward_matches_autograd():
    """The hand-derived plain backward against autograd of the plain forward,
    fp32, 1e-5 relative to each gradient's largest element."""
    b, n, d, h = 3, 21, 128, 2
    args = [torch.from_numpy(a) for a in _operands(b, n, d, seed=3)]
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal((b, n, d)).astype(np.float32))
    scale = (d // h) ** -0.5
    leaves = [a.clone().requires_grad_() for a in args]
    y = tattn._attn_block_fwd_reference(*leaves, h, scale, 1e-6)
    want = torch.autograd.grad(y, leaves, cot)
    got = tattn._attn_block_bwd_reference(args[0], cot, *args[1:6], h, scale, 1e-6)
    assert len(got) == 7
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()), err_msg=name)


def test_bf16_compute_rounds_weight_gradients():
    """With bf16 compute dW and db of qkv and proj reach the fp32 parameters
    rounded to bf16, as the reference's vjp returns them in the weights' type;
    the LayerNorm gradients stay fp32. ``dbqkv`` is the sum of the UNROUNDED
    dqkv (the reference's line 1545): it differs from the sum of the rounded
    dqkv, which is what dWqkv and dln are built from."""
    b, n, d, h = 2, 33, 128, 2
    args = _operands(b, n, d, seed=5)
    x = torch.from_numpy(args[0]).bfloat16()
    params = [torch.from_numpy(a).requires_grad_() for a in args[1:]]
    y = fused_attention_block(x, *params, h)
    assert y.dtype == torch.bfloat16
    cot = torch.from_numpy(np.random.default_rng(6).standard_normal((b, n, d)).astype(np.float32))
    (y.float() * cot).sum().backward()
    for p in params[2:]:
        assert p.grad.dtype == torch.float32 and p.grad.abs().max() > 0
        assert torch.equal(p.grad, p.grad.bfloat16().float())
    for p in params[:2]:  # gamma, beta
        assert p.grad.dtype == torch.float32
        assert not torch.equal(p.grad, p.grad.bfloat16().float())

    dt = torch.bfloat16
    cast = [params[0].detach(), params[1].detach(), *(p.detach().to(dt) for p in params[2:])]
    scale = (d // h) ** -0.5
    dbqkv = tattn._attn_block_bwd_reference(x, cot.to(dt), *cast[:5], h, scale, 1e-6)[4]
    assert torch.equal(params[3].grad, dbqkv.to(dt).float())
    qkv = tattn._attn_block_qkv(x, *cast[:4], 1e-6)[3]
    do = tmlp._mm(cot.to(dt).reshape(-1, d), cast[4].t()).to(dt).reshape(b, n, d)
    p = tattn._probs(qkv, h, scale, 0)
    core = tattn._dqkv_core(qkv, do, p.to(dt).float(), p, h, scale).reshape(-1, 3 * d)
    assert torch.equal(dbqkv, core.sum(dim=0))
    assert not torch.equal(dbqkv, core.to(dt).float().sum(dim=0))


def _block(d=128, heads=2, seed=0):
    torch.manual_seed(seed)
    blk = tvit.Block(tvit.ViTConfig(img_size=32, patch_size=8, embed_dim=d, depth=1,
                                    num_heads=heads, dtype=torch.float32))
    with torch.no_grad():
        for p in blk.parameters():  # non-trivial LayerNorm affine and biases
            p.add_(0.1 * torch.randn_like(p))
    return blk


def block_attention_half(blk, x, **kw):
    """One block's attention half through the op, on that block's parameters
    (torch ``Linear`` weights are ``(out, in)``; the op takes ``(in, out)``)."""
    return fused_attention_block(
        x, blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight.t(), blk.attn.qkv.bias,
        blk.attn.proj.weight.t(), blk.attn.proj.bias, blk.attn.num_heads, eps=blk.norm1.eps, **kw)


@pytest.mark.parametrize("other", ["block", "composed"])
def test_op_matches_the_ports_own_modules(other):
    """Against ``x + Block.attn(Block.norm1(x))`` and against the composed
    ``fused_gemm_residual(x, mha_from_qkv(fused_ln_gemm(x)))``: value and all
    seven gradients, fp32, 1e-5."""
    blk = _block()
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, 17, 128)).astype(np.float32)).requires_grad_()
    cot = torch.from_numpy(rng.standard_normal((3, 17, 128)).astype(np.float32))
    params = [blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight, blk.attn.qkv.bias,
              blk.attn.proj.weight, blk.attn.proj.bias]
    if other == "block":
        want = x + blk.attn(blk.norm1(x))
    else:
        qkv = tmlp.fused_ln_gemm(x, blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight.t(),
                                 blk.attn.qkv.bias, eps=blk.norm1.eps)
        want = tmlp.fused_gemm_residual(x, mha_from_qkv(qkv, blk.attn.num_heads, training=True),
                                        blk.attn.proj.weight.t(), blk.attn.proj.bias)
    want_grads = torch.autograd.grad(want, [x, *params], cot)
    got = block_attention_half(blk, x)
    got_grads = torch.autograd.grad(got, [x, *params], cot)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5, rtol=1e-5)
    for i, (a, c) in enumerate(zip(got_grads, want_grads)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=f"gradient {i}")


def test_unsupported_inputs_raise():
    """What the kernels refuse is checked before any launch, so it shows here.
    ViT-S (384, 6 heads) and ViT-B (768, 12 heads) are taken; other widths,
    or 768 with heads that are not 64 wide, are not."""
    d, h = 384, 6
    bf = torch.bfloat16
    x = torch.zeros(2, 5, d, dtype=bf)
    g, be = torch.ones(d), torch.zeros(d)
    wqkv, bqkv, wp, bp = (torch.zeros(s, dtype=bf) for s in ((d, 3 * d), (3 * d,), (d, d), (d,)))
    check = tattn.check_attn_block_operands
    check(x, g, be, wqkv, bqkv, wp, bp, h)  # taken as it is
    with pytest.raises(ValueError, match="bf16"):
        check(x.float(), g, be, wqkv, bqkv, wp, bp, h)
    with pytest.raises(ValueError, match="head_dim 64"):
        check(x, g, be, wqkv, bqkv, wp, bp, 12)
    long = torch.zeros(1, tattn.ATTN_BLOCK_MAX_SEQ[d] + 1, d, dtype=bf)
    with pytest.raises(ValueError, match=f"at most {tattn.ATTN_BLOCK_MAX_SEQ[d]}"):
        check(long, g, be, wqkv, bqkv, wp, bp, h)
    with pytest.raises(ValueError, match="contiguous"):
        check(torch.zeros(5, 2, d, dtype=bf).transpose(0, 1), g, be, wqkv, bqkv, wp, bp, h)
    with pytest.raises(ValueError, match="fp32"):
        check(x, g.to(bf), be, wqkv, bqkv, wp, bp, h)
    with pytest.raises(ValueError, match="dy"):
        check(x, g, be, wqkv, bqkv, wp, None, h, dy=torch.zeros(2, 5, d))
    e = 768
    vit_b = [torch.zeros(2, 5, e, dtype=bf), torch.ones(e), torch.zeros(e),
             *(torch.zeros(s, dtype=bf) for s in ((e, 3 * e), (3 * e,), (e, e), (e,)))]
    check(*vit_b, 12)  # ViT-B: taken
    check(*vit_b, 12, dy=torch.zeros(2, 5, e, dtype=bf))
    with pytest.raises(ValueError, match="head_dim 64"):
        check(*vit_b, 6)
    f = 512  # 8 heads of 64: no kernel of that width
    other = [torch.zeros(2, 5, f, dtype=bf), torch.ones(f), torch.zeros(f),
             *(torch.zeros(s, dtype=bf) for s in ((f, 3 * f), (3 * f,), (f, f), (f,)))]
    with pytest.raises(NotImplementedError, match="D = 384 .* and D = 768"):
        check(*other, 8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_attention_block(torch.zeros(2, 5, d, device="meta"), g, be, wqkv, bqkv, wp, bp, h)
    assert tattn.ATTN_BLOCK_MAX_SEQ[384] >= 304 and tattn.ATTN_BLOCK_MAX_SEQ[768] >= 257
    assert {"attn_block_fwd", "attn_block_bwd"} <= set(tattn.LAUNCHES)


class _FakeLib:
    """The library's shape queries as csrc/ builds them, for meta-tensor tests."""
    tpuwsi_dense_rows_per_step = staticmethod(lambda d: 64 if d <= 384 else 32)
    tpuwsi_dense_cols_per_slice = staticmethod(lambda d: 64 if d <= 384 else 32)
    tpuwsi_mlp_rows_per_tile = staticmethod(lambda d: 64 if d <= 384 else 32)


@pytest.fixture
def card_shapes(monkeypatch):
    """The sub-block wrappers on meta tensors: the library's shape queries and
    132 SMs stand in for the card, and each launch is recorded instead of made."""
    import types

    from tpuwsi_torch.ops import _build

    monkeypatch.setattr(_build, "load", lambda: _FakeLib)
    monkeypatch.setattr(tattn, "_check_clusters", lambda x, n: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    calls = []
    monkeypatch.setattr(tattn, "_call", lambda name, like, args: calls.append((name, args)))
    return calls


def _meta_operands(b, n, d):
    bf = torch.bfloat16
    shapes = {"x": ((b, n, d), bf), "g": ((d,), torch.float32), "be": ((d,), torch.float32),
              "wqkv": ((d, 3 * d), bf), "bqkv": ((3 * d,), bf), "wp": ((d, d), bf),
              "bp": ((d,), bf), "dy": ((b, n, d), bf)}
    return {k: torch.empty(shape, dtype=dt, device="meta") for k, (shape, dt) in shapes.items()}


def test_kernels_take_more_than_65535_images(card_shapes):
    """F7: the sub-block kernels' grids are persistent and their offsets
    64-bit, so 65,536 images of 16 tokens pass the checks and reach both
    launches with that batch; the buffers of the backward are sized for it.
    What remains refused are the int counts: (image, head) items past 2^31,
    and past 2^31 elements of dqkv in the backward. Shapes only: meta tensors
    hold no data."""
    b, n, d, h = 65536, 16, 384, 6
    o = _meta_operands(b, n, d)
    args = (o["g"], o["be"], o["wqkv"], o["bqkv"], o["wp"])
    y = tattn._launch_attn_block_fwd(o["x"], *args, o["bp"], h, 0.125, 1e-6)
    grads = tattn._launch_attn_block_bwd(o["x"], o["dy"], *args, h, 0.125, 1e-6)
    (fwd_name, fwd_args), (bwd_name, bwd_args) = card_shapes
    assert (fwd_name, fwd_args[9:13]) == ("attn_block_fwd", (b, n, d, h))
    assert (bwd_name, bwd_args[16:20]) == ("attn_block_bwd", (b, n, d, h))
    groups = bwd_args[20:22]
    assert all(1 <= gr <= 65535 for gr in groups)
    assert y.shape == (b, n, d) and len(grads) == 7 and grads[0].shape == (b, n, d)
    assert [tuple(t.shape) for t in grads[1:]] == [(d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,)]
    past = _meta_operands(tattn.KERNEL_MAX_ITEMS // h + 1, 1, d)
    with pytest.raises(NotImplementedError, match="item count"):
        tattn.check_attn_block_operands(past["x"], *args, o["bp"], h)
    big = _meta_operands(2 ** 31 // (3 * 768 * 16) + 1, 16, 768)
    tattn.check_attn_block_operands(big["x"], big["g"], big["be"], big["wqkv"], big["bqkv"],
                                    big["wp"], big["bp"], 12)  # the forward takes it
    with pytest.raises(NotImplementedError, match="2\\^31"):
        tattn.check_attn_block_operands(big["x"], big["g"], big["be"], big["wqkv"], big["bqkv"],
                                        big["wp"], None, 12, dy=big["dy"])
    assert len(card_shapes) == 2


@pytest.mark.parametrize("d", [384, 768])
def test_launch_geometry_by_width(d):
    """The launch csrc/attn_block.cu makes, computed in Python: a cluster of
    D / 128 blocks (two heads each: 3 at ViT-S, 6 at ViT-B, both within the
    portable 8); a persistent forward grid of at most the clusters the card
    holds, and at small batch each image's 64-row query tiles split over as
    many clusters as the card has to spare (each running the image's K/V
    pass); a persistent backward grid of at most one block per SM over the
    (image, head) items; shared memory within 227 KB with at least two
    weight stages (forward) and one ring stage (backward) at every length
    the kernels take."""
    heads = d // 64
    for n in (1, 16, 37, 64, 65, 197, 208, 257, 304):
        geo = tattn.attn_block_geometry(8, n, d, sms=132, clusters=44)
        tiles = -(-n // 64)
        assert geo["cluster"] == d // 128 == heads // 2
        assert geo["groups"] == min(tiles, 44 // 8) and 1 <= geo["groups"] <= tiles
        assert geo["fwd_grid"] == min(44, 8 * geo["groups"]) * geo["cluster"]
        assert geo["bwd_grid"] == min(8 * heads, 132)
        assert geo["fwd_smem"] <= 232448 and geo["fwd_w_stages"] >= 2
        assert geo["bwd_smem"] <= 232448 and geo["bwd_stages"] >= 1
    for b in (192, 500, 65536):
        geo = tattn.attn_block_geometry(b, 197, d, sms=132, clusters=44)
        assert geo["groups"] == 1
        assert geo["fwd_grid"] == 44 * (d // 128) and geo["bwd_grid"] == 132
    # the longest sequence leaves the fewest stages; 197 tokens more of them
    assert tattn.attn_block_geometry(1, 304, d, 132, 44)["fwd_w_stages"] == 2
    assert tattn.attn_block_geometry(1, 197, d, 132, 44)["fwd_w_stages"] >= 4


def test_vit_walked_with_the_op_matches_forward_features():
    """A depth-2 ViT whose every block takes its attention half through the op
    (patch embedding, MLP half, final norm as the model's own modules: the
    walk of ``forward_features``) against ``forward_features``, fp32, 1e-4."""
    torch.manual_seed(1)
    cfg = tvit.ViTConfig(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
                         dtype=torch.float32)
    model = tvit.VisionTransformer(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn_like(p))
    images = torch.from_numpy(
        np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        want = model.forward_features(images)
        x, (gh, gw) = model.patch_embed(images)
        x = torch.cat([model.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + tvit.interpolate_pos_encoding(model.pos_embed, gh * gw, gh, gw)
        for blk in model.blocks:
            x = block_attention_half(blk, x)
            x = x + blk.mlp(blk.norm2(x))
        got = model.norm(x)[:, 0].float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
