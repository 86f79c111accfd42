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
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return (normal((b, n, d), 1.0), 1.0 + normal((d,), 0.1), normal((d,), 0.1),
            normal((d, 3 * d), 0.1), normal((3 * d,), 0.05), normal((d, d), 0.1),
            normal((d,), 0.05))


# (5, 37, 48, 2): the reference packs three images per program under a
# block-diagonal mask and pads the batch to 6; the port takes the images as
# they are, so this case pins that packing is exact
@pytest.mark.parametrize("b,n,d,h", [(5, 37, 48, 2), (2, 197, 96, 3), (3, 70, 128, 2)],
                         ids=["packed-37", "197", "head_dim-64"])
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
    """What the kernels refuse is checked before any launch, so it shows here."""
    d, h = tattn.ATTN_BLOCK_WIDTH, 6
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
    long = torch.zeros(1, tattn.ATTN_BLOCK_MAX_SEQ + 1, d, dtype=bf)
    with pytest.raises(ValueError, match=f"at most {tattn.ATTN_BLOCK_MAX_SEQ}"):
        check(long, g, be, wqkv, bqkv, wp, bp, h)
    with pytest.raises(ValueError, match="contiguous"):
        check(torch.zeros(5, 2, d, dtype=bf).transpose(0, 1), g, be, wqkv, bqkv, wp, bp, h)
    with pytest.raises(ValueError, match="fp32"):
        check(x, g.to(bf), be, wqkv, bqkv, wp, bp, h)
    with pytest.raises(ValueError, match="dy"):
        check(x, g, be, wqkv, bqkv, wp, None, h, dy=torch.zeros(2, 5, d))
    vit_b = torch.zeros(2, 5, 768, dtype=bf)
    with pytest.raises(NotImplementedError, match="D = 384"):
        check(vit_b, g, be, wqkv, bqkv, wp, bp, 12)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_attention_block(torch.zeros(2, 5, d, device="meta"), g, be, wqkv, bqkv, wp, bp, h)
    assert tattn.ATTN_BLOCK_MAX_SEQ >= 257
    assert {"attn_block_fwd", "attn_block_bwd"} <= set(tattn.LAUNCHES)


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
