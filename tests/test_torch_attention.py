"""tpuwsi_torch.ops.attention held against tpuwsi.ops.attention.

Inputs come from a numpy seed and go through both packages. The JAX side
runs its Pallas kernels in interpret mode; the port's wrappers run their
plain versions on a CPU tensor. Tolerances: fp32 inputs 1e-5 on the output
and 1e-4 on dqkv (the same math in another summation order); bf16 inputs
2e-2 max-abs and 2e-3 mean-abs (bf16 roundings of q*scale, p and dS fall on
different sides of a tie in the two packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuwsi.ops import attention as jattn
from tpuwsi_torch.ops import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "b,n,heads,hd,block_len",
    [
        (2, 65, 2, 16, 0),   # just past the 64-token dispatch floor
        (2, 70, 2, 16, 0),   # ragged: 70 rows in a 128-row tile
        (2, 20, 2, 16, 5),   # packed: four 5-token sub-sequences
    ],
)
def test_mha_from_qkv_matches_pallas_kernel(b, n, heads, hd, block_len):
    rng = np.random.default_rng(n + block_len)
    x = rng.standard_normal((b, n, 3 * heads * hd), dtype=np.float32)
    ref = jattn.mha_from_qkv(jnp.asarray(x), heads, interpret=True, block_len=block_len)
    before = dict(tattn.LAUNCHES)
    out = tattn.mha_from_qkv(torch.from_numpy(x), heads, block_len=block_len)
    assert tattn.LAUNCHES == before  # a CPU tensor never reaches the kernel
    assert out.shape == (b, n, heads * hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_attention_reference_kv_lengths_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((3, 2, 40, 16), dtype=np.float32) for _ in range(3))
    lengths = np.array([40, 17, 1], dtype=np.int32)
    ref = jattn.attention_reference(*map(jnp.asarray, (q, k, v)),
                                    kv_lengths=jnp.asarray(lengths))
    out = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                    kv_lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize(
    "shape,heads,dtype,err",
    [
        ((2, 65, 3 * 128), 2, torch.float32, ValueError),    # not bf16
        ((2, 65, 3 * 96), 2, torch.bfloat16, ValueError),    # head_dim 48
        # 512+ tokens belong to the flash kernels: mha_from_qkv never hands
        # them to the whole-sequence kernels, which refuse them
        ((2, 512, 3 * 128), 2, torch.bfloat16, ValueError),
    ],
)
def test_kernel_rejects_what_it_does_not_take(shape, heads, dtype, err):
    with pytest.raises(err):
        tattn.check_kernel_input(torch.zeros(shape, dtype=dtype), heads)


def test_kernel_takes_more_than_65535_sequences():
    """The whole-sequence kernels' grids are persistent and their offsets
    64-bit, so a batch past 65,535 goes to them; only batch x heads past
    their int item count is refused. Shapes only: meta tensors hold no data."""
    qkv = torch.empty((65536, 16, 3 * 384), dtype=torch.bfloat16, device="meta")
    tattn.check_kernel_input(qkv, 6)
    past = torch.empty((tattn.KERNEL_MAX_ITEMS // 6 + 1, 1, 3 * 384), dtype=torch.bfloat16,
                       device="meta")
    with pytest.raises(NotImplementedError):
        tattn.check_kernel_input(past, 6)


# The forward kernel's branches: one 16-key chunk, the 48-key score width
# and one past it, one 64-row tile and a second, the last key held in
# registers (208) and the first parked in shared memory, the last a
# warpgroup takes alone (272) and the first where two share a tile, the
# longest sequence; ViT-B's 12 heads; a block mask across tiles.
_FWD_EDGES = [(8, 257, 6, 0), (6, 111, 6, 37), (5, 1, 6, 0), (5, 16, 6, 0), (4, 48, 6, 0),
              (4, 49, 6, 0), (4, 64, 6, 0), (4, 65, 6, 0), (3, 208, 6, 0), (3, 209, 6, 0),
              (3, 272, 6, 0), (3, 273, 6, 0), (2, 511, 6, 0), (4, 257, 12, 0), (2, 400, 6, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,heads,block_len", _FWD_EDGES)
def test_kernel_matches_plain_on_card(b, n, heads, block_len):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((b, n, 3 * heads * 64), generator=g, device="cuda").to(torch.bfloat16)
    before = tattn.LAUNCHES["mha_qkv_fwd"]
    out = tattn.mha_from_qkv(qkv, heads, block_len=block_len)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["mha_qkv_fwd"] == before + 1
    ref = tattn._mha_reference(qkv, heads, 64 ** -0.5, block_len)
    diff = (out.float() - ref.float()).abs()
    # bf16 rounding of q*scale and of p, fp32 accumulation
    assert diff.max().item() <= 2e-2 and diff.mean().item() <= 2e-3


# (B, N, heads, packed): hd 64, D 128. packed: the port is given the
# sequences three to a row with block_len = N, as the JAX function packs them
# itself for N <= 64. 213 lies past the length where the card's backward
# stops holding an item on chip (208) and streams it instead.
_TRAIN_CASES = [(2, 197, 2, False), (6, 37, 2, False), (6, 37, 2, True), (2, 130, 2, False),
                (2, 213, 2, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("save_probs", [True, False], ids=["saved", "recompute"])
@pytest.mark.parametrize("b,n,heads,packed", _TRAIN_CASES)
def test_training_pair_matches_pallas_kernels(b, n, heads, packed, save_probs, dtype):
    """Forward and vjp of ``mha_from_qkv(training=True)``: the saving pair
    (``_mha_qkv_kernel_saved`` + ``_mha_qkv_bwd_kernel_saved``) or the
    recomputing pair (``_mha_qkv_kernel`` + ``_mha_qkv_bwd_kernel``)."""
    rng = np.random.default_rng(1000 * n + b)
    d = heads * 64
    x = rng.standard_normal((b, n, 3 * d), dtype=np.float32)
    g = rng.standard_normal((b, n, d), dtype=np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def f(q):
        return jattn.mha_from_qkv(q, heads, interpret=True, training=True,
                                  save_probs=save_probs)

    ref_out, vjp = jax.vjp(f, jnp.asarray(x, jdt))
    (ref_dx,) = vjp(jnp.asarray(g, jdt))
    ref_out = np.asarray(ref_out.astype(jnp.float32))
    ref_dx = np.asarray(ref_dx.astype(jnp.float32))

    qkv = torch.from_numpy(x).to(tdt).requires_grad_()
    before = dict(tattn.LAUNCHES)
    if packed:
        out = tattn.mha_from_qkv(qkv.reshape(b // 3, 3 * n, 3 * d), heads, block_len=n,
                                 training=True, save_probs=save_probs).reshape(b, n, d)
    else:
        out = tattn.mha_from_qkv(qkv, heads, training=True, save_probs=save_probs)
    out.backward(torch.from_numpy(g).to(tdt))
    assert tattn.LAUNCHES == before
    assert out.dtype == tdt and qkv.grad.dtype == tdt and qkv.grad.shape == qkv.shape
    out, dx = out.detach().float().numpy(), qkv.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref_out, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(dx, ref_dx, atol=1e-4, rtol=1e-4)
    else:
        for got, want in ((out, ref_out), (dx, ref_dx)):
            diff = np.abs(got - want)
            assert diff.max() <= 2e-2 and diff.mean() <= 2e-3


@pytest.mark.parametrize("n,block_len", [(20, 0), (20, 5), (37, 0)])
def test_saved_probabilities_layout(n, block_len):
    """The plain saving forward: p is (B, H, N, stride) with the stride a
    multiple of 16, zero pad columns, exact zeros across blocks, unit rows;
    and the p it stores is the p that multiplies V."""
    rng = np.random.default_rng(n)
    qkv = torch.from_numpy(rng.standard_normal((2, n, 3 * 32), dtype=np.float32))
    out, p = tattn._mha_saved_reference(qkv, 2, 16 ** -0.5, block_len)
    assert p.shape == (2, 2, n, tattn.probs_stride(n)) and p.shape[-1] % 16 == 0
    assert (p[..., n:] == 0).all()
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-6)
    if block_len:
        blk = torch.arange(n) // block_len
        assert (p[..., :n][:, :, blk[:, None] != blk[None, :]] == 0).all()
    v = qkv.reshape(2, n, 3, 2, 16)[:, :, 2]
    np.testing.assert_allclose(
        out.numpy(), torch.einsum("bhqk,bkhd->bqhd", p[..., :n], v).reshape(2, n, 32).numpy(),
        atol=1e-6)
    np.testing.assert_allclose(
        out.numpy(), tattn._mha_reference(qkv, 2, 16 ** -0.5, block_len).numpy(), atol=1e-5)


def test_analytic_backward_matches_autograd_in_fp32():
    """In fp32 the roundings are no-ops, so both plain backwards equal
    autograd's gradient of the plain forward."""
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((2, 24, 3 * 32), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 24, 32), dtype=np.float32))
    x = qkv.clone().requires_grad_()
    (want,) = torch.autograd.grad(tattn._mha_reference(x, 2, 0.25, 8), x, g)
    _, p = tattn._mha_saved_reference(qkv, 2, 0.25, 8)
    np.testing.assert_allclose(
        tattn._mha_bwd_saved_reference(qkv, g, p, 2, 0.25).numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(
        tattn._mha_bwd_reference(qkv, g, 2, 0.25, 8).numpy(), want.numpy(), atol=1e-5)


# The backward kernels' branch edges (mha_qkv_bwd.cu): one token, one k16
# step, the last length with three item slots a warpgroup (48) and the first
# with two, one and two 64-row tiles, the last length where each warpgroup runs
# its own items and the first where both share one, the fourth tile, the last
# resident length (208) and the first streamed one, 272/273, a block mask in
# the streamed form.
_BWD_EDGES = [(7, 1, 6, 0), (5, 16, 6, 0), (4, 48, 6, 0), (4, 49, 6, 0), (4, 64, 6, 0),
              (4, 65, 6, 0), (3, 128, 6, 0), (3, 129, 6, 0), (3, 192, 6, 0), (3, 193, 6, 0),
              (3, 208, 6, 0), (3, 209, 6, 0), (3, 272, 6, 0), (3, 273, 6, 0), (2, 400, 6, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("save_probs", [True, False], ids=["saved", "recompute"])
@pytest.mark.parametrize("b,n,heads,block_len",
                         [(8, 197, 6, 0), (12, 37, 6, 0), (4, 111, 6, 37), (2, 511, 2, 0),
                          *_BWD_EDGES])
def test_training_kernels_match_plain_on_card(b, n, heads, block_len, save_probs):
    """The training pair against its plain version; the backward launched
    again on the same inputs gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = heads * 64
    qkv = torch.randn((b, n, 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
    fwd, bwd = (("mha_qkv_fwd_saved", "mha_qkv_bwd_saved") if save_probs
                else ("mha_qkv_fwd", "mha_qkv_bwd"))
    results = []
    for plain in (False, True):
        x = qkv.clone().requires_grad_()
        before = dict(tattn.LAUNCHES)
        out = tattn.mha_from_qkv(x, heads, block_len=block_len, training=True,
                                 save_probs=save_probs, plain=plain)
        out.backward(g, retain_graph=True)
        torch.cuda.synchronize()
        step = 0 if plain else 1
        assert tattn.LAUNCHES[fwd] == before[fwd] + step
        assert tattn.LAUNCHES[bwd] == before[bwd] + step
        results.append((out.detach().float(), x.grad.float()))
        if not plain:
            first = x.grad.clone()
            x.grad = None
            out.backward(g)
            torch.cuda.synchronize()
            assert torch.equal(x.grad, first)
    for got, want in zip(*results):
        diff = (got - want).abs()
        # bf16 rounding of q*scale, p and dS; fp32 accumulation
        assert torch.isfinite(got).all()
        assert diff.max().item() <= 2e-2 and diff.mean().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("save_probs", [True, False], ids=["saved", "recompute"])
def test_batch_past_65535_matches_plain_on_card(save_probs):
    """65,536 sequences of 16 tokens, D 384, 6 heads: K2 (inference) and
    the training pair (K1a and K1b, or K2 and K3) against their plain
    versions at the tolerances of the other card cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    b, n, heads = 65536, 16, 6
    gen = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn((b, n, 3 * heads * 64), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((b, n, heads * 64), generator=gen, device="cuda").to(torch.bfloat16)
    before = dict(tattn.LAUNCHES)
    out = tattn.mha_from_qkv(qkv, heads)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["mha_qkv_fwd"] == before["mha_qkv_fwd"] + 1
    diff = (out.float() - tattn._mha_reference(qkv, heads, 64 ** -0.5, 0).float()).abs()
    assert diff.max().item() <= 2e-2 and diff.mean().item() <= 2e-3
    results = []
    for plain in (False, True):
        x = qkv.clone().requires_grad_()
        o = tattn.mha_from_qkv(x, heads, training=True, save_probs=save_probs, plain=plain)
        o.backward(g)
        torch.cuda.synchronize()
        results.append((o.detach().float(), x.grad.float()))
        del x, o
    bwd = "mha_qkv_bwd_saved" if save_probs else "mha_qkv_bwd"
    assert tattn.LAUNCHES[bwd] == before[bwd] + 1
    for got, want in zip(*results):
        diff = (got - want).abs()
        assert torch.isfinite(got).all()
        assert diff.max().item() <= 2e-2 and diff.mean().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,heads,block_len", _FWD_EDGES)
def test_saving_forward_matches_plain_on_card(b, n, heads, block_len):
    """The saving forward at the forward kernel's branches: o and the stored
    bf16 p against the plain version, the pad columns exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn((b, n, 3 * heads * 64), generator=g, device="cuda").to(torch.bfloat16)
    before = tattn.LAUNCHES["mha_qkv_fwd_saved"]
    out, p = tattn._launch_fwd_saved(qkv, heads, 64 ** -0.5, block_len)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["mha_qkv_fwd_saved"] == before + 1
    out_ref, p_ref = tattn._mha_saved_reference(qkv, heads, 64 ** -0.5, block_len)
    assert (p[..., n:] == 0).all()
    for got, want in ((out, out_ref), (p, p_ref)):
        diff = (got.float() - want.float()).abs()
        # bf16 rounding of q*scale and of p, fp32 accumulation
        assert torch.isfinite(got.float()).all()
        assert diff.max().item() <= 2e-2 and diff.mean().item() <= 2e-3
