"""tpuwsi_torch's tiled (flash) attention held against tpuwsi.ops.attention.

Inputs come from a numpy seed and go through both packages. The JAX side
runs its Pallas flash kernels in interpret mode with 64-row tiles; the
port's wrappers run their plain versions on a CPU tensor, 64 keys at a time.
Tolerances: fp32 inputs 1e-5 on outputs and lse and 1e-4 on gradients (the
same math in another summation order); bf16 inputs 8e-3 on outputs and 3e-2
on gradients, as the JAX package's own tests hold its kernels (p and dS are
rounded to bf16 at the same points, on either side of a tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuwsi.ops import attention as jattn
from tpuwsi_torch.ops import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
TILE = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these CPU runs are tiny, and the test runner's
    other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(seed, b, h, s, hd, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, hd), dtype=np.float32) for _ in range(n)]


def _jax_forward(q, k, v, lengths=None, dtype=jnp.float32):
    """The Pallas forward with statistics → (o, lse (B, H, S)) as numpy fp32."""
    b, h, s, hd = q.shape
    lens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    o, lse = jattn._flash_forward(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), lens, hd ** -0.5, TILE, TILE, True,
        return_stats=True)
    # the JAX lse is padded to a whole number of tiles
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse).reshape(b, h, -1)[..., :s]


@pytest.mark.parametrize("s", [197, 130])
def test_flash_reference_matches_pallas_forward(s):
    q, k, v = _qkv(s, 2, 2, s, 32)
    ref_o, ref_lse = _jax_forward(q, k, v)
    o, lse = tattn._flash_reference(*map(torch.from_numpy, (q, k, v)))
    assert o.shape == (2, 2, s, 32) and lse.shape == (2, 2, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), ref_o, **TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **TOL)
    # the same function as plain softmax attention
    want = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), want.numpy(), **TOL)


def test_flash_reference_kv_lengths_match_pallas_forward():
    s = 130
    lengths = np.array([s, 57, 1, 0], dtype=np.int32)
    q, k, v = _qkv(5, 4, 2, s, 32)
    ref_o, ref_lse = _jax_forward(q, k, v, lengths)
    o, lse = tattn._flash_reference(*map(torch.from_numpy, (q, k, v)),
                                    kv_lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(o.numpy(), ref_o, **TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **TOL)
    # no valid key: zeros and lse 0, not an average of v and not -1e30
    assert (o[3] == 0).all() and (lse[3] == 0).all()
    assert (ref_o[3] == 0).all() and (ref_lse[3] == 0).all()
    # through the public function, which takes the plain forward on the CPU
    out = tattn.fused_attention(*map(torch.from_numpy, (q, k, v)),
                                kv_lengths=torch.from_numpy(lengths), force_kernel=True)
    assert torch.equal(out, o)


@pytest.mark.parametrize("s", [197, 130])
def test_fused_attention_gradients_match_pallas_backward(s):
    q, k, v, g = _qkv(10 + s, 2, 2, s, 32, n=4)

    def f(q, k, v):
        return jattn.fused_attention(q, k, v, tile_q=TILE, tile_k=TILE, interpret=True)

    ref_o, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    before = dict(tattn.LAUNCHES)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.fused_attention(tq, tk, tv, force_kernel=True)
    assert isinstance(out.grad_fn, tattn._FusedAttention._backward_cls)
    out.backward(torch.from_numpy(g))
    assert tattn.LAUNCHES == before  # a CPU tensor never reaches a kernel
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_o), **TOL)
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), ref_grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"d{name}",
                                   **GRAD_TOL)


def test_flash_bwd_reference_matches_pallas_backward():
    """The two backward kernels called directly, both sides fed the JAX
    forward's output and lse."""
    s = 197
    q, k, v, g = _qkv(3, 2, 2, s, 32, n=4)
    scale = 32 ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jattn._flash_forward(jq, jk, jv, None, scale, TILE, TILE, True, return_stats=True)
    ref = jattn._flash_backward(jq, jk, jv, o, jg, lse, scale, TILE, TILE, True)
    to = torch.from_numpy(np.array(o))
    tlse = torch.from_numpy(np.asarray(lse).reshape(2, 2, -1)[..., :s].copy())
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    delta = tattn._flash_delta(to, tg)
    assert delta.shape == (2, 2, s) and delta.dtype == torch.float32
    got = tattn._flash_bwd_reference(tq, tk, tv, tg, tlse, delta, scale)
    for a, b, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d{name}", **GRAD_TOL)


def test_flash_bwd_reference_matches_pallas_backward_at_unequal_lengths():
    """Sq != Sk: the two backward kernels' plain version against the Pallas
    pair in interpret mode, fed the JAX forward's output and lse."""
    sq, sk = 40, 100
    rng = np.random.default_rng(4100)
    q, g = (rng.standard_normal((1, 2, sq, 32), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, 2, sk, 32), dtype=np.float32) for _ in range(2))
    scale = 32 ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jattn._flash_forward(jq, jk, jv, None, scale, TILE, TILE, True, return_stats=True)
    ref = jattn._flash_backward(jq, jk, jv, o, jg, lse, scale, TILE, TILE, True)
    tlse = torch.from_numpy(np.asarray(lse).reshape(1, 2, -1)[..., :sq].copy())
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    delta = tattn._flash_delta(torch.from_numpy(np.array(o)), tg)
    got = tattn._flash_bwd_reference(tq, tk, tv, tg, tlse, delta, scale)
    assert [x.shape for x in got] == [(1, 2, sq, 32), (1, 2, sk, 32), (1, 2, sk, 32)]
    for a, b, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d{name}", **GRAD_TOL)


def test_flash_pair_in_bf16_rounds_where_the_pallas_kernels_do():
    s = 130
    q, k, v, g = _qkv(17, 2, 2, s, 32, n=4)
    bf = jnp.bfloat16

    def f(q, k, v):
        return jattn.fused_attention(q, k, v, tile_q=TILE, tile_k=TILE, interpret=True)

    ref_o, vjp = jax.vjp(f, *(jnp.asarray(x, bf) for x in (q, k, v)))
    ref_grads = vjp(jnp.asarray(g, bf))
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    out = tattn.fused_attention(tq, tk, tv, force_kernel=True)
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.dtype == tq.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref_o.astype(jnp.float32)), atol=8e-3, rtol=8e-3)
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), ref_grads, "qkv"):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=3e-2, rtol=3e-2, err_msg=f"d{name}")


def test_mha_from_qkv_takes_the_flash_pair_from_512_tokens(monkeypatch):
    """530 tokens: value and gradient against the JAX function (which takes
    its plain reference on the CPU), through the plain flash pair and its
    autograd.Function, without a transposing copy on the way out."""
    b, n, heads, hd = 2, 530, 2, 16
    rng = np.random.default_rng(530)
    x = rng.standard_normal((b, n, 3 * heads * hd), dtype=np.float32)
    g = rng.standard_normal((b, n, heads * hd), dtype=np.float32)
    ref_o, vjp = jax.vjp(lambda t: jattn.mha_from_qkv(t, heads, training=True), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))

    calls = []
    for name in ("_flash_reference", "_flash_bwd_reference", "_mha_reference",
                 "_mha_saved_reference"):
        def spy(*args, _real=getattr(tattn, name), _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(tattn, name, spy)
    before = dict(tattn.LAUNCHES)
    qkv = torch.from_numpy(x).requires_grad_()
    out = tattn.mha_from_qkv(qkv, heads, training=True, save_probs=True)  # save_probs: no effect
    out.backward(torch.from_numpy(g))
    assert calls == ["_flash_reference", "_flash_bwd_reference"]
    assert tattn.LAUNCHES == before
    assert out.shape == (b, n, heads * hd) and out.is_contiguous()
    assert qkv.grad.shape == qkv.shape and qkv.grad.is_contiguous()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_o), **TOL)
    np.testing.assert_allclose(qkv.grad.numpy(), np.asarray(ref_dx), **GRAD_TOL)
    # without a gradient the forward alone runs, and gives the same values
    calls.clear()
    with torch.no_grad():
        again = tattn.mha_from_qkv(qkv, heads)
    assert calls == ["_flash_reference"] and torch.equal(again, out)
    # 511 tokens stay with the whole-sequence pair
    calls.clear()
    tattn.mha_from_qkv(torch.from_numpy(x[:, :511]), heads)
    assert calls and calls[0] == "_mha_reference" and "_flash_reference" not in calls


def test_fused_attention_dispatch_by_length():
    """Below 512 keys the plain softmax product, from 512 keys the tiled pair."""
    short = [torch.from_numpy(x).requires_grad_() for x in _qkv(1, 1, 1, 40, 16)]
    out = tattn.fused_attention(*short)
    assert not isinstance(out.grad_fn, tattn._FusedAttention._backward_cls)
    assert torch.equal(out, tattn.attention_reference(*short))
    long = [torch.from_numpy(x).requires_grad_() for x in _qkv(2, 1, 1, 512, 16)]
    out = tattn.fused_attention(*long)
    assert isinstance(out.grad_fn, tattn._FusedAttention._backward_cls)
    np.testing.assert_allclose(out.detach().numpy(),
                               tattn.attention_reference(*long).detach().numpy(), **TOL)


@pytest.mark.parametrize("case", ["block_len", "kv_lengths_grad", "head_dim", "dtype"])
def test_flash_path_rejects_what_it_does_not_take(case):
    if case == "block_len":
        with pytest.raises(ValueError, match="block_len"):
            tattn.mha_from_qkv(torch.zeros(1, 512, 3 * 32), 2, block_len=64)
        tattn.mha_from_qkv(torch.zeros(1, 512, 3 * 32), 2, block_len=512)  # one block: no mask
    elif case == "kv_lengths_grad":
        q, k, v = (torch.zeros(1, 1, 8, 16, requires_grad=True) for _ in range(3))
        with pytest.raises(ValueError, match="no backward"):
            tattn.fused_attention(q, k, v, kv_lengths=torch.tensor([4]))
        with torch.no_grad():
            tattn.fused_attention(q, k, v, kv_lengths=torch.tensor([4]))
    elif case == "head_dim":
        x = torch.zeros(1, 1, 8, 48, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="64"):
            tattn._check_flash_operands(x, q=x)
    else:
        x = torch.zeros(1, 1, 8, 64)
        with pytest.raises(ValueError, match="bf16"):
            tattn._check_flash_operands(x, q=x)


def test_heads_are_views_of_the_fused_projection():
    """q, k, v reach the kernels as strided views: same storage, rows of hd
    contiguous values, k and v starting D and 2D elements into a qkv row."""
    b, n, h, hd = 2, 5, 3, 64
    qkv = torch.arange(b * n * 3 * h * hd, dtype=torch.float32).reshape(b, n, 3 * h * hd)
    q, k, v = tattn._heads(qkv, h, 3)
    for i, x in enumerate((q, k, v)):
        assert x.shape == (b, h, n, hd) and x.stride() == (n * 3 * h * hd, hd, 3 * h * hd, 1)
        assert x.data_ptr() == qkv.data_ptr() + 4 * i * h * hd
    assert torch.equal(k[1, 2, 4], qkv[1, 4, h * hd + 2 * hd:h * hd + 3 * hd])
    strides = tattn._strides(q, k)
    assert list(strides) == 2 * [n * 3 * h * hd, hd, 3 * h * hd]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,strided", [(4, 6, 785, True), (2, 2, 1024, False),
                                           (2, 2, 512, True), (1, 2, 513, False)])
def test_flash_kernels_match_plain_on_card(b, h, s, strided):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = h * 64
    if strided:
        qkv = torch.randn((b, s, 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.randn((b, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        results = []
        for plain in (False, True):
            x = qkv.clone().requires_grad_()
            before = dict(tattn.LAUNCHES)
            out = tattn.mha_from_qkv(x, h, plain=plain)
            out.backward(g)
            torch.cuda.synchronize()
            for name in ("flash_fwd_stats", "flash_bwd_dq", "flash_bwd_dkv"):
                assert tattn.LAUNCHES[name] == before[name] + (0 if plain else 1)
            results.append((out.detach().float(), x.grad.float()))
    else:
        q, k, v, g = (torch.randn((b, h, s, 64), generator=gen, device="cuda").to(torch.bfloat16)
                      for _ in range(4))
        results = []
        for plain in (False, True):
            xs = [t.clone().requires_grad_() for t in (q, k, v)]
            out = tattn.fused_attention(*xs, plain=plain)
            out.backward(g)
            torch.cuda.synchronize()
            results.append((out.detach().float(), *(t.grad.float() for t in xs)))
    for got, want in zip(*results):
        diff = (got - want).abs()
        # one bf16 ulp where a rounding of p, dS or o falls the other way
        assert torch.isfinite(got).all()
        assert diff.max().item() <= 2e-2 and diff.mean().item() <= 1e-5


@pytest.mark.cuda
def test_flash_forward_kv_lengths_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths = torch.tensor([512, 300, 37, 1, 0], dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn((5, 6, 512, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = tattn.LAUNCHES["flash_fwd"]
    out = tattn.fused_attention(q, k, v, kv_lengths=lengths)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["flash_fwd"] == before + 1
    want, _ = tattn._flash_reference(q, k, v, lengths)
    diff = (out.float() - want.float()).abs()
    assert diff.max().item() <= 2e-2 and diff.mean().item() <= 1e-5
    assert not out[4].any()
    _, lse = tattn._launch_flash_fwd(q, k, v, lengths, 0.125, True)
    assert not lse[4].any() and torch.isfinite(lse).all()


@pytest.mark.parametrize("sq,sk", [(70, 130), (130, 70)])
def test_flash_forward_with_unequal_lengths_matches_pallas(sq, sk):
    """Sq != Sk both ways: the plain forward and fused_attention(force_kernel=True)
    (the plain pair on a CPU tensor) against the Pallas forward in interpret mode."""
    rng = np.random.default_rng(sq * 1000 + sk)
    q = rng.standard_normal((2, 2, sq, 32), dtype=np.float32)
    k, v = (rng.standard_normal((2, 2, sk, 32), dtype=np.float32) for _ in range(2))
    ref_o, ref_lse = jattn._flash_forward(*map(jnp.asarray, (q, k, v)), None, 32 ** -0.5, TILE,
                                          TILE, True, return_stats=True)
    ref_o = np.asarray(ref_o)
    ref_lse = np.asarray(ref_lse).reshape(2, 2, -1)[..., :sq]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = tattn._flash_reference(tq, tk, tv)
    assert o.shape == (2, 2, sq, 32) and lse.shape == (2, 2, sq)
    np.testing.assert_allclose(o.numpy(), ref_o, **TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **TOL)
    before = dict(tattn.LAUNCHES)
    out = tattn.fused_attention(tq, tk, tv, force_kernel=True)
    assert tattn.LAUNCHES == before
    np.testing.assert_allclose(out.numpy(), ref_o, **TOL)


# the forward pair's bounds on the card (chip_smoke.py's FLASH_* bounds): one
# bf16 ulp of o where a rounding of p falls the other way; lse is fp32
CARD_MAX_ABS, CARD_MEAN_ABS, CARD_LSE_MAX_ABS = 2e-2, 1e-5, 1e-4


def _card_forward_pair(q, k, v, lengths=None, scale=0.125):
    """K4a' and K4a on the card against the plain forward; K4a' twice gives
    the same bits, and K4a the same o."""
    want_o, want_lse = tattn._flash_reference(q, k, v, lengths, scale)
    o, lse = tattn._launch_flash_fwd(q, k, v, lengths, scale, True)
    o2, lse2 = tattn._launch_flash_fwd(q, k, v, lengths, scale, True)
    o_only, _ = tattn._launch_flash_fwd(q, k, v, lengths, scale, False)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(o, o_only)
    diff = (o.float() - want_o.float()).abs()
    assert torch.isfinite(o.float()).all()
    assert diff.max().item() <= CARD_MAX_ABS and diff.mean().item() <= CARD_MEAN_ABS
    assert (lse - want_lse).abs().max().item() <= CARD_LSE_MAX_ABS
    return o, lse


def _card_backward_pair(q, k, v, do, o, lse, scale=0.125):
    """K4b and K4b' on the card against the plain backward, fed the forward
    kernel's o and lse: two launches give the same bits of dq, dk and dv."""
    delta = tattn._flash_delta(o, do)
    want = tattn._flash_bwd_reference(q, k, v, do, lse, delta, scale)
    got = tattn._launch_flash_bwd(q, k, v, do, lse, delta, scale)
    again = tattn._launch_flash_bwd(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for x, w in zip(got, want):
        assert torch.isfinite(x.float()).all()
        diff = (x.float() - w.float()).abs()
        assert diff.max().item() <= CARD_MAX_ABS and diff.mean().item() <= CARD_MEAN_ABS


def _card_operands(seed, b, h, sq, sk):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((b, h, sq, 64), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((b, h, sk, 64), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,sk", [(4, 6, 100, 1000), (4, 6, 900, 200)])
def test_flash_forward_unequal_lengths_on_card(b, h, sq, sk):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(sq + sk)
    q = torch.randn((b, h, sq, 64), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, h, sk, 64), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    _card_forward_pair(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,sk", [(4, 6, 100, 1000), (4, 6, 900, 200)])
def test_flash_backward_unequal_lengths_on_card(b, h, sq, sk):
    """Sq != Sk both ways: dQ's key tiles and dK/dV's query stages end apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, do = _card_operands(sq + sk + 1, b, h, sq, sk)
    _card_backward_pair(q, k, v, do, *_card_forward_pair(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129, 191, 192, 193, 785])
def test_flash_backward_same_bits_at_item_edges_on_card(s):
    """Lengths on either side of a 64-row stage, a 128-key dK/dV item and a
    192-row dQ item: right, and the same bits from two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, do = _card_operands(s, 2, 6, s, s)
    _card_backward_pair(q, k, v, do, *_card_forward_pair(q, k, v))


@pytest.mark.cuda
def test_flash_backward_negative_scale_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, do = _card_operands(301, 2, 6, 300, 300)
    _card_backward_pair(q, k, v, do, *_card_forward_pair(q, k, v, scale=-0.125), scale=-0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 37, 197])
def test_fused_attention_short_sequences_take_the_kernel_on_card(s):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(s)
    q, k, v = (torch.randn((4, 6, s, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o, _ = _card_forward_pair(q, k, v)
    before = tattn.LAUNCHES["flash_fwd"]
    out = tattn.fused_attention(q, k, v, force_kernel=True)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["flash_fwd"] == before + 1 and torch.equal(out, o)


@pytest.mark.cuda
def test_flash_forward_lengths_at_tile_edges_on_card():
    """A key length on either side of the first two 64-key tile edges and the
    full length, at 785 tokens, through the public function too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    lens = [63, 64, 65, 127, 128, 129, 785]
    gen = torch.Generator(device="cuda").manual_seed(785)
    q, k, v = (torch.randn((len(lens), 6, 785, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    o, _ = _card_forward_pair(q, k, v, lengths)
    out = tattn.fused_attention(q, k, v, kv_lengths=lengths)
    torch.cuda.synchronize()
    assert torch.equal(out, o)


@pytest.mark.cuda
def test_flash_forward_negative_scale_on_card():
    """The kernel's other sign: q negated in the product, |scale| in the softmax."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(300)
    q, k, v = (torch.randn((2, 6, 300, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    _card_forward_pair(q, k, v, scale=-0.125)


def test_library_is_keyed_by_its_tree_and_shared_headers(tmp_path, monkeypatch):
    """The library's name is a hash of the kernel tree: a copy of the tree
    keys the same library, and a change to a shared header alone gives
    another (flash_fwd.cu and mha_qkv_fwd.cu both include hopper.cuh)."""
    from tpuwsi_torch.ops import _build

    want = _build.library_path()
    tree = tmp_path / "csrc"
    tree.mkdir()
    for src in [*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")]:
        (tree / src.name).write_bytes(src.read_bytes())
    assert (tree / "hopper.cuh").exists()
    monkeypatch.setattr(_build, "CSRC", tree)
    assert _build.library_path() == want
    (tree / "hopper.cuh").write_text((tree / "hopper.cuh").read_text() + "\n")
    assert _build.library_path() != want
    assert _build.library_path().parent == _build.BUILD_DIR
