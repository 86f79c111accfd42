"""The attention sub-block kernels against their plain PyTorch versions on the
card.

Marked ``cuda``: each case skips where there is no NVIDIA GPU. This file
imports nothing of the JAX package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_attn_block_card.py -q -m cuda
"""

import pytest
import torch

from tpuwsi_torch.ops import attention as tattn

# y and dx: one bf16 ulp of a value below 4 where a rounding of LN(x), qkv, p,
# o, do or dS falls the other way; the parameter gradients are fp32 sums over
# the rows of bf16 operands that differ by such ulps
CARD_MAX_ABS = 3e-2

# (B, N, D): the step's global views and local views at ViT-S, ViT-B at 224
# and 256 px, and 65,536 images of 16 tokens (past the old 65,535 cap)
SHAPES = [(5, 197, 384), (7, 37, 384), (4, 197, 768), (3, 257, 768), (65536, 16, 384)]
IDS = ["197", "37", "vit-b-197", "vit-b-257", "65536-images"]


def _operands(b, n, d=384):
    gen = torch.Generator(device="cuda").manual_seed(b * 1000 + n + d)

    def randn(shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device="cuda")).bfloat16()

    g = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    be = 0.1 * torch.randn(d, generator=gen, device="cuda")
    return (randn((b, n, d)), randn((b, n, d)), g, be, randn((d, 3 * d), d ** -0.5),
            randn((3 * d,), 0.1), randn((d, d), d ** -0.5), randn((d,), 0.1))


def _close(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.isfinite(a.float()).all()
        scale = max(1.0, b.float().abs().max().item() / 4)
        assert (a.float() - b.float()).abs().max().item() <= CARD_MAX_ABS * scale


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", SHAPES, ids=IDS)
def test_forward_kernel_matches_plain_version_on_the_card(b, n, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, _, g, be, wqkv, bqkv, wp, bp = _operands(b, n, d)
    heads, scale = d // tattn.KERNEL_HEAD_DIM, tattn.KERNEL_HEAD_DIM ** -0.5
    before = dict(tattn.LAUNCHES)
    got = tattn._launch_attn_block_fwd(x, g, be, wqkv, bqkv, wp, bp, heads, scale, 1e-6)
    want = tattn._attn_block_fwd_reference(x, g, be, wqkv, bqkv, wp, bp, heads, scale, 1e-6)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == {**before, "attn_block_fwd": before["attn_block_fwd"] + 1}
    _close((got,), (want,))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", SHAPES, ids=IDS)
def test_backward_kernel_matches_plain_version_and_repeats_its_bits(b, n, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, dy, g, be, wqkv, bqkv, wp, _ = _operands(b, n, d)
    heads, scale = d // tattn.KERNEL_HEAD_DIM, tattn.KERNEL_HEAD_DIM ** -0.5
    before = dict(tattn.LAUNCHES)
    got = tattn._launch_attn_block_bwd(x, dy, g, be, wqkv, bqkv, wp, heads, scale, 1e-6)
    again = tattn._launch_attn_block_bwd(x, dy, g, be, wqkv, bqkv, wp, heads, scale, 1e-6)
    want = tattn._attn_block_bwd_reference(x, dy, g, be, wqkv, bqkv, wp, heads, scale, 1e-6)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == {**before, "attn_block_bwd": before["attn_block_bwd"] + 2}
    assert len(got) == 7
    _close(got, want)
    for a, c in zip(got, again):
        assert torch.equal(a, c)  # a fixed order of sums: the same bits twice


@pytest.mark.cuda
def test_op_on_the_card_never_gives_way_to_the_plain_version(monkeypatch):
    """On a CUDA tensor the op launches its two kernels (one count each) and
    raises for what they do not take; the plain versions are not called."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")

    def fail(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(tattn, "_attn_block_fwd_reference", fail)
    monkeypatch.setattr(tattn, "_attn_block_bwd_reference", fail)
    x, dy, g, be, wqkv, bqkv, wp, bp = _operands(3, 50)
    params = [p.float().requires_grad_() for p in (g, be, wqkv, bqkv, wp, bp)]
    before = dict(tattn.LAUNCHES)
    y = tattn.fused_attention_block(x.requires_grad_(), *params, 6)
    y.backward(dy)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == {**before, "attn_block_fwd": before["attn_block_fwd"] + 1,
                              "attn_block_bwd": before["attn_block_bwd"] + 1}
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in params)
    with pytest.raises(ValueError, match="bf16"):
        tattn.fused_attention_block(x.detach().float(), *params, 6)
    with pytest.raises(ValueError, match="at most"):
        long = torch.zeros(1, tattn.ATTN_BLOCK_MAX_SEQ[384] + 1, x.shape[-1], device="cuda",
                           dtype=torch.bfloat16)
        tattn.fused_attention_block(long, *params, 6)
