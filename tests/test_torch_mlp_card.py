"""The fused-MLP, LN+GEMM, GEMM+residual and hybrid-dense kernels against their
plain PyTorch versions on the card.

Marked ``cuda``: each case skips where there is no NVIDIA GPU. This file
imports nothing of the JAX package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_mlp_card.py -q -m cuda
"""

import pytest
import torch

from tpuwsi_torch.ops import dense as tdense, mlp as tmlp

CARD_SHAPES = [(300, 384, 1536), (77, 768, 3072)]
# outputs and dx: one bf16 ulp of a value below 4 where a rounding of h, du or
# LN(x) falls the other way; weight gradients are fp32 sums over the rows of
# bf16 operands that differ by such ulps
CARD_MAX_ABS = 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=["vit_s", "vit_b"])
@pytest.mark.parametrize("kernel", list(tmlp.LAUNCHES))
def test_kernel_matches_plain_version_on_the_card(kernel, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rows, d, f = shape
    gen = torch.Generator(device="cuda").manual_seed(rows)

    def randn(shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device="cuda")).bfloat16()

    x, dy = randn((rows, d)), randn((rows, d))
    g = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    be = 0.1 * torch.randn(d, generator=gen, device="cuda")
    w1, b1 = randn((d, f), d ** -0.5), randn((f,), 0.1)
    w2, b2 = randn((f, d), f ** -0.5), randn((d,), 0.1)
    dy_f, wp = randn((rows, f)), randn((d, d), d ** -0.5)  # the LN+GEMM's cotangent; a proj layer
    before = tmlp.LAUNCHES[kernel]
    got, want = {
        "mlp_fwd": lambda: (tmlp._launch_mlp_fwd(x, w1, b1, w2, b2, True),
                            tmlp._mlp_fwd_reference(x, w1, b1, w2, b2, True)),
        "mlp_bwd": lambda: (tmlp._launch_mlp_bwd(x, dy, w1, b1, w2, True),
                            tmlp._mlp_bwd_reference(x, dy, w1, b1, w2, True)),
        "mlp_block_fwd": lambda: (
            tmlp._launch_mlp_block_fwd(x, g, be, w1, b1, w2, b2, False, 1e-6),
            tmlp._mlp_block_fwd_reference(x, g, be, w1, b1, w2, b2, False, 1e-6)),
        "mlp_block_bwd": lambda: (
            tmlp._launch_mlp_block_bwd(x, dy, g, be, w1, b1, w2, False, 1e-6),
            tmlp._mlp_block_bwd_reference(x, dy, g, be, w1, b1, w2, False, 1e-6)),
        "ln_gemm_fwd": lambda: (tmlp._launch_ln_gemm_fwd(x, g, be, w1, b1, 1e-6),
                                tmlp._ln_gemm_fwd_reference(x, g, be, w1, b1, 1e-6)),
        "ln_gemm_bwd": lambda: (tmlp._launch_ln_gemm_bwd(x, dy_f, g, be, w1, 1e-6),
                                tmlp._ln_gemm_bwd_reference(x, dy_f, g, be, w1, 1e-6)),
        "gemm_res_fwd": lambda: (tmlp._launch_gemm_res_fwd(dy, x, wp, b2),
                                 tmlp._gemm_res_fwd_reference(dy, x, wp, b2)),
        "gemm_res_bwd": lambda: (tmlp._launch_gemm_res_bwd(x, dy, wp),
                                 tmlp._gemm_res_bwd_reference(x, dy, wp)),
    }[kernel]()
    torch.cuda.synchronize()
    assert tmlp.LAUNCHES[kernel] == before + 1
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.isfinite(a.float()).all()
        scale = max(1.0, b.float().abs().max().item() / 4)
        assert (a.float() - b.float()).abs().max().item() <= CARD_MAX_ABS * scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 384, 1152), (300, 384, 384), (77, 768, 2304)],
                         ids=["vit_s_qkv", "vit_s_proj", "vit_b_qkv"])
def test_dense_bwd_matches_plain_version_on_the_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rows, d, n = shape
    gen = torch.Generator(device="cuda").manual_seed(rows)
    x, dy, w = ((std * torch.randn(s, generator=gen, device="cuda")).bfloat16()
                for s, std in (((rows, d), 1.0), ((rows, n), 1.0), ((d, n), d ** -0.5)))
    before = tdense.LAUNCHES["dense_bwd"]
    got, want = tdense._launch_dense_bwd(x, dy, w), tdense._dense_bwd_reference(x, dy, w)
    again = tdense._launch_dense_bwd(x, dy, w)
    torch.cuda.synchronize()
    assert tdense.LAUNCHES["dense_bwd"] == before + 2
    for a, b, c in zip(got, want, again):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.isfinite(a.float()).all()
        scale = max(1.0, b.float().abs().max().item() / 4)
        assert (a.float() - b.float()).abs().max().item() <= CARD_MAX_ABS * scale
        assert torch.equal(a, c)  # a fixed order of sums: the same bits twice


# K7, K9c and K9d at the row counts where the tiles and clusters of four
# tiles of csrc/dense_sm90.cu end (one row, less than a tile, either side of
# one tile, two tiles and a row, four tiles and a row) and at the step's
# global views
DENSE_EDGE_ROWS = [1, 7, 63, 64, 65, 129, 257, 37824]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kn", "nk"], ids=["w_kn", "w_nk"])
@pytest.mark.parametrize("rows", DENSE_EDGE_ROWS)
def test_dense_bwd_at_edge_rows_on_the_card(rows, layout):
    """K7 at width 384 with the qkv and proj layers' output widths, the weight
    stored (K, N) or as nn.Linear keeps it (N, K) and passed as its transposed
    view, against the plain version; launched twice, the same bits, and dW,
    db the same bits in both layouts (they do not read W)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(rows)
    k = 384
    for n in (3 * k, k):
        x, dy, w = ((std * torch.randn(s, generator=gen, device="cuda")).bfloat16()
                    for s, std in (((rows, k), 1.0), ((rows, n), 1.0), ((k, n), k ** -0.5)))
        w_in = w if layout == "kn" else w.t().contiguous().t()
        before = tdense.LAUNCHES["dense_bwd"]
        got, again = tdense._launch_dense_bwd(x, dy, w_in), tdense._launch_dense_bwd(x, dy, w_in)
        other = tdense._launch_dense_bwd(x, dy, w)
        want = tdense._dense_bwd_reference(x, dy, w)
        torch.cuda.synchronize()
        assert tdense.LAUNCHES["dense_bwd"] == before + 3
        for a, b, c in zip(got, want, again):
            assert a.shape == b.shape and a.dtype == b.dtype and torch.isfinite(a.float()).all()
            scale = max(1.0, b.float().abs().max().item() / 4)
            assert (a.float() - b.float()).abs().max().item() <= CARD_MAX_ABS * scale
            assert torch.equal(a, c)
        assert all(torch.equal(a, c) for a, c in zip(got[1:], other[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", DENSE_EDGE_ROWS)
def test_gemm_residual_at_edge_rows_on_the_card(rows):
    """K9c with output width 384 from both input widths, K9d with input width
    384 to both output widths, against their plain versions; K9d launched
    twice, the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(rows + 1)

    def randn(shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device="cuda")).bfloat16()

    d = 384
    for f in (384, 768):
        res, a, w, b = randn((rows, d)), randn((rows, f)), randn((f, d), f ** -0.5), randn((d,), 0.1)
        x, dy, wd = randn((rows, d)), randn((rows, f)), randn((d, f), d ** -0.5)
        pairs = [(tmlp._launch_gemm_res_fwd(res, a, w, b),
                  tmlp._gemm_res_fwd_reference(res, a, w, b))]
        got, again = tmlp._launch_gemm_res_bwd(x, dy, wd), tmlp._launch_gemm_res_bwd(x, dy, wd)
        pairs += list(zip(got, tmlp._gemm_res_bwd_reference(x, dy, wd)))
        torch.cuda.synchronize()
        for a_, b_ in pairs:
            assert a_.shape == b_.shape and a_.dtype == b_.dtype
            assert torch.isfinite(a_.float()).all()
            scale = max(1.0, b_.float().abs().max().item() / 4)
            assert (a_.float() - b_.float()).abs().max().item() <= CARD_MAX_ABS * scale
        assert all(torch.equal(a_, c) for a_, c in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kn", "nk"], ids=["w_kn", "w_nk"])
@pytest.mark.parametrize("rows", DENSE_EDGE_ROWS)
def test_ln_gemm_at_edge_rows_on_the_card(rows, layout):
    """K9a and K9b at width 384 (csrc/ln_gemm_sm90.cu) with the qkv and proj
    layers' output widths, the weight stored (K, N) or as nn.Linear keeps it
    (N, K) and read in place, against their plain versions; K9b launched
    twice, the same bits, and both kernels the same bits in both layouts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(rows + 2)

    def randn(shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device="cuda")).bfloat16()

    k = 384
    g = 1.0 + 0.1 * torch.randn(k, generator=gen, device="cuda")
    be = 0.1 * torch.randn(k, generator=gen, device="cuda")
    for n in (3 * k, k):
        x, dy, w, b = randn((rows, k)), randn((rows, n)), randn((k, n), k ** -0.5), randn((n,), 0.1)
        w_in, w_layout = (w, 0) if layout == "kn" else (w.t().contiguous(), 1)
        before = (tmlp.LAUNCHES["ln_gemm_fwd"], tmlp.LAUNCHES["ln_gemm_bwd"])
        y = tmlp._launch_ln_gemm_fwd(x, g, be, w_in, b, 1e-6, w_layout)
        got = tmlp._launch_ln_gemm_bwd(x, dy, g, be, w_in, 1e-6, w_layout)
        again = tmlp._launch_ln_gemm_bwd(x, dy, g, be, w_in, 1e-6, w_layout)
        other = (tmlp._launch_ln_gemm_fwd(x, g, be, w, b, 1e-6),
                 *tmlp._launch_ln_gemm_bwd(x, dy, g, be, w, 1e-6))
        pairs = [(y, tmlp._ln_gemm_fwd_reference(x, g, be, w, b, 1e-6))]
        pairs += list(zip(got, tmlp._ln_gemm_bwd_reference(x, dy, g, be, w, 1e-6)))
        torch.cuda.synchronize()
        assert (tmlp.LAUNCHES["ln_gemm_fwd"], tmlp.LAUNCHES["ln_gemm_bwd"]) == (
            before[0] + 2, before[1] + 3)
        for a, c in pairs:
            assert a.shape == c.shape and a.dtype == c.dtype and torch.isfinite(a.float()).all()
            scale = max(1.0, c.float().abs().max().item() / 4)
            assert (a.float() - c.float()).abs().max().item() <= CARD_MAX_ABS * scale
        assert all(torch.equal(a, c) for a, c in zip(got, again))
        assert all(torch.equal(a, c) for a, c in zip((y, *got), other))


# The four fused-MLP kernels at the row counts where their tiles and clusters
# end: one row, either side of one and two 64-row tiles, a partial cluster
# (five tiles and a row: the second cluster of four holds two tiles, one of a
# single row), and the student's local views; D = 384 takes the Hopper
# kernels of csrc/mlp_sm90.cu, D = 768 the row-tiled ones of mlp_fwd.cu /
# mlp_bwd.cu
EDGE_ROWS = [1, 63, 64, 65, 127, 128, 129, 5 * 64 + 1, 21312]


@pytest.mark.cuda
@pytest.mark.parametrize("approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("d", [384, 768], ids=["vit_s", "vit_b"])
@pytest.mark.parametrize("rows", EDGE_ROWS)
def test_mlp_kernels_at_edge_rows_on_the_card(rows, d, approx):
    """K5f, K5b, K6f and K6b against their plain versions; each backward
    launched twice on the same inputs gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    f = 4 * d
    gen = torch.Generator(device="cuda").manual_seed(rows + d)

    def randn(shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device="cuda")).bfloat16()

    x, dy = randn((rows, d)), randn((rows, d))
    g = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    be = 0.1 * torch.randn(d, generator=gen, device="cuda")
    w1, b1 = randn((d, f), d ** -0.5), randn((f,), 0.1)
    w2, b2 = randn((f, d), f ** -0.5), randn((d,), 0.1)
    before = dict(tmlp.LAUNCHES)
    y = tmlp._launch_mlp_fwd(x, w1, b1, w2, b2, approx)
    got = tmlp._launch_mlp_bwd(x, dy, w1, b1, w2, approx)
    again = tmlp._launch_mlp_bwd(x, dy, w1, b1, w2, approx)
    y_block = tmlp._launch_mlp_block_fwd(x, g, be, w1, b1, w2, b2, approx, 1e-6)
    got_block = tmlp._launch_mlp_block_bwd(x, dy, g, be, w1, b1, w2, approx, 1e-6)
    again_block = tmlp._launch_mlp_block_bwd(x, dy, g, be, w1, b1, w2, approx, 1e-6)
    torch.cuda.synchronize()
    assert {name: tmlp.LAUNCHES[name] - before[name] for name in
            ("mlp_fwd", "mlp_bwd", "mlp_block_fwd", "mlp_block_bwd")} == {
        "mlp_fwd": 1, "mlp_bwd": 2, "mlp_block_fwd": 1, "mlp_block_bwd": 2}
    pairs = [(y, tmlp._mlp_fwd_reference(x, w1, b1, w2, b2, approx)),
             (y_block, tmlp._mlp_block_fwd_reference(x, g, be, w1, b1, w2, b2, approx, 1e-6))]
    pairs += list(zip(got, tmlp._mlp_bwd_reference(x, dy, w1, b1, w2, approx)))
    pairs += list(zip(got_block,
                      tmlp._mlp_block_bwd_reference(x, dy, g, be, w1, b1, w2, approx, 1e-6)))
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype and torch.isfinite(a.float()).all()
        scale = max(1.0, b.float().abs().max().item() / 4)
        assert (a.float() - b.float()).abs().max().item() <= CARD_MAX_ABS * scale
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert all(torch.equal(a, c) for a, c in zip(got_block, again_block))
