"""The transformer MLP with its hidden activation kept on chip, forward and
backward, and the row-tiled LN+GEMM and GEMM+residual ops.

Counterpart of ``tpuwsi/ops/mlp.py``. Five public functions, weights in the
JAX layout ``w1 (D, F)``, ``w2 (F, D)``, ``x`` ``(..., D)``:

- ``fused_mlp``: ``gelu(x @ w1 + b1) @ w2 + b2``, kernel forward and backward;
- ``hybrid_mlp``: the same function with an ordinary PyTorch forward that
  saves only ``x, w1, b1, w2``, and the kernel backward;
- ``fused_mlp_block``: the pre-norm sub-block
  ``x + gelu(LN(x) @ w1 + b1) @ w2 + b2`` as one op, forward and backward;
- ``fused_ln_gemm``: ``LN(x) @ w + b`` (the pre-norm qkv projection), the
  LayerNorm inside the GEMM's row tiles, forward and backward;
- ``fused_gemm_residual``: ``res + a @ w + b`` (the output projection with its
  residual sum), forward and backward. No model calls these two, as none does
  in the reference; they are ops of the library.

Eight hand-written Hopper kernels carry them on a CUDA tensor, each with its
plain PyTorch version beside it, which runs on a CPU tensor and repeats the
kernel's arithmetic and roundings (fp32 accumulation; ``h``, ``du``, ``dy``
and ``LN(x)`` rounded to ``x.dtype`` as GEMM operands; LayerNorm in fp32 with
the fast variance ``E[x^2] - mean^2`` clamped at 0; ``a @ w + b`` rounded to
``res.dtype`` before the residual is added):

=================  ==========================  ============================
kernel             replaces (tpuwsi/ops/mlp.py)  plain version
=================  ==========================  ============================
``mlp_fwd``          ``_mlp_fwd_kernel``           ``_mlp_fwd_reference``
``mlp_bwd``          ``_mlp_bwd_kernel``           ``_mlp_bwd_reference``
``mlp_block_fwd``    ``_mlp_block_fwd_kernel``     ``_mlp_block_fwd_reference``
``mlp_block_bwd``    ``_mlp_block_bwd_kernel``     ``_mlp_block_bwd_reference``
``ln_gemm_fwd``      ``_ln_gemm_fwd_kernel``       ``_ln_gemm_fwd_reference``
``ln_gemm_bwd``      ``_ln_gemm_bwd_kernel``       ``_ln_gemm_bwd_reference``
``gemm_res_fwd``     ``_gemm_res_fwd_kernel``      ``_gemm_res_fwd_reference``
``gemm_res_bwd``     ``_gemm_res_bwd_kernel``      ``_gemm_res_bwd_reference``
=================  ==========================  ============================

On a CUDA tensor a wrapper launches its kernel or raises; it never gives way
to the plain version. The kernels take bf16 and an embedding width of 384 or
768; the MLP's hidden width and the LN+GEMM's output width are multiples of
64, both widths of the GEMM+residual are 384 or 768; both GELU forms run
in-kernel. The backward kernels sum the weight gradients in a fixed order: the
same inputs give the same bits on every run. At width 384 the four MLP
kernels are ``csrc/mlp_sm90.cu`` (clusters of four blocks sharing the weight
stream; the sub-block's LayerNorm inside the row tile; the backward's row
groups from ``mlp_dw_groups``), the GEMM+residual's are
``csrc/dense_sm90.cu`` (the forward where the output width is 384, the
backward where the input width is 384: the hybrid dense layer's kernels), and
the LN+GEMM's ``csrc/ln_gemm_sm90.cu``, which reads the weight as it is
stored: ``fused_ln_gemm`` hands it nn.Linear's ``weight.t()`` as that
weight's own (F, D) storage, no copy. At 768 they are the row-tiled kernels of
``csrc/mlp_fwd.cu``, ``csrc/mlp_bwd.cu`` and ``csrc/dense.cu``, which read W
only as (D, F): a transposed view is copied there.

As in the reference, the public functions cast the parameters to ``x.dtype``
outside the differentiated op and the op returns weight and bias gradients in
that dtype: with bf16 compute the gradients of ``w1, b1, w2, b2, w, b`` are
rounded to bf16 on their way to the fp32 parameters, while the LayerNorm
gradients stay fp32.

``LAUNCHES`` counts each kernel's launches by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL_WIDTHS = (384, 768)   # embedding widths the kernels are built for
LINEAR_LAYOUT_WIDTHS = (384,)  # input widths whose dense kernels read nn.Linear's (N, D) weight
KERNEL_HIDDEN_MULTIPLE = 64
DW_WAVES = 4                 # weight-gradient blocks per SM that the row groups aim at
# The weight-gradient passes of the D = 384 backward (csrc/mlp_sm90.cu): clusters
# of this many blocks take neighbouring 64-unit hidden slices of one row group,
# which they walk in stages of this many rows
MLP_DW_CLUSTER, MLP_DW_SLICE, MLP_DW_STAGE_ROWS = 4, 64, 32
# the same for one dense layer's weight gradient: its partials are written and
# summed again, (K N + N) fp32 per row group, and with nothing to rebuild per
# row the blocks are short, so fewer, longer row groups win (on an H100 at
# 37,824 rows 1 and 2 read level, 4 reads 10-15% slower)
DENSE_DW_WAVES = 2

_C = 0.7978845608028654  # sqrt(2 / pi)
_A = 0.044715
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327

LAUNCHES = {"mlp_fwd": 0, "mlp_bwd": 0, "mlp_block_fwd": 0, "mlp_block_bwd": 0,
            "ln_gemm_fwd": 0, "ln_gemm_bwd": 0, "gemm_res_fwd": 0, "gemm_res_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _gelu(u, approx: bool):
    if approx:
        return 0.5 * u * (1.0 + torch.tanh(_C * (u + _A * u * u * u)))
    return u * 0.5 * (1.0 + torch.erf(u * _INV_SQRT2))


def _gelu_and_grad(u, approx: bool):
    """``(gelu(u), gelu'(u))`` in closed form."""
    if approx:
        t = torch.tanh(_C * (u + _A * u * u * u))
        dg = 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * _C * (1.0 + 3.0 * _A * u * u)
        return 0.5 * u * (1.0 + t), dg
    phi = 0.5 * (1.0 + torch.erf(u * _INV_SQRT2))
    pdf = torch.exp(-0.5 * u * u) * _INV_SQRT2PI
    return u * phi, phi + u * pdf


def _ln_fwd(xf, g, be, eps: float):
    """flax ``nn.LayerNorm`` in fp32 (fast variance) → ``(ln, xhat, inv)``."""
    mu = xf.mean(dim=1, keepdim=True)
    var = (xf * xf).mean(dim=1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var.clamp(min=0.0) + eps)
    xhat = (xf - mu) * inv
    return xhat * g + be, xhat, inv


def _ln_bwd(dln, gam, xhat, inv):
    """LayerNorm backward in fp32 from the gradient at its output → dx."""
    dxhat = dln * gam
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    return inv * (dxhat - m1 - xhat * m2)


def _mm(a, b):
    """A product of operands in the compute type, accumulated in fp32."""
    return a.float() @ b.float()


def _mlp_fwd_reference(x2, w1, b1, w2, b2, approx):
    """Plain version of the forward kernel. x2: (rows, D) → (rows, D)."""
    u = _mm(x2, w1) + b1.float()
    h = _gelu(u, approx).to(x2.dtype)
    return (_mm(h, w2) + b2.float()).to(x2.dtype)


def _mlp_grads(a, dy2, w1, b1, w2, approx):
    """The part the two backward kernels share, for fc1 input ``a``:
    → ``(da fp32, dw1, db1, dw2, db2)``."""
    dt = a.dtype
    dy = dy2.float()
    h, dgelu = _gelu_and_grad(_mm(a, w1) + b1.float(), approx)
    h, dy_c = h.to(dt), dy.to(dt)
    du = _mm(dy_c, w2.t()) * dgelu
    du_c = du.to(dt)
    return (_mm(du_c, w1.t()), _mm(a.t(), du_c), du.sum(dim=0), _mm(h.t(), dy_c),
            dy.sum(dim=0))


def _mlp_bwd_reference(x2, dy2, w1, b1, w2, approx):
    """Plain version of the backward kernel → ``(dx, dw1, db1, dw2, db2)``;
    dx in x2's dtype, the others fp32."""
    dx, *grads = _mlp_grads(x2, dy2, w1, b1, w2, approx)
    return (dx.to(x2.dtype), *grads)


def _mlp_block_fwd_reference(x2, g, be, w1, b1, w2, b2, approx, eps):
    """Plain version of the sub-block forward kernel: LayerNorm's output is
    rounded to x2's dtype before fc1, the residual sum is taken in x2's dtype."""
    ln, _, _ = _ln_fwd(x2.float(), g.float(), be.float(), eps)
    return x2 + _mlp_fwd_reference(ln.to(x2.dtype), w1, b1, w2, b2, approx)


def _mlp_block_bwd_reference(x2, dy2, g, be, w1, b1, w2, approx, eps):
    """Plain version of the sub-block backward kernel →
    ``(dx, dg, dbe, dw1, db1, dw2, db2)``; dx in x2's dtype, the others fp32."""
    gam = g.float()
    ln, xhat, inv = _ln_fwd(x2.float(), gam, be.float(), eps)
    dln, *grads = _mlp_grads(ln.to(x2.dtype), dy2, w1, b1, w2, approx)
    dx = dy2.float() + _ln_bwd(dln, gam, xhat, inv)
    return (dx.to(x2.dtype), (dln * xhat).sum(dim=0), dln.sum(dim=0), *grads)


def _dense_grads(a, dy2, w):
    """The part the three dense-layer backward kernels share: the gradients
    of ``a @ w + b`` at the cotangent ``dy2`` (in a's dtype), fp32:
    → ``(da, dw, db)``."""
    return _mm(dy2, w.t()), _mm(a.t(), dy2), dy2.float().sum(dim=0)


def _ln_gemm_fwd_reference(x2, g, be, w, b, eps):
    """Plain version of the LN+GEMM forward kernel: x2 (rows, D) → (rows, F);
    LayerNorm's output is rounded to x2's dtype before the product."""
    ln, _, _ = _ln_fwd(x2.float(), g.float(), be.float(), eps)
    return (_mm(ln.to(x2.dtype), w) + b.float()).to(x2.dtype)


def _ln_gemm_bwd_reference(x2, dy2, g, be, w, eps):
    """Plain version of the LN+GEMM backward kernel → ``(dx, dg, dbe, dw,
    db)``; dx in x2's dtype, the others fp32."""
    gam = g.float()
    ln, xhat, inv = _ln_fwd(x2.float(), gam, be.float(), eps)
    dln, dw, db = _dense_grads(ln.to(x2.dtype), dy2, w)
    dx = _ln_bwd(dln, gam, xhat, inv)
    return dx.to(x2.dtype), (dln * xhat).sum(dim=0), dln.sum(dim=0), dw, db


def _gemm_res_fwd_reference(res2, a2, w, b):
    """Plain version of the GEMM+residual forward kernel: the product with its
    bias is rounded to res2's dtype before the residual is added."""
    return res2 + (_mm(a2, w) + b.float()).to(res2.dtype)


def _gemm_res_bwd_reference(a2, dy2, w):
    """Plain version of the GEMM+residual backward kernel → ``(da, dw, db)``;
    da in a2's dtype, the others fp32. ``d(res) = dy`` needs no kernel."""
    da, dw, db = _dense_grads(a2, dy2, w)
    return da.to(a2.dtype), dw, db


def _use_plain(x: torch.Tensor) -> bool:
    """The plain version runs where the tensor lies on the CPU, and nowhere else."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the fused ops run on cuda or cpu, not {x.device}")
    return x.device.type == "cpu"


def _check_tensors(what, device, d, ln, shapes) -> None:
    """Raise unless every tensor of ``shapes`` (name → (tensor or None, shape))
    is bf16 of that shape, contiguous and 16-byte aligned on ``device``, and
    ``ln`` (gamma, beta or None) fp32 ``(d,)`` beside them."""
    for name, (t, shape) in shapes.items():
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.bfloat16 or t.device != device:
            raise ValueError(f"{what} kernels take bf16 on one CUDA device: {name} is "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernels take contiguous, 16-byte aligned tensors: "
                             f"{name} has strides {t.stride()}")
    for name, t in zip(("ln_scale", "ln_bias"), ln or ()):
        if (tuple(t.shape) != (d,) or t.dtype != torch.float32 or t.device != device
                or not t.is_contiguous() or t.data_ptr() % 8):
            raise ValueError(f"{what} kernels take fp32 ({d},) {name} beside x: got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_operands(x2, w1, b1, w2, b2=None, dy2=None, ln=None) -> None:
    """Raise unless the kernels take these operands as they are."""
    rows, d = x2.shape
    f = w1.shape[1]
    if d not in KERNEL_WIDTHS or f % KERNEL_HIDDEN_MULTIPLE or f < KERNEL_HIDDEN_MULTIPLE:
        raise ValueError(
            f"fused MLP kernels are built for embedding widths {KERNEL_WIDTHS} and a hidden "
            f"width that is a multiple of {KERNEL_HIDDEN_MULTIPLE}: got D = {d}, F = {f}")
    if rows < 1 or rows * max(d, f) >= 2 ** 31:
        raise ValueError(f"fused MLP kernels take 1 <= rows and rows * width < 2^31: {rows} rows")
    _check_tensors("fused MLP", x2.device, d, ln, {
        "x": (x2, (rows, d)), "w1": (w1, (d, f)), "b1": (b1, (f,)), "w2": (w2, (f, d)),
        "b2": (b2, (d,)), "dy": (dy2, (rows, d))})


def _check_dense_operands(what, a2, w, outs=None, *, b=None, dy2=None, res2=None,
                          ln=None, w_layout=0) -> None:
    """Raise unless the dense-layer kernels take these operands as they are:
    ``a2 (rows, K) @ W (K, N)`` with K in ``KERNEL_WIDTHS`` and N in ``outs``
    (None: any multiple of 64); ``w`` holds W as (K, N), or with ``w_layout``
    1 as nn.Linear's (N, K), which the kernels read at K in
    ``LINEAR_LAYOUT_WIDTHS`` only."""
    rows, k = a2.shape
    if w_layout and k not in LINEAR_LAYOUT_WIDTHS:
        raise ValueError(f"{what} kernels read an (N, D) weight at D in "
                         f"{LINEAR_LAYOUT_WIDTHS} only: got D = {k}")
    n = w.shape[0] if w_layout else w.shape[1]
    n_ok = n % KERNEL_HIDDEN_MULTIPLE == 0 and n > 0 if outs is None else n in outs
    if k not in KERNEL_WIDTHS or not n_ok:
        want = f"a multiple of {KERNEL_HIDDEN_MULTIPLE}" if outs is None else f"in {tuple(outs)}"
        raise ValueError(f"{what} kernels are built for input widths {KERNEL_WIDTHS} and an "
                         f"output width {want}: got {k} -> {n}")
    if rows < 1 or rows * max(k, n) >= 2 ** 31:
        raise ValueError(f"{what} kernels take 1 <= rows and rows * width < 2^31: {rows} rows")
    _check_tensors(what, a2.device, k, ln, {
        "the input": (a2, (rows, k)), "w": (w, (n, k) if w_layout else (k, n)), "b": (b, (n,)),
        "dy": (dy2, (rows, n)), "res": (res2, (rows, n))})


def _weight_operand(w):
    """What a dense-layer kernel reads for the (K, N) weight ``w`` →
    ``(tensor, w_layout)``: ``w`` itself where it is contiguous (0); where it
    is the transposed view of an (N, K) weight, as ``nn.Linear.weight.t()`` is,
    that weight's own storage (1) at the widths whose kernels read it;
    otherwise a (K, N) copy (0): the row-tiled kernels at K = 768 read W as
    (K, N) only."""
    if w.is_contiguous():
        return w, 0
    if w.shape[0] in LINEAR_LAYOUT_WIDTHS and w.t().is_contiguous():
        return w.t(), 1
    return w.contiguous(), 0


def _call(name: str, like: torch.Tensor, args, counts=LAUNCHES) -> None:
    from tpuwsi_torch.ops import _build

    _build.launch(name, like, args)
    counts[name] += 1


def _launch_mlp_fwd(x2, w1, b1, w2, b2, approx):
    _check_operands(x2, w1, b1, w2, b2)
    y = torch.empty_like(x2)
    _call("mlp_fwd", x2, (x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                          b2.data_ptr(), y.data_ptr(), *x2.shape, w1.shape[1], int(approx)))
    return y


def _launch_mlp_block_fwd(x2, g, be, w1, b1, w2, b2, approx, eps):
    _check_operands(x2, w1, b1, w2, b2, ln=(g, be))
    y = torch.empty_like(x2)
    _call("mlp_block_fwd", x2,
          (x2.data_ptr(), g.data_ptr(), be.data_ptr(), w1.data_ptr(), b1.data_ptr(),
           w2.data_ptr(), b2.data_ptr(), y.data_ptr(), *x2.shape, w1.shape[1], float(eps),
           int(approx)))
    return y


def mlp_dw_groups(rows: int, f: int, sms: int) -> int:
    """Row groups of the D = 384 backwards' weight-gradient passes (K5b and
    K6b alike, csrc/mlp_sm90.cu): as many as fill the card with one block per
    SM (each group takes ``ceil(F / 256)`` clusters of four slices), at least
    one, at most one per 32-row stage.
    A pure function of the shapes and the SM count, so the partial sums, and
    the order in which they are added, are the same on every run."""
    stages = -(-rows // MLP_DW_STAGE_ROWS)
    slices = f // MLP_DW_SLICE
    blocks_per_group = -(-slices // MLP_DW_CLUSTER) * MLP_DW_CLUSTER
    return max(1, min(stages, sms // blocks_per_group))


def _bwd_buffers(x2, f: int, row_sums: int):
    """Outputs and workspaces of a backward launch: dx, the fp32 gradients in
    one buffer ``dW1 | dW2 | db1 | db2 [| dgamma | dbeta]``, the per-row-group
    and per-row-tile partial sums, and the two counts. The number of row
    groups follows from the shapes and the card alone, so the order of every
    sum is the same on every run."""
    from tpuwsi_torch.ops import _build

    rows, d = x2.shape
    dev = x2.device
    lib = _build.load()
    n_tiles = -(-rows // lib.tpuwsi_mlp_rows_per_tile(d))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if d == 384:  # the Hopper kernels of K5b and K6b (csrc/mlp_sm90.cu)
        groups = mlp_dw_groups(rows, f, sms)
    else:  # the row-tiled kernels: their grid's other axis is F in slices
        slices = f // lib.tpuwsi_mlp_hidden_per_slice(d)
        groups = max(1, min(n_tiles, DW_WAVES * sms // slices))
    n_w = 2 * d * f + f
    grads = torch.empty(n_w + row_sums * d, dtype=torch.float32, device=dev)
    w_part = torch.empty((groups, n_w), dtype=torch.float32, device=dev)
    row_part = torch.empty((n_tiles, row_sums * d), dtype=torch.float32, device=dev)
    return torch.empty_like(x2), grads, w_part, row_part, n_tiles, groups


def _split_grads(grads, d: int, f: int):
    """The gradient buffer → ``(dw1 (D, F), dw2 (F, D), db1, db2, *row sums)``."""
    dw1, dw2, db1, rest = grads.split([d * f, d * f, f, grads.numel() - 2 * d * f - f])
    return (dw1.view(d, f), dw2.view(f, d), db1, *rest.split(d))


def _launch_mlp_bwd(x2, dy2, w1, b1, w2, approx):
    _check_operands(x2, w1, b1, w2, dy2=dy2)
    d, f = w1.shape
    dx, grads, w_part, row_part, n_tiles, groups = _bwd_buffers(x2, f, 1)
    _call("mlp_bwd", x2,
          (x2.data_ptr(), dy2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
           dx.data_ptr(), grads.data_ptr(), w_part.data_ptr(), row_part.data_ptr(),
           x2.shape[0], d, f, n_tiles, groups, int(approx)))
    dw1, dw2, db1, db2 = _split_grads(grads, d, f)
    return dx, dw1, db1, dw2, db2


def _launch_mlp_block_bwd(x2, dy2, g, be, w1, b1, w2, approx, eps):
    _check_operands(x2, w1, b1, w2, dy2=dy2, ln=(g, be))
    d, f = w1.shape
    dx, grads, w_part, row_part, n_tiles, groups = _bwd_buffers(x2, f, 3)
    ln_work = torch.empty_like(x2)  # LN(x), from the launch's dx pass to its dW passes
    _call("mlp_block_bwd", x2,
          (x2.data_ptr(), dy2.data_ptr(), g.data_ptr(), be.data_ptr(), w1.data_ptr(),
           b1.data_ptr(), w2.data_ptr(), dx.data_ptr(), grads.data_ptr(), w_part.data_ptr(),
           row_part.data_ptr(), ln_work.data_ptr(), x2.shape[0], d, f, n_tiles, groups,
           float(eps), int(approx)))
    dw1, dw2, db1, db2, dg, dbe = _split_grads(grads, d, f)
    return dx, dg, dbe, dw1, db1, dw2, db2


def _launch_dense_grads(name, counts, a2, dy2, w, ln=None, eps=0.0, w_layout=None):
    """One launch of a dense-layer backward kernel (``dense_bwd``,
    ``gemm_res_bwd``; with ``ln = (gamma, beta)``: ``ln_gemm_bwd``) →
    ``(da, dw (K, N), db)`` or ``(dx, dgamma, dbeta, dw, db)``; the first in
    a2's dtype, the others fp32 views of one buffer. ``w_layout`` (for the C
    functions that take it: ``dense_bwd``, ``ln_gemm_bwd``): 0 for W stored
    (K, N), 1 for nn.Linear's (N, K). As in ``_bwd_buffers`` the number of row
    groups follows from the shapes and the card alone."""
    from tpuwsi_torch.ops import _build

    rows, k = a2.shape
    n = w.shape[0] if w_layout else w.shape[1]
    dev = a2.device
    lib = _build.load()
    steps = -(-rows // lib.tpuwsi_dense_rows_per_step(k))
    slices = n // lib.tpuwsi_dense_cols_per_slice(k)  # the weight-gradient grid's other axis
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = max(1, min(steps, DENSE_DW_WAVES * sms // slices))
    n_w = k * n + n
    grads = torch.empty(n_w + (2 * k if ln else 0), dtype=torch.float32, device=dev)
    w_part = torch.empty((groups, n_w), dtype=torch.float32, device=dev)
    da = torch.empty_like(a2)
    if not ln:
        layout = () if w_layout is None else (w_layout,)
        _call(name, a2, (a2.data_ptr(), dy2.data_ptr(), w.data_ptr(), da.data_ptr(),
                         grads.data_ptr(), w_part.data_ptr(), rows, k, n, groups, *layout), counts)
        dw, db = grads.split([k * n, n])
        return da, dw.view(k, n), db
    g, be = ln
    n_tiles = -(-rows // lib.tpuwsi_mlp_rows_per_tile(k))
    row_part = torch.empty((n_tiles, 2 * k), dtype=torch.float32, device=dev)
    ln_work = torch.empty_like(a2)  # LN(x), from the launch's first kernel to its second
    _call(name, a2, (a2.data_ptr(), dy2.data_ptr(), g.data_ptr(), be.data_ptr(), w.data_ptr(),
                     da.data_ptr(), grads.data_ptr(), w_part.data_ptr(), row_part.data_ptr(),
                     ln_work.data_ptr(), rows, k, n, groups, float(eps), w_layout or 0), counts)
    dw, db, dg, dbe = grads.split([k * n, n, k, k])
    return da, dg, dbe, dw.view(k, n), db


def _launch_ln_gemm_fwd(x2, g, be, w, b, eps, w_layout=0):
    """K9a on ``w`` as it is stored: (D, F) with ``w_layout`` 0, nn.Linear's
    (F, D) with 1."""
    _check_dense_operands("LN+GEMM", x2, w, b=b, ln=(g, be), w_layout=w_layout)
    n = w.shape[0] if w_layout else w.shape[1]
    y = torch.empty((x2.shape[0], n), dtype=x2.dtype, device=x2.device)
    _call("ln_gemm_fwd", x2, (x2.data_ptr(), g.data_ptr(), be.data_ptr(), w.data_ptr(),
                              b.data_ptr(), y.data_ptr(), *x2.shape, n, float(eps), w_layout))
    return y


def _launch_ln_gemm_bwd(x2, dy2, g, be, w, eps, w_layout=0):
    """K9b on ``w`` as it is stored, as ``_launch_ln_gemm_fwd``; dw is (D, F)
    in both layouts."""
    _check_dense_operands("LN+GEMM", x2, w, dy2=dy2, ln=(g, be), w_layout=w_layout)
    return _launch_dense_grads("ln_gemm_bwd", LAUNCHES, x2, dy2, w, (g, be), eps, w_layout)


def _launch_gemm_res_fwd(res2, a2, w, b):
    _check_dense_operands("GEMM+residual", a2, w, KERNEL_WIDTHS, b=b, res2=res2)
    y = torch.empty_like(res2)
    _call("gemm_res_fwd", a2, (res2.data_ptr(), a2.data_ptr(), w.data_ptr(), b.data_ptr(),
                               y.data_ptr(), *a2.shape, w.shape[1]))
    return y


def _launch_gemm_res_bwd(a2, dy2, w):
    _check_dense_operands("GEMM+residual", a2, w, KERNEL_WIDTHS, dy2=dy2)
    return _launch_dense_grads("gemm_res_bwd", LAUNCHES, a2, dy2, w)


def _mlp_backward(ctx, dy):
    """Backward of ``_FusedMlp`` and ``_HybridMlp`` from ``(x2, w1, b1, w2)``."""
    x2, w1, b1, w2 = ctx.saved_tensors
    bwd = _mlp_bwd_reference if _use_plain(x2) else _launch_mlp_bwd
    dx, dw1, db1, dw2, db2 = bwd(x2, dy.to(x2.dtype).contiguous(), w1, b1, w2, ctx.approx)
    # the reference's vjp returns parameter gradients in the operands' dtype
    return dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(w2.dtype), None


class _FusedMlp(torch.autograd.Function):
    """Kernel forward, kernel backward that rebuilds the hidden activation
    (``tpuwsi/ops/mlp.py:312 _fused_mlp``)."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, approx):
        fwd = _mlp_fwd_reference if _use_plain(x2) else _launch_mlp_fwd
        ctx.save_for_backward(x2, w1, b1, w2)
        ctx.approx = approx
        return fwd(x2, w1, b1, w2, b2, approx)

    backward = staticmethod(_mlp_backward)


class _HybridMlp(torch.autograd.Function):
    """Ordinary PyTorch forward that keeps neither ``u`` nor ``h``, kernel
    backward (``tpuwsi/ops/mlp.py:399 _hybrid_mlp``)."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, approx):
        _use_plain(x2)  # raises for a device that is neither cuda nor cpu
        ctx.save_for_backward(x2, w1, b1, w2)
        ctx.approx = approx
        h = F.gelu(x2 @ w1 + b1, approximate="tanh" if approx else "none")
        return h @ w2 + b2

    backward = staticmethod(_mlp_backward)


class _FusedMlpBlock(torch.autograd.Function):
    """The pre-norm sub-block as one op (``tpuwsi/ops/mlp.py:742 _fused_mlp_block``)."""

    @staticmethod
    def forward(ctx, x2, g, be, w1, b1, w2, b2, approx, eps):
        fwd = _mlp_block_fwd_reference if _use_plain(x2) else _launch_mlp_block_fwd
        ctx.save_for_backward(x2, g, be, w1, b1, w2)
        ctx.approx, ctx.eps = approx, eps
        return fwd(x2, g, be, w1, b1, w2, b2, approx, eps)

    @staticmethod
    def backward(ctx, dy):
        x2, g, be, w1, b1, w2 = ctx.saved_tensors
        bwd = _mlp_block_bwd_reference if _use_plain(x2) else _launch_mlp_block_bwd
        dx, dg, dbe, dw1, db1, dw2, db2 = bwd(
            x2, dy.to(x2.dtype).contiguous(), g, be, w1, b1, w2, ctx.approx, ctx.eps)
        return (dx, dg.to(g.dtype), dbe.to(be.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(w2.dtype), None, None)


class _FusedLnGemm(torch.autograd.Function):
    """LayerNorm inside the GEMM's row tiles (``tpuwsi/ops/mlp.py:1039
    _fused_ln_gemm``). ``w`` (D, F) in any layout: the kernels read it as
    ``_weight_operand`` gives it, once for both directions."""

    @staticmethod
    def forward(ctx, x2, g, be, w, b, eps):
        ctx.eps, ctx.w_layout = eps, 0
        if _use_plain(x2):
            y = _ln_gemm_fwd_reference(x2, g, be, w, b, eps)
        else:
            w, ctx.w_layout = _weight_operand(w)
            y = _launch_ln_gemm_fwd(x2, g, be, w, b, eps, ctx.w_layout)
        ctx.save_for_backward(x2, g, be, w)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, g, be, w = ctx.saved_tensors
        dy2 = dy.to(x2.dtype).contiguous()
        if _use_plain(x2):
            dx, dg, dbe, dw, db = _ln_gemm_bwd_reference(x2, dy2, g, be, w, ctx.eps)
        else:
            dx, dg, dbe, dw, db = _launch_ln_gemm_bwd(x2, dy2, g, be, w, ctx.eps, ctx.w_layout)
        return dx, dg.to(g.dtype), dbe.to(be.dtype), dw.to(w.dtype), db.to(w.dtype), None


class _FusedGemmRes(torch.autograd.Function):
    """Output projection and residual sum as one op (``tpuwsi/ops/mlp.py:1247
    _fused_gemm_res``); the residual's gradient is the cotangent itself."""

    @staticmethod
    def forward(ctx, res2, a2, w, b):
        fwd = _gemm_res_fwd_reference if _use_plain(res2) else _launch_gemm_res_fwd
        ctx.save_for_backward(a2, w)
        return fwd(res2, a2, w, b)

    @staticmethod
    def backward(ctx, dy):
        a2, w = ctx.saved_tensors
        bwd = _gemm_res_bwd_reference if _use_plain(a2) else _launch_gemm_res_bwd
        da, dw, db = bwd(a2, dy.to(a2.dtype).contiguous(), w)
        return dy, da, dw.to(w.dtype), db.to(w.dtype)


def _apply_rows(op, x, ln, params, *static, as_stored=False):
    """Flatten x to rows, cast ``params`` to its dtype (``ln`` to fp32), apply
    the op and restore x's leading shape. The casts stand outside the op, so
    their backward carries the op's gradients to the parameters' own dtype.
    ``as_stored``: the params keep their layout (the op reads a weight as it
    is stored) instead of being made contiguous."""
    dt = x.dtype
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = op.apply(x2, *(p.float().contiguous() for p in ln),
                 *(p.to(dt) if as_stored else p.to(dt).contiguous() for p in params), *static)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def fused_mlp(x, w1, b1, w2, b2, *, approx: bool = False) -> torch.Tensor:
    """``gelu(x @ w1 + b1) @ w2 + b2`` with the hidden activation on chip in
    both directions (``tpuwsi/ops/mlp.py:339``). x: (..., D); w1: (D, F);
    w2: (F, D). ``approx`` takes the tanh GELU, else erf."""
    return _apply_rows(_FusedMlp, x, (), (w1, b1, w2, b2), bool(approx))


def hybrid_mlp(x, w1, b1, w2, b2, *, approx: bool = False) -> torch.Tensor:
    """The same function with an ordinary forward and the fused backward: one
    pass over ``dy`` gives dx and all four parameter gradients, and neither
    ``u`` nor ``h`` is kept for it (``tpuwsi/ops/mlp.py:432``)."""
    return _apply_rows(_HybridMlp, x, (), (w1, b1, w2, b2), bool(approx))


def fused_mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2, *, approx: bool = False,
                    eps: float = 1e-6) -> torch.Tensor:
    """The pre-norm MLP sub-block ``x + gelu(LN(x) @ w1 + b1) @ w2 + b2`` as
    one op (``tpuwsi/ops/mlp.py:773``). x: (..., D), the residual stream.
    LayerNorm runs in fp32 on fp32 ``ln_scale``, ``ln_bias``; its output is
    rounded to x's dtype before fc1, and the sum with x is taken in x's dtype."""
    return _apply_rows(_FusedMlpBlock, x, (ln_scale, ln_bias), (w1, b1, w2, b2),
                       bool(approx), float(eps))


def fused_ln_gemm(x, ln_scale, ln_bias, w, b, *, eps: float = 1e-6) -> torch.Tensor:
    """``LN(x) @ w + b`` with the LayerNorm inside the GEMM's row tiles: its
    fp32 output never reaches device memory (``tpuwsi/ops/mlp.py:1058``).
    x: (..., D); w: (D, F), for an ``nn.Linear`` its ``weight.t()``, read in
    place at D = 384. LayerNorm runs in fp32 on fp32 ``ln_scale``,
    ``ln_bias``; its output is rounded to x's dtype before the product."""
    return _apply_rows(_FusedLnGemm, x, (ln_scale, ln_bias), (w, b.contiguous()), float(eps),
                       as_stored=True)


def fused_gemm_residual(res, a, w, b) -> torch.Tensor:
    """``res + a @ w + b``, output projection and residual sum as one op
    (``tpuwsi/ops/mlp.py:1265``). res: (..., D); a: (..., F) in res's dtype;
    w: (F, D). ``a @ w + b`` is rounded to res's dtype before the sum."""
    dt = res.dtype
    y = _FusedGemmRes.apply(res.reshape(-1, res.shape[-1]).contiguous(),
                            a.reshape(-1, a.shape[-1]).contiguous(),
                            w.to(dt).contiguous(), b.to(dt).contiguous())
    return y.reshape(res.shape)
