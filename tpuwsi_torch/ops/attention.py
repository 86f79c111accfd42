"""Multi-head attention from the fused qkv projection, forward and backward.

Counterpart of ``tpuwsi/ops/attention.py``. ``mha_from_qkv`` takes the qkv
GEMM output ``(B, N, 3D)`` with columns laid out ``[which(3), head, hd]``
and returns ``(B, N, D)``. Four hand-written Hopper kernels carry it on a
CUDA tensor, each with its plain PyTorch version beside it, which runs on a
CPU tensor:

===================  ===========================  =========================
kernel               replaces (tpuwsi/ops/        plain version
                     attention.py)
===================  ===========================  =========================
``mha_qkv_fwd``        ``_mha_qkv_kernel``            ``_mha_reference``
``mha_qkv_fwd_saved``  ``_mha_qkv_kernel_saved``      ``_mha_saved_reference``
``mha_qkv_bwd_saved``  ``_mha_qkv_bwd_kernel_saved``  ``_mha_bwd_saved_reference``
``mha_qkv_bwd``        ``_mha_qkv_bwd_kernel``        ``_mha_bwd_reference``
===================  ===========================  =========================

Two ``torch.autograd.Function``s pair them as the reference's custom VJPs do:
``_MhaQkvSaved`` (forward saves ``(qkv, p)``) and ``_MhaQkv`` (forward saves
``qkv``, backward rebuilds p). On a CUDA tensor a wrapper launches its kernel
or raises; it never gives way to the plain version.

``LAUNCHES`` counts each kernel's launches by name, so a run can show which
kernels its path went through.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIM = 64
KERNEL_MAX_SEQ = 511  # 512+ tokens go to the flash kernel, not yet ported

LAUNCHES = {"mha_qkv_fwd": 0, "mha_qkv_fwd_saved": 0, "mha_qkv_bwd_saved": 0,
            "mha_qkv_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def probs_stride(n: int) -> int:
    """Row length of the saved probabilities: ``n`` rounded up to 16, so
    every row starts on a 32-byte boundary."""
    return -(-n // 16) * 16


def attention_reference(q, k, v, kv_lengths=None, scale=None):
    """Plain softmax attention. q/k/v: (B, H, S, hd). kv_lengths: (B,) or None.

    Scores and the softmax are fp32; p is cast to v's dtype before p.V, which
    accumulates in fp32.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kv_lengths is not None:
        kidx = torch.arange(k.shape[2], device=k.device)
        valid = kidx[None, None, None, :] < kv_lengths.to(k.device)[:, None, None, None]
        s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _probs(qkv, num_heads, scale, block_len):
    """fp32 softmax probabilities (B, H, N, N) with the kernels' roundings:
    q is scaled in fp32 and rounded to qkv's dtype before the score product;
    key j is valid for query i iff they share a ``block_len`` block."""
    b, n, d3 = qkv.shape
    q, k, _ = qkv.reshape(b, n, 3, num_heads, d3 // 3 // num_heads).unbind(2)
    qs = (q.float() * scale).to(qkv.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if block_len and block_len < n:
        idx = torch.arange(n, device=qkv.device) // block_len
        s = s.masked_fill(idx[:, None] != idx[None, :], NEG_INF)
    return torch.softmax(s, dim=-1)


def _mha_saved_reference(qkv, num_heads, scale, block_len=0):
    """Plain version of the saving forward → ``(out, p)``; ``block_len``
    masks cross-block attention of a sequence-packed input (independent
    sub-sequences of ``block_len`` tokens laid out one after another).

    p is ``(B, H, N, probs_stride(N))`` in qkv's dtype, queries on rows, pad
    columns zero; the p that is stored is the rounded p that multiplies V."""
    b, n, d3 = qkv.shape
    v = qkv.reshape(b, n, 3, num_heads, -1)[:, :, 2]
    p = _probs(qkv, num_heads, scale, block_len).to(qkv.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    p = torch.nn.functional.pad(p, (0, probs_stride(n) - n))
    return out.reshape(b, n, d3 // 3).to(qkv.dtype), p


def _mha_reference(qkv, num_heads, scale, block_len=0):
    """Plain version of the forward that saves nothing."""
    return _mha_saved_reference(qkv, num_heads, scale, block_len)[0]


def _dqkv_reference(qkv, g, p_dv, p_ds, num_heads, scale):
    """dqkv from fp32 probabilities: ``p_dv`` is the operand of dV (already
    rounded), ``p_ds`` the p of t and dS. dS is rounded to qkv's dtype before
    dQ = dS.K and dK = dS^T.Q, which use the unscaled q and k."""
    b, n, d3 = qkv.shape
    q, k, v = (x.float() for x in qkv.reshape(b, n, 3, num_heads, -1).unbind(2))
    gh = g.reshape(b, n, num_heads, -1).to(qkv.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p_dv, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    t = (p_ds * dp).sum(dim=-1, keepdim=True)
    ds = (p_ds * (dp - t) * scale).to(qkv.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.stack([dq, dk, dv], dim=2).reshape(b, n, d3).to(qkv.dtype)


def _mha_bwd_saved_reference(qkv, g, p, num_heads, scale):
    """Plain version of the backward from saved probabilities: the saved p
    (in qkv's dtype) is used as it is in dV, t and dS."""
    p = p[..., :qkv.shape[1]].float()
    return _dqkv_reference(qkv, g, p, p, num_heads, scale)


def _mha_bwd_reference(qkv, g, num_heads, scale, block_len=0):
    """Plain version of the recomputing backward: p is rebuilt in fp32 and
    stays fp32 in t and dS; only dV's operand is rounded to qkv's dtype."""
    p = _probs(qkv, num_heads, scale, block_len)
    return _dqkv_reference(qkv, g, p.to(qkv.dtype).float(), p, num_heads, scale)


def check_kernel_input(qkv: torch.Tensor, num_heads: int) -> None:
    """Raise unless the Hopper kernel takes ``qkv`` as it is."""
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"mha_from_qkv kernel takes bf16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("mha_from_qkv kernel takes a contiguous, 16-byte aligned qkv")
    b, n, d3 = qkv.shape
    if d3 != 3 * num_heads * KERNEL_HEAD_DIM:
        raise ValueError(
            f"mha_from_qkv kernel takes head_dim {KERNEL_HEAD_DIM}: "
            f"got 3D = {d3} for {num_heads} heads")
    if n > KERNEL_MAX_SEQ:
        raise NotImplementedError(
            f"{n} tokens: sequences of 512+ tokens need the flash attention "
            "kernel, which is not ported yet (ROADMAP.md, Queue 2)")
    if b > 65535:
        raise NotImplementedError(f"batch {b} exceeds the launch grid (65535)")


def _check_grad_input(qkv: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    b, n, d3 = qkv.shape
    if g.shape != (b, n, d3 // 3) or g.dtype != qkv.dtype or g.device != qkv.device:
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} does not match qkv "
                         f"{tuple(qkv.shape)} {qkv.dtype}")
    g = g.contiguous()
    if g.data_ptr() % 16:
        raise ValueError("attention backward kernels take a 16-byte aligned cotangent")
    return g


def _call(name: str, qkv: torch.Tensor, args):
    """Launch C function ``tpuwsi_<name>`` on qkv's device and current
    stream, raise on a CUDA error, count the launch."""
    from tpuwsi_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"tpuwsi_{name}")(*args, stream)
    _build.check(lib, err, f"{name} launch")
    LAUNCHES[name] += 1


def _launch_fwd(qkv, num_heads, scale, block_len):
    check_kernel_input(qkv, num_heads)
    b, n, d3 = qkv.shape
    out = torch.empty((b, n, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    _call("mha_qkv_fwd", qkv,
          (qkv.data_ptr(), out.data_ptr(), b, n, num_heads, float(scale), int(block_len)))
    return out


def _launch_fwd_saved(qkv, num_heads, scale, block_len):
    check_kernel_input(qkv, num_heads)
    b, n, d3 = qkv.shape
    stride = probs_stride(n)
    out = torch.empty((b, n, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    p = torch.empty((b, num_heads, n, stride), dtype=qkv.dtype, device=qkv.device)
    _call("mha_qkv_fwd_saved", qkv,
          (qkv.data_ptr(), out.data_ptr(), p.data_ptr(), stride, b, n, num_heads,
           float(scale), int(block_len)))
    return out, p


def _launch_bwd_saved(qkv, g, p, num_heads, scale):
    check_kernel_input(qkv, num_heads)
    g = _check_grad_input(qkv, g)
    b, n, d3 = qkv.shape
    if (p.shape != (b, num_heads, n, probs_stride(n)) or p.dtype != qkv.dtype
            or not p.is_contiguous() or p.data_ptr() % 16):
        raise ValueError(f"saved probabilities {tuple(p.shape)} {p.dtype} are not what "
                         "mha_qkv_fwd_saved writes for this qkv")
    dqkv = torch.empty_like(qkv)
    _call("mha_qkv_bwd_saved", qkv,
          (qkv.data_ptr(), g.data_ptr(), p.data_ptr(), dqkv.data_ptr(), p.shape[-1], b, n,
           num_heads, float(scale)))
    return dqkv


def _launch_bwd(qkv, g, num_heads, scale, block_len):
    check_kernel_input(qkv, num_heads)
    g = _check_grad_input(qkv, g)
    b, n, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    _call("mha_qkv_bwd", qkv,
          (qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), b, n, num_heads, float(scale),
           int(block_len)))
    return dqkv


def _use_plain(qkv: torch.Tensor, plain: bool) -> bool:
    """The plain version runs where the tensor lies on the CPU or the caller
    asked for it by name; a CUDA tensor otherwise goes to its kernel."""
    if qkv.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mha_from_qkv runs on cuda or cpu, not {qkv.device}")
    return plain or qkv.device.type == "cpu"


class _MhaQkvSaved(torch.autograd.Function):
    """Forward writes the bf16 probabilities beside the output; backward reads
    them (``tpuwsi/ops/attention.py:1170 _mha_qkv_saved``)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, block_len, plain):
        fwd = _mha_saved_reference if _use_plain(qkv, plain) else _launch_fwd_saved
        out, p = fwd(qkv, num_heads, scale, block_len)
        ctx.save_for_backward(qkv, p)
        ctx.num_heads, ctx.scale, ctx.plain = num_heads, scale, plain
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, p = ctx.saved_tensors
        bwd = _mha_bwd_saved_reference if _use_plain(qkv, ctx.plain) else _launch_bwd_saved
        return bwd(qkv, g, p, ctx.num_heads, ctx.scale), None, None, None, None


class _MhaQkv(torch.autograd.Function):
    """Forward saves qkv only; backward rebuilds the probabilities
    (``tpuwsi/ops/attention.py:1195 _mha_qkv``)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, block_len, plain):
        fwd = _mha_reference if _use_plain(qkv, plain) else _launch_fwd
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale, ctx.block_len, ctx.plain = num_heads, scale, block_len, plain
        return fwd(qkv, num_heads, scale, block_len)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        bwd = _mha_bwd_reference if _use_plain(qkv, ctx.plain) else _launch_bwd
        return bwd(qkv, g, ctx.num_heads, ctx.scale, ctx.block_len), None, None, None, None


def mha_from_qkv(qkv: torch.Tensor, num_heads: int, scale: float | None = None,
                 block_len: int = 0, training: bool = False,
                 save_probs: bool = False, plain: bool = False) -> torch.Tensor:
    """Multi-head attention directly from the fused qkv projection output.

    qkv: (B, N, 3D), columns ``[which(3), head, hd]``. Returns (B, N, D).
    ``scale`` defaults to ``hd ** -0.5``; ``block_len`` > 0 restricts
    attention to blocks of ``block_len`` consecutive tokens. The reference's
    dispatch rule: ``save_probs and training`` takes the pair that saves the
    probabilities for its backward, anything else the pair that rebuilds them.
    ``plain`` routes a CUDA tensor to the plain versions too (comparison runs).
    """
    d = qkv.shape[-1] // 3
    if qkv.shape[-1] != 3 * d or d % num_heads:
        raise ValueError(f"qkv width {qkv.shape[-1]} is not 3 x {num_heads} heads")
    if scale is None:
        scale = (d // num_heads) ** -0.5
    op = _MhaQkvSaved if (save_probs and training) else _MhaQkv
    return op.apply(qkv, num_heads, float(scale), int(block_len), bool(plain))
