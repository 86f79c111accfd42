"""Multi-head attention from the fused qkv projection, forward and backward.

Counterpart of ``tpuwsi/ops/attention.py``. ``mha_from_qkv`` takes the qkv
GEMM output ``(B, N, 3D)`` with columns laid out ``[which(3), head, hd]``
and returns ``(B, N, D)``; ``fused_attention`` takes ``(B, H, S, hd)`` q, k
and v; ``fused_attention_block`` is the whole pre-norm attention sub-block
``x + MHA(LN(x) @ Wqkv + bqkv) @ Wproj + bproj`` as one op. Ten hand-written
Hopper kernels carry them on a CUDA tensor, each with its plain PyTorch
version beside it, which runs on a CPU tensor:

===================  ===========================  =========================
kernel               replaces (tpuwsi/ops/        plain version
                     attention.py)
===================  ===========================  =========================
``mha_qkv_fwd``        ``_mha_qkv_kernel``            ``_mha_reference``
``mha_qkv_fwd_saved``  ``_mha_qkv_kernel_saved``      ``_mha_saved_reference``
``mha_qkv_bwd_saved``  ``_mha_qkv_bwd_kernel_saved``  ``_mha_bwd_saved_reference``
``mha_qkv_bwd``        ``_mha_qkv_bwd_kernel``        ``_mha_bwd_reference``
``flash_fwd``          ``_flash_kernel``              ``_flash_reference`` (o)
``flash_fwd_stats``    ``_flash_kernel_stats``        ``_flash_reference`` (o, lse)
``flash_bwd_dq``       ``_flash_bwd_dq_kernel``       ``_flash_bwd_reference`` (dq)
``flash_bwd_dkv``      ``_flash_bwd_dkv_kernel``      ``_flash_bwd_reference`` (dk, dv)
``attn_block_fwd``     ``_attn_block_fwd_kernel``     ``_attn_block_fwd_reference``
``attn_block_bwd``     ``_attn_block_bwd_kernel``     ``_attn_block_bwd_reference``
===================  ===========================  =========================

The first four hold a whole sequence of at most 511 tokens per block; the
flash family tiles the sequence and takes any length. ``mha_from_qkv`` sends
512+ tokens to the flash family, which reads q, k and v as strided views of
qkv and writes ``(B, N, D)`` and ``(B, N, 3D)`` directly: nothing is
transposed in device memory. The sub-block pair splits an image by head
(width 384 with 6 heads or 768 with 12, ``ATTN_BLOCK_MAX_SEQ[D]`` tokens at
most, any number of images): the forward is a persistent grid of clusters of
D / 128 blocks, two heads a block, that walk the images; qkv, the scores and
the probabilities stay on chip in both directions, and the backward works
from ``x``, ``dy`` and the weights alone. No model calls it, as none does in
the reference; it is an op of the library.

``torch.autograd.Function``s pair them as the reference's custom VJPs do:
``_MhaQkvSaved`` (forward saves ``(qkv, p)``), ``_MhaQkv`` (forward saves
``qkv``, backward rebuilds p), and ``_MhaQkvFlash`` / ``_FusedAttention``
(forward with statistics saves ``(q, k, v, o, lse)``; backward is
``delta = sum(dO * O)`` in plain PyTorch, then the two backward kernels). On
a CUDA tensor a wrapper launches its kernel or raises; it never gives way to
the plain version.

``LAUNCHES`` counts each kernel's launches by name, so a run can show which
kernels its path went through.
"""

from __future__ import annotations

import torch

from tpuwsi_torch.ops.mlp import DENSE_DW_WAVES, _ln_bwd, _ln_fwd, _mm

NEG_INF = -1e30
KERNEL_HEAD_DIM = 64
KERNEL_MAX_SEQ = 511  # the whole-sequence kernels; 512+ tokens go to the flash family
# (sequence, head) items of one whole-sequence launch: an int in the kernels, whose
# grid is persistent and whose offsets are 64-bit, so the batch has no other cap
KERNEL_MAX_ITEMS = 2 ** 31 - 1
MIN_FLASH_SEQ = KERNEL_MAX_SEQ + 1
FLASH_TILE_K = 64     # keys per step of the online softmax, in kernel and plain version
# the sub-block kernels' widths and the longest sequence they take at each:
# K and V of two heads (forward), q, k, v, do of one head (backward), 304 rows
# of 128 bytes each, in a block's 227 KB
ATTN_BLOCK_MAX_SEQ = {384: 304, 768: 304}
ATTN_BLOCK_PAIR = 2        # heads a block of the forward: a cluster of D / 128 blocks an image

LAUNCHES = {"mha_qkv_fwd": 0, "mha_qkv_fwd_saved": 0, "mha_qkv_bwd_saved": 0,
            "mha_qkv_bwd": 0, "flash_fwd": 0, "flash_fwd_stats": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "attn_block_fwd": 0, "attn_block_bwd": 0}


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


def _dqkv_core(qkv, g, p_dv, p_ds, num_heads, scale):
    """fp32 dqkv from fp32 probabilities: ``p_dv`` is the operand of dV
    (already rounded), ``p_ds`` the p of t and dS. dS is rounded to qkv's
    dtype before dQ = dS.K and dK = dS^T.Q, which use the unscaled q and k."""
    b, n, d3 = qkv.shape
    q, k, v = (x.float() for x in qkv.reshape(b, n, 3, num_heads, -1).unbind(2))
    gh = g.reshape(b, n, num_heads, -1).to(qkv.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p_dv, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    t = (p_ds * dp).sum(dim=-1, keepdim=True)
    ds = (p_ds * (dp - t) * scale).to(qkv.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.stack([dq, dk, dv], dim=2).reshape(b, n, d3)


def _dqkv_reference(qkv, g, p_dv, p_ds, num_heads, scale):
    """``_dqkv_core`` rounded to qkv's dtype, as the attention kernels write it."""
    return _dqkv_core(qkv, g, p_dv, p_ds, num_heads, scale).to(qkv.dtype)


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
    """Raise unless the whole-sequence Hopper kernels take ``qkv`` as it is."""
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
        raise ValueError(
            f"{n} tokens: the whole-sequence kernels hold at most {KERNEL_MAX_SEQ} "
            "per block; mha_from_qkv sends longer sequences to the flash kernels")
    if b * num_heads > KERNEL_MAX_ITEMS:
        raise NotImplementedError(
            f"batch {b} x {num_heads} heads exceeds the kernels' item count ({KERNEL_MAX_ITEMS})")


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
    """Launch C function ``tpuwsi_<name>`` on the device of ``qkv`` (any
    operand) and its current stream, raise on a CUDA error, count the launch."""
    from tpuwsi_torch.ops import _build

    _build.launch(name, qkv, args)
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


def _flash_reference(q, k, v, kv_lengths=None, scale=None):
    """Plain version of the tiled forward → ``(o, lse)``. q: (B, H, Sq, hd);
    k, v: (B, H, Sk, hd); kv_lengths: (B,) or None; lse: (B, H, Sq) fp32.

    The kernel's arithmetic, ``FLASH_TILE_K`` keys at a time: the scale
    multiplies the fp32 score; p = exp(s - running max) stays unnormalised, is
    exactly 0 for a key at or past the length, is summed in fp32 and rounded
    to v's dtype for p.V; o = acc / l is rounded once at the end. A row with
    no valid key gives o = 0 and lse = 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    dev = q.device
    if kv_lengths is None:
        lens = torch.full((b,), sk, device=dev)
    else:
        lens = kv_lengths.to(dev)
    qf = q.float()
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=dev)
    for c0 in range(0, sk, FLASH_TILE_K):
        kt, vt = k[:, :, c0:c0 + FLASH_TILE_K], v[:, :, c0:c0 + FLASH_TILE_K]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt.float()) * scale
        kidx = torch.arange(c0, c0 + kt.shape[2], device=dev)
        valid = kidx[None, None, None, :] < lens[:, None, None, None]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vt.float())
        m = m_new
    empty = l == 0.0
    o = (acc / torch.where(empty, torch.ones_like(l), l)).to(q.dtype)
    lse = torch.where(empty, torch.zeros_like(l), m + torch.log(l.clamp(min=1e-30)))
    return o, lse[..., 0]


def _flash_delta(o, do):
    """delta = sum(dO * O) over the head dimension, fp32 (B, H, Sq), contiguous:
    the row term of the softmax gradient, outside any kernel as in the reference."""
    return (do.float() * o.float()).sum(dim=-1).contiguous()


def _flash_bwd_reference(q, k, v, do, lse, delta, scale):
    """Plain version of the two backward kernels → ``(dq, dk, dv)``: p is
    rebuilt in fp32 from lse; dS is rounded to the inputs' dtype before
    dQ = dS.K and dK = dS^T.Q, p before dV = p^T.dO."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_flash_operands(like: torch.Tensor, **tensors) -> None:
    """Raise unless the flash kernels take these (B, H, S, hd) operands as
    they are: bf16 on one CUDA device, head_dim 64 with unit stride, every
    other stride a multiple of 8 elements and the base 16-byte aligned, so
    that each row of 128 bytes is read in aligned 16-byte copies."""
    for name, x in tensors.items():
        if x.dim() != 4 or x.shape[-1] != KERNEL_HEAD_DIM:
            raise ValueError(f"flash kernels take (B, H, S, {KERNEL_HEAD_DIM}): {name} is "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.bfloat16 or x.device != like.device or x.device.type != "cuda":
            raise ValueError(f"flash kernels take bf16 tensors on one CUDA device: {name} is "
                             f"{x.dtype} on {x.device}")
        if x.shape[:2] != like.shape[:2]:
            raise ValueError(f"{name} {tuple(x.shape)} does not share batch and heads with "
                             f"{tuple(like.shape)}")
        if x.stride(3) != 1 or any(st % 8 for st in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"flash kernels take rows of 64 contiguous values, 16-byte aligned: "
                             f"{name} has strides {x.stride()}")


def _strides(*tensors):
    """Batch, head and row strides of each tensor, in elements, as a C array."""
    import ctypes

    vals = [st for x in tensors for st in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _row_stats(name, x, like):
    if (x.shape != like.shape[:3] or x.dtype != torch.float32 or x.device != like.device
            or not x.is_contiguous()):
        raise ValueError(f"{name} must be fp32 {tuple(like.shape[:3])}, contiguous, beside q: "
                         f"got {x.dtype} {tuple(x.shape)}")
    return x.data_ptr()


def _launch_flash_fwd(q, k, v, kv_lengths, scale, stats, out=None):
    """The tiled forward kernel → ``(o, lse)``; lse is None without ``stats``.
    ``out``: a (B, H, Sq, hd) view to write o into, else o is allocated."""
    b, h, sq, hd = q.shape
    if out is None:
        out = torch.empty((b, h, sq, hd), dtype=q.dtype, device=q.device)
    _check_flash_operands(q, q=q, k=k, v=v, o=out)
    if k.shape != v.shape or k.stride() != v.stride() or out.shape != q.shape:
        raise ValueError("flash forward: k and v must share shape and strides, o q's shape")
    lens = None
    if kv_lengths is not None:
        if kv_lengths.shape != (b,):
            raise ValueError(f"kv_lengths must be ({b},), got {tuple(kv_lengths.shape)}")
        lens = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    lse = None
    if stats:
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        ptrs.append(lse.data_ptr())
    ptrs.append(None if lens is None else lens.data_ptr())
    _call("flash_fwd_stats" if stats else "flash_fwd", q,
          (*ptrs, b, h, sq, k.shape[2], _strides(q, k, out), float(scale)))
    return out, lse


def _launch_flash_bwd(q, k, v, do, lse, delta, scale, grads=None):
    """The two backward kernels → ``(dq, dk, dv)``, written into the views
    ``grads`` where given (dk and dv must share their strides)."""
    if grads is None:
        grads = (torch.empty(q.shape, dtype=q.dtype, device=q.device),
                 torch.empty(k.shape, dtype=k.dtype, device=k.device),
                 torch.empty(v.shape, dtype=v.dtype, device=v.device))
    dq, dk, dv = grads
    _check_flash_operands(q, q=q, k=k, v=v, do=do, dq=dq, dk=dk, dv=dv)
    if (k.shape != v.shape or k.stride() != v.stride() or do.shape != q.shape
            or dq.shape != q.shape or dk.shape != k.shape or dv.shape != k.shape
            or dk.stride() != dv.stride()):
        raise ValueError("flash backward: k, v and dk, dv must share shape and strides; "
                         "dO and dq take q's shape")
    b, h, sq, _ = q.shape
    stats = (_row_stats("lse", lse, q), _row_stats("delta", delta, q))
    dims = (b, h, sq, k.shape[2])
    _call("flash_bwd_dq", q,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *stats, dq.data_ptr(),
           *dims, _strides(q, k, do, dq), float(scale)))
    _call("flash_bwd_dkv", q,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *stats, dk.data_ptr(),
           dv.data_ptr(), *dims, _strides(q, k, do, dk), float(scale)))
    return dq, dk, dv


def _flash_forward(q, k, v, kv_lengths, scale, stats, plain, out=None):
    """Kernel or plain version of the tiled forward, by ``_use_plain``."""
    if not _use_plain(q, plain):
        return _launch_flash_fwd(q, k, v, kv_lengths, scale, stats, out)
    o, lse = _flash_reference(q, k, v, kv_lengths, scale)
    if out is not None:
        o = out.copy_(o)
    return o, (lse if stats else None)


def _flash_backward(q, k, v, o, do, lse, scale, plain, grads=None):
    """delta in plain PyTorch, then kernel or plain version of dQ and dK/dV."""
    delta = _flash_delta(o, do)
    if not _use_plain(q, plain):
        return _launch_flash_bwd(q, k, v, do, lse, delta, scale, grads)
    out = _flash_bwd_reference(q, k, v, do, lse, delta, scale)
    if grads is not None:
        out = tuple(dst.copy_(src) for dst, src in zip(grads, out))
    return out


def _heads(x: torch.Tensor, num_heads: int, parts: int):
    """(B, N, parts * D) → ``parts`` strided views (B, H, N, hd), no copy."""
    b, n, width = x.shape
    return x.view(b, n, parts, num_heads, width // parts // num_heads).permute(
        2, 0, 3, 1, 4).unbind(0)


class _FusedAttention(torch.autograd.Function):
    """Tiled attention on (B, H, S, hd) tensors: forward with statistics
    saves ``(q, k, v, o, lse)``, backward rebuilds p tile by tile
    (``tpuwsi/ops/attention.py:506 _fused_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, plain):
        o, lse = _flash_forward(q, k, v, None, scale, True, plain)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.plain = scale, plain
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        grads = _flash_backward(q, k, v, o, g.contiguous(), lse, ctx.scale, ctx.plain)
        return (*grads, None, None)


class _MhaQkvFlash(torch.autograd.Function):
    """The same pair on the fused qkv projection: q, k, v are strided views
    of qkv, o is written as (B, N, D) and dQ, dK, dV into one (B, N, 3D)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, plain):
        out, lse = _mha_flash_forward(qkv, num_heads, scale, True, plain)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.scale, ctx.plain = num_heads, scale, plain
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        h = ctx.num_heads
        q, k, v = _heads(qkv, h, 3)
        (o,), (do,) = _heads(out, h, 1), _heads(g.contiguous(), h, 1)
        dqkv = torch.empty_like(qkv)
        _flash_backward(q, k, v, o, do, lse, ctx.scale, ctx.plain, grads=_heads(dqkv, h, 3))
        return dqkv, None, None, None


def _mha_flash_forward(qkv, num_heads, scale, stats, plain):
    """qkv (B, N, 3D) → ``(out (B, N, D), lse)`` through the tiled forward."""
    if not _use_plain(qkv, plain) and not qkv.is_contiguous():
        raise ValueError("mha_from_qkv kernels take a contiguous qkv")
    b, n, d3 = qkv.shape
    q, k, v = _heads(qkv, num_heads, 3)
    out = torch.empty((b, n, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    _, lse = _flash_forward(q, k, v, None, scale, stats, plain, out=_heads(out, num_heads, 1)[0])
    return out, lse


def _attn_block_qkv(x, g, be, wqkv, bqkv, eps):
    """The part both sub-block kernels share → ``(ln, xhat, inv, qkv)``: fp32
    LayerNorm (fast variance), its output rounded to x's dtype, and
    qkv = fp32 product + fp32 bias, rounded; ln, xhat, inv are (B N, ·)."""
    b, n, d = x.shape
    ln, xhat, inv = _ln_fwd(x.reshape(b * n, d).float(), g.float(), be.float(), eps)
    ln = ln.to(x.dtype)
    qkv = (_mm(ln, wqkv) + bqkv.float()).to(x.dtype)
    return ln, xhat, inv, qkv.reshape(b, n, 3 * d)


def _attn_block_fwd_reference(x, g, be, wqkv, bqkv, wp, bp, num_heads, scale, eps):
    """Plain version of the sub-block forward kernel. x: (B, N, D); weights
    ``(in, out)`` in x's dtype; g, be fp32. o is rounded before the projection
    and the projection with its bias before x is added, in x's dtype."""
    qkv = _attn_block_qkv(x, g, be, wqkv, bqkv, eps)[3]
    o = _mha_reference(qkv, num_heads, scale)
    y = (_mm(o.reshape(-1, o.shape[-1]), wp) + bp.float()).to(x.dtype)
    return x + y.reshape(x.shape)


def _attn_block_bwd_reference(x, dy, g, be, wqkv, bqkv, wp, num_heads, scale, eps):
    """Plain version of the sub-block backward kernel →
    ``(dx, dg, dbe, dwqkv, dbqkv, dwp, dbp)``; dx in x's dtype, the others
    fp32. Everything is rebuilt from x and the weights. dqkv is rounded as
    the operand of dWqkv and dln, but dbqkv sums the unrounded one."""
    b, n, d = x.shape
    dt = x.dtype
    gam = g.float()
    ln, xhat, inv, qkv = _attn_block_qkv(x, g, be, wqkv, bqkv, eps)
    o = _mha_reference(qkv, num_heads, scale).reshape(b * n, d)
    dy2 = dy.reshape(b * n, d).to(dt)
    dyf = dy2.float()
    do = _mm(dy2, wp.t()).to(dt).reshape(b, n, d)
    p = _probs(qkv, num_heads, scale, 0)
    dqkv = _dqkv_core(qkv, do, p.to(dt).float(), p, num_heads, scale).reshape(b * n, 3 * d)
    dqkv_c = dqkv.to(dt)
    dln = _mm(dqkv_c, wqkv.t())
    dx = (dyf + _ln_bwd(dln, gam, xhat, inv)).to(dt).reshape(b, n, d)
    return (dx, (dln * xhat).sum(dim=0), dln.sum(dim=0), _mm(ln.t(), dqkv_c),
            dqkv.sum(dim=0), _mm(o.t(), dy2), dyf.sum(dim=0))


def check_attn_block_operands(x, g, be, wqkv, bqkv, wp, bp=None, num_heads=0, dy=None) -> None:
    """Raise unless the sub-block kernels take these operands as they are
    (``dy`` given: the backward's)."""
    if x.dim() != 3:
        raise ValueError(f"fused_attention_block takes x (B, N, D), got {tuple(x.shape)}")
    b, n, d = x.shape
    if d % max(num_heads, 1) or d // max(num_heads, 1) != KERNEL_HEAD_DIM:
        raise ValueError(f"attention sub-block kernels take head_dim {KERNEL_HEAD_DIM}: got "
                         f"D = {d} with {num_heads} heads")
    if d not in ATTN_BLOCK_MAX_SEQ:
        raise NotImplementedError(
            "attention sub-block kernels are built for D = 384 (6 heads, clusters of 3 blocks) "
            f"and D = 768 (12 heads, clusters of 6): got D = {d}")
    if not 1 <= n <= ATTN_BLOCK_MAX_SEQ[d]:
        raise ValueError(f"{n} tokens: the attention sub-block kernels hold at most "
                         f"{ATTN_BLOCK_MAX_SEQ[d]} rows of two heads' K and V (one head's q, k, "
                         "v, do) in a block's shared memory")
    # the grids are persistent and the offsets 64-bit: what remains are the
    # int counts of (image, head) items and, in the backward's row-tiled
    # kernels, of elements of dqkv
    if b < 1 or b * (d // KERNEL_HEAD_DIM) > KERNEL_MAX_ITEMS:
        raise NotImplementedError(f"batch {b} x {d // KERNEL_HEAD_DIM} heads exceeds the "
                                  f"kernels' item count ({KERNEL_MAX_ITEMS})")
    if dy is not None and b * n * 3 * d >= 2 ** 31:
        raise NotImplementedError(f"{b} x {n} x {3 * d} elements of dqkv exceed the backward's "
                                  "int offsets (2^31)")
    tensors = {"x": (x, (b, n, d)), "wqkv": (wqkv, (d, 3 * d)), "bqkv": (bqkv, (3 * d,)),
               "wproj": (wp, (d, d)), "bproj": (bp, (d,)), "dy": (dy, (b, n, d))}
    for name, (t, shape) in tensors.items():
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.bfloat16 or t.device != x.device:
            raise ValueError(f"attention sub-block kernels take bf16 on one CUDA device: {name} "
                             f"is {t.dtype} {tuple(t.shape)} on {t.device}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention sub-block kernels take contiguous, 16-byte aligned "
                             f"tensors: {name} has strides {t.stride()}")
    for name, t in (("ln_scale", g), ("ln_bias", be)):
        if (tuple(t.shape) != (d,) or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 8):
            raise ValueError(f"attention sub-block kernels take fp32 ({d},) {name} beside x: "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


# the kernels' shared-memory plans (csrc/attn_block.cu fwd_plan, bwd_plan)
_SMEM_LIMIT = 232448
_BOX = 64 * 128
_FWD_A_STAGES, _FWD_MAX_W_STAGES, _FWD_W_STAGE = 3, 6, 2 * _BOX
_FWD_BAR_BYTES = 8 * (2 * _FWD_A_STAGES + 2 * _FWD_MAX_W_STAGES + 2)
_BWD_MAX_STAGES, _BWD_STAGE, _BWD_BAR_BYTES = 3, 6 * _BOX, 8 * 2 * 3


def attn_block_geometry(b: int, n: int, d: int, sms: int, clusters: int) -> dict:
    """The sub-block kernels' launch at (B, N, D) on a card of ``sms`` SMs that
    holds ``clusters`` clusters of the forward at once, as csrc/attn_block.cu
    computes it: the forward's cluster size (two heads a block); its query-tile
    groups (more clusters than images: an image's 64-row query tiles are
    split over several clusters, each running the image's K/V pass for its
    own); its persistent grid (at most one cluster per item) and its ring of
    weight stages; the backward head kernel's persistent grid over (image,
    head) items and its ring; the shared memory of each."""
    heads, rows, tiles = d // KERNEL_HEAD_DIM, -(-n // 16) * 16, -(-n // 64)
    cluster = heads // ATTN_BLOCK_PAIR
    groups = max(1, min(tiles, clusters // b))
    off_w = 4 * rows * 128 + _FWD_A_STAGES * _BOX
    tail = 2 * _BOX + _FWD_BAR_BYTES
    w_stages = min(_FWD_MAX_W_STAGES, (_SMEM_LIMIT - off_w - tail) // _FWD_W_STAGE)
    fixed = 4 * rows * 128 + 3 * 8 * 64 * 4 + 12 * 64 * tiles + _BWD_BAR_BYTES
    stages = min(_BWD_MAX_STAGES, (_SMEM_LIMIT - fixed) // _BWD_STAGE)
    return {"cluster": cluster, "groups": groups,
            "fwd_grid": min(clusters, b * groups) * cluster,
            "fwd_w_stages": w_stages, "fwd_smem": off_w + w_stages * _FWD_W_STAGE + tail,
            "bwd_grid": min(b * heads, sms), "bwd_stages": stages,
            "bwd_smem": fixed + stages * _BWD_STAGE}


_clusters_checked = set()


def _check_clusters(x: torch.Tensor, n: int) -> None:
    """Raise if the card cannot hold one cluster of the forward at this width
    and length, or if the library was built for another length limit than
    this module states (asked once per device, width and padded length)."""
    from tpuwsi_torch.ops import _build

    d = x.shape[-1]
    key = (x.device, d, -(-n // 16))
    if key in _clusters_checked:
        return
    lib = _build.load()
    if lib.tpuwsi_attn_block_max_seq(d) != ATTN_BLOCK_MAX_SEQ[d]:
        raise RuntimeError(f"ATTN_BLOCK_MAX_SEQ[{d}] and the kernels' own limit differ: "
                           f"{ATTN_BLOCK_MAX_SEQ[d]}, {lib.tpuwsi_attn_block_max_seq(d)}")
    with torch.cuda.device(x.device):
        clusters = lib.tpuwsi_attn_block_max_clusters(d, n)
    if clusters < 0:
        _build.check(lib, -clusters, "attn_block_fwd occupancy query")
    if clusters == 0:
        raise RuntimeError(
            f"attn_block_fwd: the device can hold 0 clusters of {d // 128} blocks at D = {d}, "
            f"{n} tokens (cudaOccupancyMaxActiveClusters)")
    _clusters_checked.add(key)


def _launch_attn_block_fwd(x, g, be, wqkv, bqkv, wp, bp, num_heads, scale, eps):
    """One launch of the forward: bf16 LN(x) into a workspace (once per
    image, for all of its heads), then the clusters over the images."""
    check_attn_block_operands(x, g, be, wqkv, bqkv, wp, bp, num_heads)
    b, n, d = x.shape
    _check_clusters(x, n)
    y = torch.empty_like(x)
    ln_work = torch.empty_like(x)
    _call("attn_block_fwd", x,
          (x.data_ptr(), g.data_ptr(), be.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
           wp.data_ptr(), bp.data_ptr(), y.data_ptr(), ln_work.data_ptr(), b, n, d, num_heads,
           float(scale), float(eps)))
    return y


def _launch_attn_block_bwd(x, dy, g, be, wqkv, bqkv, wp, num_heads, scale, eps):
    """One launch of the backward: LN(x), the per-head kernel, then the
    row-tiled ones over the three workspaces it shares with them (dqkv, o and
    LN(x), 5 B N D bf16 in all). The numbers of row groups follow from the
    shapes and the card alone, so the order of every sum is the same on every
    run."""
    from tpuwsi_torch.ops import _build

    check_attn_block_operands(x, g, be, wqkv, bqkv, wp, None, num_heads, dy)
    b, n, d = x.shape
    dev = x.device
    lib = _build.load()
    rows = b * n
    steps = -(-rows // lib.tpuwsi_dense_rows_per_step(d))
    slices = d // lib.tpuwsi_dense_cols_per_slice(d)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups_qkv = max(1, min(steps, DENSE_DW_WAVES * sms // (3 * slices)))
    groups_proj = max(1, min(steps, DENSE_DW_WAVES * sms // slices))
    n_qkv, n_proj = d * 3 * d + 3 * d, d * d + d
    bf, f32 = torch.bfloat16, torch.float32
    dx = torch.empty_like(x)
    grads = torch.empty(n_qkv + n_proj + 2 * d + 3 * d, dtype=f32, device=dev)
    dqkv_work = torch.empty((b, n, 3 * d), dtype=bf, device=dev)
    o_work = torch.empty((b, n, d), dtype=bf, device=dev)
    ln_work = torch.empty((b, n, d), dtype=bf, device=dev)
    dbqkv_part = torch.empty((b, 3 * d), dtype=f32, device=dev)
    w_part_qkv = torch.empty((groups_qkv, n_qkv), dtype=f32, device=dev)
    w_part_proj = torch.empty((groups_proj, n_proj), dtype=f32, device=dev)
    row_part = torch.empty((-(-rows // lib.tpuwsi_mlp_rows_per_tile(d)), 2 * d), dtype=f32,
                           device=dev)
    _call("attn_block_bwd", x,
          (x.data_ptr(), dy.data_ptr(), g.data_ptr(), be.data_ptr(), wqkv.data_ptr(),
           bqkv.data_ptr(), wp.data_ptr(), dx.data_ptr(), grads.data_ptr(),
           dqkv_work.data_ptr(), o_work.data_ptr(), ln_work.data_ptr(), dbqkv_part.data_ptr(),
           w_part_qkv.data_ptr(), w_part_proj.data_ptr(), row_part.data_ptr(), b, n, d,
           num_heads, groups_qkv, groups_proj, float(scale), float(eps)))
    dwqkv, _, dwp, dbp, dg, dbe, dbqkv = grads.split([d * 3 * d, 3 * d, d * d, d, d, d, 3 * d])
    return dx, dg, dbe, dwqkv.view(d, 3 * d), dbqkv, dwp.view(d, d), dbp


class _FusedAttnBlock(torch.autograd.Function):
    """The pre-norm attention sub-block as one op; the forward saves x and
    the cast weights only (``tpuwsi/ops/attention.py:1766 _fused_attn_block``)."""

    @staticmethod
    def forward(ctx, x, g, be, wqkv, bqkv, wp, bp, num_heads, scale, eps, plain):
        fwd = _attn_block_fwd_reference if _use_plain(x, plain) else _launch_attn_block_fwd
        ctx.save_for_backward(x, g, be, wqkv, bqkv, wp)
        ctx.static = (num_heads, scale, eps)
        ctx.plain = plain
        return fwd(x, g, be, wqkv, bqkv, wp, bp, num_heads, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, g, be, wqkv, bqkv, wp = ctx.saved_tensors
        bwd = _attn_block_bwd_reference if _use_plain(x, ctx.plain) else _launch_attn_block_bwd
        dx, dg, dbe, dwqkv, dbqkv, dwp, dbp = bwd(
            x, dy.to(x.dtype).contiguous(), g, be, wqkv, bqkv, wp, *ctx.static)
        # the reference's vjp returns parameter gradients in the operands' dtype
        return (dx, dg.to(g.dtype), dbe.to(be.dtype), dwqkv.to(wqkv.dtype),
                dbqkv.to(wqkv.dtype), dwp.to(wp.dtype), dbp.to(wp.dtype), None, None, None, None)


def fused_attention_block(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads: int, *,
                          eps: float = 1e-6, plain: bool = False) -> torch.Tensor:
    """The pre-norm attention sub-block
    ``x + MHA(LN(x) @ wqkv + bqkv) @ wproj + bproj`` as one op
    (``tpuwsi/ops/attention.py:1800``). x: (B, N, D), the residual stream;
    wqkv: (D, 3D) with columns ``[which(3), head, hd]``; wproj: (D, D).

    LayerNorm runs in fp32 on fp32 ``ln_scale``, ``ln_bias``; the weights are
    cast to x's dtype outside the op, so with bf16 compute their gradients
    are rounded to bf16 on the way to fp32 parameters while the LayerNorm
    gradients stay fp32. On a CUDA tensor the two sub-block kernels run (bf16,
    D = 384 with 6 heads or D = 768 with 12, at most ``ATTN_BLOCK_MAX_SEQ[D]``
    tokens, any number of images within the int item counts, a contiguous x)
    or the call raises; a CPU tensor, or ``plain``, takes their plain
    versions. Short sequences are not packed several to a program as the
    reference packs them: packing is exact, so the values are the same."""
    if x.dim() != 3 or x.shape[-1] % num_heads:
        raise ValueError(f"fused_attention_block takes x (B, N, D) with D a multiple of "
                         f"{num_heads} heads, got {tuple(x.shape)}")
    dt = x.dtype
    scale = (x.shape[-1] // num_heads) ** -0.5
    return _FusedAttnBlock.apply(
        x, ln_scale.float().contiguous(), ln_bias.float().contiguous(),
        *(p.to(dt).contiguous() for p in (wqkv, bqkv, wproj, bproj)),
        int(num_heads), float(scale), float(eps), bool(plain))


def fused_attention(q, k, v, kv_lengths=None, scale=None, force_kernel: bool = False,
                    plain: bool = False) -> torch.Tensor:
    """Attention on (B, H, S, hd) tensors (``tpuwsi/ops/attention.py:1307``).

    ``MIN_FLASH_SEQ`` keys or more, or ``force_kernel``, take the tiled pair:
    the flash kernels on a CUDA tensor, their plain versions on a CPU tensor
    or with ``plain``. Shorter sequences take ``attention_reference``, the
    product that the reference leaves to its compiler. ``kv_lengths`` (B,)
    masks keys at or past each element's length; that path has no gradient,
    as in the reference, and raises if one is asked for.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    need_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    if kv_lengths is not None and need_grad:
        raise ValueError("fused_attention with kv_lengths has no backward: "
                         "detach the inputs or run under torch.no_grad()")
    _use_plain(q, plain)  # raises for a device that is neither cuda nor cpu
    if k.shape[2] < MIN_FLASH_SEQ and not force_kernel:
        return attention_reference(q, k, v, kv_lengths, scale)
    if need_grad:
        return _FusedAttention.apply(q, k, v, float(scale), bool(plain))
    return _flash_forward(q, k, v, kv_lengths, float(scale), False, plain)[0]


def mha_from_qkv(qkv: torch.Tensor, num_heads: int, scale: float | None = None,
                 block_len: int = 0, training: bool = False,
                 save_probs: bool = False, plain: bool = False) -> torch.Tensor:
    """Multi-head attention directly from the fused qkv projection output.

    qkv: (B, N, 3D), columns ``[which(3), head, hd]``. Returns (B, N, D).
    ``scale`` defaults to ``hd ** -0.5``; ``block_len`` > 0 restricts
    attention to blocks of ``block_len`` consecutive tokens. The reference's
    dispatch rule: ``save_probs and training`` takes the pair that saves the
    probabilities for its backward, anything else the pair that rebuilds them.
    ``MIN_FLASH_SEQ`` tokens or more take the tiled flash pair, whatever
    ``training`` and ``save_probs`` say (it never saves p), and ``block_len``
    raises there. ``plain`` routes a CUDA tensor to the plain versions too
    (comparison runs).
    """
    d = qkv.shape[-1] // 3
    if qkv.shape[-1] != 3 * d or d % num_heads:
        raise ValueError(f"qkv width {qkv.shape[-1]} is not 3 x {num_heads} heads")
    if scale is None:
        scale = (d // num_heads) ** -0.5
    n = qkv.shape[1]
    if n >= MIN_FLASH_SEQ:
        if 0 < block_len < n:
            raise ValueError(f"block_len {block_len} with {n} tokens: the tiled kernels "
                             "take no block mask; pack sequences below 512 tokens only")
        _use_plain(qkv, plain)  # raises for a device that is neither cuda nor cpu
        if torch.is_grad_enabled() and qkv.requires_grad:
            return _MhaQkvFlash.apply(qkv, num_heads, float(scale), bool(plain))
        return _mha_flash_forward(qkv, num_heads, float(scale), False, plain)[0]
    op = _MhaQkvSaved if (save_probs and training) else _MhaQkv
    return op.apply(qkv, num_heads, float(scale), int(block_len), bool(plain))
