"""Multi-head attention from the fused qkv projection, and its plain versions.

Counterpart of ``tpuwsi/ops/attention.py``. ``mha_from_qkv`` takes the qkv
GEMM output ``(B, N, 3D)`` with columns laid out ``[which(3), head, hd]``
and returns ``(B, N, D)``:

- on a CUDA tensor it launches the hand-written Hopper kernel
  ``csrc/mha_qkv_fwd.cu`` (the port of the TPU kernel ``_mha_qkv_kernel``),
  or raises for a shape the kernel does not take;
- on a CPU tensor it runs the plain version ``_mha_reference``.

``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIM = 64
KERNEL_MAX_SEQ = 511  # 512+ tokens go to the flash kernel, not yet ported

LAUNCHES = 0


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


def _mha_reference(qkv, num_heads, scale, block_len=0):
    """Plain version of ``mha_from_qkv``; ``block_len`` masks cross-block
    attention of a sequence-packed input (independent sub-sequences of
    ``block_len`` tokens laid out one after another)."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    x = qkv.reshape(b, n, 3, num_heads, d // num_heads)
    q, k, v = x.unbind(2)  # (B, N, H, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if block_len and block_len < n:
        idx = torch.arange(n, device=qkv.device) // block_len
        s = s.masked_fill(idx[:, None] != idx[None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, n, d).to(qkv.dtype)


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


def _launch(qkv: torch.Tensor, num_heads: int, scale: float, block_len: int):
    global LAUNCHES
    from tpuwsi_torch.ops import _build

    check_kernel_input(qkv, num_heads)
    lib = _build.load()
    b, n, d3 = qkv.shape
    out = torch.empty((b, n, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpuwsi_mha_qkv_fwd(
            qkv.data_ptr(), out.data_ptr(), b, n, num_heads, float(scale),
            int(block_len), stream)
    _build.check(lib, err, "mha_qkv_fwd launch")
    LAUNCHES += 1
    return out


def mha_from_qkv(qkv: torch.Tensor, num_heads: int, scale: float | None = None,
                 block_len: int = 0) -> torch.Tensor:
    """Multi-head attention directly from the fused qkv projection output.

    qkv: (B, N, 3D), columns ``[which(3), head, hd]``. Returns (B, N, D).
    ``scale`` defaults to ``hd ** -0.5``; ``block_len`` > 0 restricts
    attention to blocks of ``block_len`` consecutive tokens.
    """
    d = qkv.shape[-1] // 3
    if qkv.shape[-1] != 3 * d or d % num_heads:
        raise ValueError(f"qkv width {qkv.shape[-1]} is not 3 x {num_heads} heads")
    if scale is None:
        scale = (d // num_heads) ** -0.5
    if qkv.device.type == "cuda":
        return _launch(qkv, num_heads, scale, block_len)
    if qkv.device.type != "cpu":
        raise ValueError(f"mha_from_qkv runs on cuda or cpu, not {qkv.device}")
    return _mha_reference(qkv, num_heads, scale, block_len)
