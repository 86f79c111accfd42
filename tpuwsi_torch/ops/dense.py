"""Hybrid dense layer: ordinary PyTorch forward, one kernel for all three
gradients backward.

Counterpart of ``tpuwsi/ops/dense.py``. ``hybrid_dense(x, w, b)`` is
``x @ w + b`` with ``w (D, N)`` in the JAX layout. Its forward is a library
GEMM, as the reference leaves it to XLA; its backward is one hand-written
Hopper kernel, ``dense_bwd`` (replaces ``_dense_bwd_kernel``), which gives
``dx = dy @ w.T`` in x's dtype and ``dw = x.T @ dy``, ``db = sum(dy)`` in fp32,
summed over all rows in a fixed order: the same inputs give the same bits on
every run. ``_dense_bwd_reference`` is its plain PyTorch version, which runs
on a CPU tensor and nowhere else: on a CUDA tensor the backward launches the
kernel or raises. The kernel takes bf16, D of 384 or 768 and N of D or 3 D
(the qkv and proj layers of ViT-S and ViT-B); the reference's gate that sends
ViT-B's qkv layer to the plain backward for want of VMEM is not carried. At
D = 384 it is ``csrc/dense_sm90.cu``, which reads the weight in either layout:
the ViT passes ``nn.Linear.weight.t()``, and the backward hands the kernel
that weight's own (N, D) storage, no copy; at D = 768 it is the row-tiled
kernel of ``csrc/dense.cu``, which reads W only as (D, N), so such a view is
copied there.

As in the reference, the parameters are cast to ``x.dtype`` outside the
differentiated op and the op returns their gradients in that dtype: with bf16
compute ``dw`` and ``db`` are rounded to bf16 on their way to the fp32
parameters.

``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuwsi_torch.ops.mlp import (
    _check_dense_operands,
    _dense_grads,
    _launch_dense_grads,
    _use_plain,
    _weight_operand,
)

LAUNCHES = {"dense_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _dense_bwd_reference(x2, dy2, w):
    """Plain version of the backward kernel → ``(dx, dw, db)``; dx in x2's
    dtype, the others fp32."""
    dx, dw, db = _dense_grads(x2, dy2, w)
    return dx.to(x2.dtype), dw, db


def _check_operands(x2, dy2, w, w_layout: int = 0) -> None:
    """Raise unless the kernel takes these operands as they are: ``w`` holds
    the (D, N) weight as it is stored, (D, N) or (``w_layout`` 1) (N, D)."""
    d = x2.shape[1]
    _check_dense_operands("hybrid dense", x2, w, (d, 3 * d), dy2=dy2, w_layout=w_layout)


def _launch_dense_bwd(x2, dy2, w):
    w_op, w_layout = _weight_operand(w)
    _check_operands(x2, dy2, w_op, w_layout)
    return _launch_dense_grads("dense_bwd", LAUNCHES, x2, dy2, w_op, w_layout=w_layout)


class _HybridDense(torch.autograd.Function):
    """Library forward that keeps x's rank, kernel backward
    (``tpuwsi/ops/dense.py:167 _hybrid_dense``)."""

    @staticmethod
    def forward(ctx, x, w, b):
        _use_plain(x)  # raises for a device that is neither cuda nor cpu
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return F.linear(x, w.t(), b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        d, n = w.shape
        bwd = _dense_bwd_reference if _use_plain(x) else _launch_dense_bwd
        dx, dw, db = bwd(x.reshape(-1, d).contiguous(),
                         dy.to(x.dtype).reshape(-1, n).contiguous(), w)
        return dx.reshape(x.shape), dw.to(w.dtype), db.to(w.dtype) if ctx.has_bias else None


def hybrid_dense(x, w, b=None) -> torch.Tensor:
    """``x @ w (+ b)`` computed in x's dtype, with an ordinary forward and the
    fused backward: dx, dw and db from one op (``tpuwsi/ops/dense.py:197``).
    x: (..., D); w: (D, N), for an ``nn.Linear`` its ``weight.t()``; b: (N,)
    or None."""
    dt = x.dtype
    return _HybridDense.apply(x, w.to(dt), None if b is None else b.to(dt))
