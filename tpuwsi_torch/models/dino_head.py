"""DINO projection head (``tpuwsi/models/dino_head.py``).

MLP with a bottleneck, optional hidden BatchNorm, GELU, L2-normalisation of
the bottleneck in fp32, and a weight-normalised, bias-free last layer.
Parameters are fp32 in torch layouts (``(out, in)``); each GEMM casts them to
``dtype`` per call. The 65,536-wide product is a plain GEMM, as it is outside
any kernel in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def trunc_normal_(tensor: torch.Tensor, std: float = 0.02, generator=None) -> torch.Tensor:
    """Normal(0, std) truncated at two standard deviations, the reference's
    ``trunc_normal_init``."""
    return nn.init.trunc_normal_(tensor, std=std, a=-2 * std, b=2 * std, generator=generator)


class _LinearFp32Out(torch.autograd.Function):
    """``x @ w.T`` with low-precision operands and an fp32 result that is not
    rounded to the operands' type on the way out (``jax.lax.dot(...,
    preferred_element_type=float32)``). The backward GEMMs run in the
    operands' type on the cotangent cast to it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cuda":
            return torch.mm(x, w.t(), out_dtype=torch.float32)
        return x.float() @ w.float().t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w, g.t() @ x


class WeightNormDense(nn.Module):
    """Bias-free linear layer, ``w = v / (||v|| + 1e-12) * g`` per output unit.

    The norm math is fp32; the product runs in ``dtype`` with an fp32 result.
    ``fixed_gain`` (DINO's ``norm_last_layer``) detaches ``g``."""

    def __init__(self, in_dim: int, features: int, fixed_gain: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fixed_gain = fixed_gain
        self.dtype = dtype
        self.v = nn.Parameter(trunc_normal_(torch.empty(features, in_dim)))
        self.g = nn.Parameter(torch.ones(features))

    def forward(self, x):  # (B, in_dim)
        g = self.g.detach() if self.fixed_gain else self.g
        w = self.v / (self.v.norm(dim=1, keepdim=True) + 1e-12) * g[:, None]
        if self.dtype == torch.float32:
            return F.linear(x.float(), w)
        return _LinearFp32Out.apply(x.to(self.dtype), w.to(self.dtype))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the batch axis in fp32: momentum 0.99,
    epsilon 1e-5, biased variance for the batch and for the running average."""

    def __init__(self, dim: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x, deterministic: bool = True):
        x = x.float()
        if deterministic:
            mean, var = self.mean, self.var
        else:
            mean = x.mean(dim=0)
            var = (x * x).mean(dim=0) - mean * mean
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
                self.var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class DINOHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int = 65536, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, nlayers: int = 3, use_bn: bool = False,
                 norm_last_layer: bool = True, gelu_approx: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.approximate = "tanh" if gelu_approx else "none"
        self.n_hidden = max(nlayers, 1) - 1
        self.use_bn = use_bn
        dims = [in_dim] + [hidden_dim] * self.n_hidden
        for i in range(self.n_hidden):
            self.add_module(f"mlp_{i}", nn.Linear(dims[i], dims[i + 1]))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(dims[i + 1]))
        self.mlp_out = nn.Linear(dims[-1], bottleneck_dim)
        self.last_layer = WeightNormDense(bottleneck_dim, out_dim,
                                          fixed_gain=norm_last_layer, dtype=dtype)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc_normal_(m.weight)
                nn.init.zeros_(m.bias)

    def _dense(self, x, layer: nn.Linear):
        return F.linear(x.to(self.dtype), layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def forward(self, x, deterministic: bool = True):
        x = x.to(self.dtype)
        for i in range(self.n_hidden):
            x = self._dense(x, getattr(self, f"mlp_{i}"))
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, deterministic)
            x = F.gelu(x, approximate=self.approximate)
        x = self._dense(x, self.mlp_out).float()
        x = x / (x.norm(dim=-1, keepdim=True) + 1e-12)
        return self.last_layer(x)
