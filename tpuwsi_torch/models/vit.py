"""Vision Transformer, held against ``tpuwsi/models/vit.py``.

Parameters keep timm/DINO names and torch layouts (Linear ``(out, in)``,
``patch_embed.proj.weight`` as a conv ``(D, C, p, p)``) and stay fp32; each
GEMM casts them to ``cfg.dtype`` per call. The precision policy is the JAX
package's:

- patch, qkv, proj, fc1 and fc2 GEMMs run in ``cfg.dtype`` (bf16);
- the residual stream stays in ``cfg.dtype``;
- LayerNorm computes in fp32 (epsilon 1e-6, flax's) and casts its output to
  ``cfg.ln_dtype``;
- the head is an fp32 Linear on the fp32 cls token.

Input is NHWC ``(B, H, W, 3)`` as in JAX. The JAX package packs short
sequences several to a row block on the TPU; packing is exact, so the port
does not pack.

Training (``deterministic=False``) draws its randomness from the
``torch.Generator`` the caller passes, in this order: the embedding dropout
mask (only when ``drop_rate`` > 0), ONE uniform tensor ``(depth, 2, B)`` for
all stochastic-depth masks, thresholded per layer at ``1 - dpr_i`` as the
reference does, then per block the attention-output dropout mask (only when
``attn_drop_rate`` > 0), the projection dropout mask and the two MLP dropout
masks (only when ``drop_rate`` > 0).

``remat_blocks`` recomputes each block's activations in the backward
(``torch.utils.checkpoint``, non-reentrant) where gradients are on. The
stack is unrolled, so ``remat_policy`` "auto" and None mean full recompute,
as the reference's unrolled stack does; the other names the port takes are
in ``REMAT_POLICIES`` (``dots_saveable`` keeps the outputs of ``aten.mm``,
``addmm`` and ``bmm``). A block that draws dropout masks from the caller's
generator is recomputed from that generator's state at the block's start,
and the generator is put back after, so the backward sees the forward's
masks and later draws are unchanged. Stochastic-depth masks are drawn
before the blocks, outside any recomputed region.

Not ported yet, of the reference's ``ViTConfig`` fields: ``quant_int8``,
``scan_blocks`` (a layout of the parameter tree: ``params_from_flax`` reads
scanned trees) and ``pallas_interpret`` (the plain versions take its place).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpuwsi_torch.ops.attention import mha_from_qkv
from tpuwsi_torch.ops.dense import hybrid_dense
from tpuwsi_torch.ops.mlp import fused_mlp, fused_mlp_block, hybrid_mlp


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    # dropout on the attention output (before proj), in training
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    num_classes: int = 0  # 0 → no head (feature extractor)
    dtype: torch.dtype = torch.bfloat16
    ln_dtype: torch.dtype = torch.float32
    # recompute each block's activations in the backward (timm --grad-checkpointing)
    remat_blocks: bool = False
    # what a recomputed block keeps: a name of REMAT_POLICIES
    remat_policy: Optional[str] = "auto"
    gelu_approx: bool = False  # tanh GELU; erf when False
    # the Hopper kernels on a CUDA tensor when True, the plain versions
    # everywhere when False
    use_kernel_attention: bool = True
    # training forwards save the bf16 softmax probabilities for the backward
    # instead of rebuilding them from qkv
    attn_save_probs: bool = False
    # with use_kernel_attention: the MLP keeps its hidden activation on chip
    # (ops/mlp.fused_mlp), and a sub-block that no dropout or stochastic depth
    # touches runs LayerNorm, MLP and residual sum as one op (fused_mlp_block)
    use_fused_mlp: bool = False
    # ordinary MLP forward that saves only its input, fused kernel backward
    # (ops/mlp.hybrid_mlp); use_fused_mlp comes first where both are set
    mlp_pallas_bwd: bool = False
    # the qkv and proj layers of every attention: ordinary forward, one fused
    # kernel for dx, dW and db backward (ops/dense.hybrid_dense)
    dense_pallas_bwd: bool = False

    @property
    def num_patches_side(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_side ** 2


def _linear(x, layer: nn.Linear, dtype):
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=out_dtype)``: fp32 statistics, epsilon 1e-6."""

    def __init__(self, dim: int, out_dtype: torch.dtype):
        super().__init__(dim, eps=1e-6)
        self.out_dtype = out_dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.out_dtype)


class PatchEmbed(nn.Module):
    """Space-to-depth + one GEMM; rows are flattened in (p, p, c) order."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, dtype):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        # holds the conv-layout parameters; forward runs them as a GEMM
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):  # (B, H, W, C)
        b, h, w, c = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} is not a multiple of patch {p}")
        gh, gw = h // p, w // p
        x = x.to(self.dtype).reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c)
        weight = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        y = F.linear(x, weight.to(self.dtype), self.proj.bias.to(self.dtype))
        return y, (gh, gw)


def _dropout(x, rate: float, deterministic: bool, generator):
    """Inverted dropout with the mask drawn from ``generator``."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _drop_path(y, rate: float, mask):
    """Per-sample stochastic depth: rows of ``y`` where ``mask`` (B,) holds
    are scaled by ``1 / keep``, the others zeroed; ``mask`` None or rate 0
    passes ``y`` through (``tpuwsi/models/vit.py:155 DropPath``)."""
    if mask is None or rate == 0.0:
        return y
    mask = mask.reshape((y.shape[0],) + (1,) * (y.dim() - 1))
    return torch.where(mask, y / (1.0 - rate), torch.zeros_like(y))


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.dtype = cfg.dtype
        self.plain = not cfg.use_kernel_attention
        self.hybrid = cfg.dense_pallas_bwd
        self.save_probs = cfg.attn_save_probs
        self.attn_drop = cfg.attn_drop_rate
        self.proj_drop = cfg.drop_rate
        self.qkv = nn.Linear(d, 3 * d, bias=cfg.qkv_bias)
        self.proj = nn.Linear(d, d)

    def _dense(self, x, layer: nn.Linear):
        if self.hybrid:  # the same parameters, in the op's (in, out) layout
            return hybrid_dense(x.to(self.dtype), layer.weight.t(), layer.bias)
        return _linear(x, layer, self.dtype)

    def attention_map(self, qkv) -> torch.Tensor:
        """(B, H, N, N) fp32 softmax of the scaled scores from ``qkv``, in
        plain PyTorch as the reference computes it beside its kernel
        (``tpuwsi/models/vit.py:264-275``)."""
        b, n, d3 = qkv.shape
        hd = d3 // (3 * self.num_heads)
        qkv = qkv.reshape(b, n, 3, self.num_heads, hd)
        q, k = (qkv[:, :, i].transpose(1, 2).float() for i in range(2))
        return torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, dim=-1)

    def forward(self, x, deterministic: bool = True, generator=None, return_attn: bool = False):
        """→ the sub-block's output, and with ``return_attn`` also its
        attention map (``attention_map``); the output comes from the kernel
        either way."""
        qkv = self._dense(x, self.qkv)
        attn = self.attention_map(qkv) if return_attn else None
        out = mha_from_qkv(qkv, self.num_heads, training=not deterministic,
                           save_probs=self.save_probs, plain=self.plain)
        # on the output values, not inside the softmax (tpuwsi/models/vit.py:313-317)
        out = _dropout(out, self.attn_drop, deterministic, generator)
        out = self._dense(out, self.proj)
        out = _dropout(out, self.proj_drop, deterministic, generator)
        return (out, attn) if return_attn else out


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        hidden = int(d * cfg.mlp_ratio)
        self.dtype = cfg.dtype
        self.gelu_approx = cfg.gelu_approx
        self.drop = cfg.drop_rate
        self.fused = cfg.use_kernel_attention and cfg.use_fused_mlp
        self.hybrid = cfg.mlp_pallas_bwd
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def kernel_params(self):
        """``(w1 (D, F), b1, w2 (F, D), b2)`` as the fused ops take them: views
        of the fp32 parameters, which the ops cast to the compute type per call."""
        return self.fc1.weight.t(), self.fc1.bias, self.fc2.weight.t(), self.fc2.bias

    def forward(self, x, deterministic: bool = True, generator=None):
        if (self.fused or self.hybrid) and (self.drop == 0.0 or deterministic):
            op = fused_mlp if self.fused else hybrid_mlp
            return op(x.to(self.dtype), *self.kernel_params(), approx=self.gelu_approx)
        x = F.gelu(_linear(x, self.fc1, self.dtype),
                   approximate="tanh" if self.gelu_approx else "none")
        x = _dropout(x, self.drop, deterministic, generator)
        x = _linear(x, self.fc2, self.dtype)
        return _dropout(x, self.drop, deterministic, generator)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, drop_path: float = 0.0):
        super().__init__()
        self.dtype = cfg.dtype
        self.drop = cfg.drop_rate
        self.drop_path = drop_path
        self.gelu_approx = cfg.gelu_approx
        self.fused = cfg.use_kernel_attention and cfg.use_fused_mlp
        self.norm1 = LayerNorm(cfg.embed_dim, cfg.ln_dtype)
        self.attn = Attention(cfg)
        self.norm2 = LayerNorm(cfg.embed_dim, cfg.ln_dtype)
        self.mlp = Mlp(cfg)

    def forward(self, x, deterministic: bool = True, generator=None, drop_path_mask=None,
                return_attn: bool = False):
        """``drop_path_mask``: (2, B) bool keep masks of the two sub-blocks,
        or None for no stochastic depth. With ``return_attn`` → ``(x,
        attention map)``."""
        m1, m2 = (None, None) if drop_path_mask is None else drop_path_mask
        y = self.attn(self.norm1(x).to(self.dtype), deterministic, generator, return_attn)
        y, attn = y if return_attn else (y, None)
        x = x + _drop_path(y, self.drop_path, m1)
        # the whole MLP sub-block as one op where neither dropout nor this
        # block's stochastic depth applies (tpuwsi/models/vit.py:563-566)
        if self.fused and (deterministic or (self.drop == 0.0 and self.drop_path == 0.0)):
            x = fused_mlp_block(
                x.to(self.dtype), self.norm2.weight, self.norm2.bias,
                *self.mlp.kernel_params(), approx=self.gelu_approx, eps=self.norm2.eps)
        else:
            y = self.mlp(self.norm2(x).to(self.dtype), deterministic, generator)
            x = x + _drop_path(y, self.drop_path, m2)
        return (x, attn) if return_attn else x


# remat_policy name → the aten ops whose outputs a recomputed block keeps
# (None: full recompute); jax.checkpoint_policies' dots_saveable is the one
# named policy with a torch counterpart here
REMAT_POLICIES = {"auto": None, None: None, "dots_saveable": ("mm", "addmm", "bmm")}


def _remat_context_fn(policy):
    """``remat_policy`` → ``checkpoint``'s ``context_fn`` (None: full recompute)."""
    if policy not in REMAT_POLICIES:
        names = ", ".join(repr(k) for k in REMAT_POLICIES)
        raise ValueError(
            f"remat_policy {policy!r} has no counterpart in this package (it takes {names}; "
            "checkpoint_name'd additions such as '+attn_out' are not ported: "
            "ROADMAP.md, Queue 1)")
    ops = REMAT_POLICIES[policy]
    if ops is None:
        return None
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return functools.partial(create_selective_checkpoint_contexts,
                             [getattr(torch.ops.aten, op).default for op in ops])


def _remat_block(blk: Block, x, deterministic: bool, generator, mask, return_attn: bool,
                 context_fn):
    """``blk`` under ``torch.utils.checkpoint``. A block that draws masks
    from ``generator`` restarts it from the block's own starting state when
    recomputed, then puts back the state the generator had reached."""
    from torch.utils.checkpoint import checkpoint

    draws = (generator is not None and not deterministic
             and (blk.attn.attn_drop > 0.0 or blk.drop > 0.0))
    start = generator.get_state() if draws else None
    calls = [0]

    def run(x, mask):
        calls[0] += 1
        if start is None or calls[0] == 1:
            return blk(x, deterministic, generator, mask, return_attn)
        reached = generator.get_state()
        generator.set_state(start)
        try:
            return blk(x, deterministic, generator, mask, return_attn)
        finally:
            generator.set_state(reached)

    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(run, x, mask, use_reentrant=False, **kw)


def _keys_cubic(x):
    """Keys cubic kernel with a = -0.5 (jax.image.resize's "bicubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) resampling matrix of ``jax.image.resize(...,
    "bicubic")`` along one axis, antialiased when downscaling."""
    f32 = torch.float32
    inv_scale = 1.0 / torch.tensor(out_size / in_size, dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def interpolate_pos_encoding(pos_embed: torch.Tensor, npatch: int, gh: int, gw: int):
    """Bicubic-resample the (1, 1+N, D) position table to a gh x gw grid,
    exactly as ``jax.image.resize(..., method="bicubic")`` does."""
    n = pos_embed.shape[1] - 1
    if npatch == n:
        return pos_embed
    side = int(math.sqrt(n))
    grid = pos_embed[0, 1:].float().reshape(side, side, -1)
    wh = _resize_weights(side, gh, pos_embed.device)
    ww = _resize_weights(side, gw, pos_embed.device)
    patch = torch.einsum("ih,jw,ijd->hwd", wh, ww, grid).reshape(1, gh * gw, -1)
    return torch.cat([pos_embed[:, :1], patch.to(pos_embed.dtype)], dim=1)


class VisionTransformer(nn.Module):
    """DINO/timm-geometry ViT with cls token and learned position embedding."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        cfg = self.config = config
        self._remat_context = _remat_context_fn(cfg.remat_policy) if cfg.remat_blocks else None
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, d, cfg.dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d))
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        self.drop_path_rates = [
            cfg.drop_path_rate * i / max(cfg.depth - 1, 1) for i in range(cfg.depth)]
        self.blocks = nn.ModuleList(Block(cfg, dpr) for dpr in self.drop_path_rates)
        self.norm = LayerNorm(d, cfg.ln_dtype)
        self.head = nn.Linear(d, cfg.num_classes) if cfg.num_classes > 0 else None

    def drop_path_masks(self, batch: int, device, generator):
        """(depth, 2, B) bool keep masks from ONE uniform draw, thresholded
        per layer at that layer's keep rate (``tpuwsi/models/vit.py:793-811``)."""
        keep = 1.0 - torch.tensor(self.drop_path_rates, dtype=torch.float32, device=device)
        u = torch.rand((len(self.blocks), 2, batch), generator=generator, device=device)
        return u < keep[:, None, None]

    def forward_tokens(self, x, deterministic: bool = True, generator=None,
                       return_last_attention: bool = False,
                       intermediate_layers: Optional[int] = None):
        """(B, H, W, 3) normalised images → all tokens after the final norm,
        (B, 1 + N, D) in ``cfg.ln_dtype``, the cls token first. With
        ``return_last_attention`` the last block's attention map (B, H, N, N)
        fp32 instead; with ``intermediate_layers`` n the normed outputs of
        the last n blocks, oldest first (``tpuwsi/models/vit.py:912-918``;
        the attention map wins where both are asked, as there)."""
        cfg = self.config
        x, (gh, gw) = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], -1, -1).to(cfg.dtype)
        x = torch.cat([cls, x], dim=1)
        pos = interpolate_pos_encoding(self.pos_embed, gh * gw, gh, gw)
        x = x + pos.to(cfg.dtype)
        x = _dropout(x, cfg.drop_rate, deterministic, generator)
        masks = None
        if not deterministic and cfg.drop_path_rate > 0.0:
            masks = self.drop_path_masks(x.shape[0], x.device, generator)
        remat = self.config.remat_blocks and torch.is_grad_enabled()
        depth = len(self.blocks)
        intermediates, last_attn = [], None
        for i, blk in enumerate(self.blocks):
            want_attn = return_last_attention and i == depth - 1
            mask = None if masks is None else masks[i]
            if remat:
                x = _remat_block(blk, x, deterministic, generator, mask, want_attn,
                                 self._remat_context)
            else:
                x = blk(x, deterministic, generator, mask, want_attn)
            if want_attn:
                x, last_attn = x
            if intermediate_layers and i >= depth - intermediate_layers:
                intermediates.append(x)
        if return_last_attention:
            return last_attn
        x = self.norm(x)
        if intermediate_layers:
            return [self.norm(h) for h in intermediates[:-1]] + [x]
        return x

    def forward_features(self, x, deterministic: bool = True, generator=None):
        """(B, H, W, 3) normalised images → fp32 cls features (B, D)."""
        return self.forward_tokens(x, deterministic, generator)[:, 0].float()

    def forward(self, x, deterministic: bool = True, generator=None,
                return_all_tokens: bool = False, return_last_attention: bool = False,
                intermediate_layers: Optional[int] = None):
        """Logits (B, num_classes) fp32, or the cls features when there is no
        head; with ``return_all_tokens`` the normed tokens (B, 1 + N, D)
        instead, head or not (``tpuwsi/models/vit.py:921-926``); with
        ``return_last_attention`` or ``intermediate_layers`` what
        ``forward_tokens`` returns for them."""
        if return_last_attention or intermediate_layers:
            return self.forward_tokens(x, deterministic, generator, return_last_attention,
                                       intermediate_layers)
        if return_all_tokens:
            return self.forward_tokens(x, deterministic, generator)
        feats = self.forward_features(x, deterministic, generator)
        return feats if self.head is None else self.head(feats)


def vit_tiny(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=192, depth=12, num_heads=3, **kw)


def vit_small(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=768, depth=12, num_heads=12, **kw)


def vit_large(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=1024, depth=24, num_heads=16, **kw)
