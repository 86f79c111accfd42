"""The measured-best ("tuned") step configuration of the JAX package
(``tpuwsi/core/tuned.py``), carried over with its switch named for this
port's device: the hand-written attention kernels with saved probabilities,
bf16 LayerNorm outputs, bf16 multi-crop, bf16 head GEMMs and bf16 loss pair
contractions when the step runs on a CUDA device, fp32 everywhere on the CPU.
None of these choices has been re-measured on an H100 yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def tuned_vit_kwargs(on_cuda: bool) -> Dict[str, Any]:
    """ViTConfig overrides. ``gelu_approx`` is not set here: it is a
    checkpoint-parity concern, so callers choose it per use case."""
    return dict(
        use_kernel_attention=on_cuda,
        # the JAX package's choice on its TPU; on an H100 the fused-MLP route
        # has kernel and step timings (PERF.md) but no benchmark cell yet
        use_fused_mlp=False,
        ln_dtype=torch.bfloat16 if on_cuda else torch.float32,
        attn_save_probs=on_cuda,
    )


def tuned_head_kwargs(on_cuda: bool) -> Dict[str, Any]:
    """DINOHead overrides: bf16 GEMMs (fp32 parameters and sums)."""
    return dict(dtype=torch.bfloat16 if on_cuda else torch.float32)


def tuned_multicrop_kwargs(on_cuda: bool) -> Dict[str, Any]:
    """MultiCropConfig overrides: bf16 augmentation pipeline."""
    return dict(compute_dtype="bfloat16" if on_cuda else "float32")


def tuned_dino_kwargs(on_cuda: bool) -> Dict[str, Any]:
    """DINOConfig overrides: bf16 loss pair contractions."""
    return dict(loss_pair_bf16=on_cuda)
