"""Model registry: timm-style ViT name → VisionTransformer.

Counterpart of ``tpuwsi/models/registry.py`` for the ViT family:
``vit_{tiny|small|base|large}_patch{P}_{S}[_dino]``. ``_dino`` names have the
same geometry; weights come from a checkpoint through ``models.convert``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from tpuwsi_torch.models.vit import (
    ViTConfig,
    VisionTransformer,
    vit_base,
    vit_large,
    vit_small,
    vit_tiny,
)

_VIT_FACTORIES = {
    "tiny": vit_tiny,
    "small": vit_small,
    "base": vit_base,
    "large": vit_large,
}

_NAME_RE = re.compile(
    r"^vit_(?P<size>tiny|small|base|large)_patch(?P<patch>\d+)_(?P<img>\d+)(?P<dino>_dino)?$"
)

_CNN_PREFIXES = ("resnet", "wide_resnet", "resnext", "efficientnet_b")


def parse_model_name(name: str) -> ViTConfig:
    m = _NAME_RE.match(name)
    if not m:
        raise ValueError(
            f"not a ViT model name: {name!r} — expected "
            "vit_{tiny|small|base|large}_patch{P}_{S}[_dino]"
        )
    return _VIT_FACTORIES[m.group("size")](
        patch_size=int(m.group("patch")), img_size=int(m.group("img"))
    )


def create_model(
    name: str,
    num_classes: int = 2,
    img_size: Optional[int] = None,
    dtype: torch.dtype = torch.bfloat16,
    use_kernel_attention: bool = True,
    use_fused_mlp: bool = False,
    dense_pallas_bwd: bool = False,
) -> VisionTransformer:
    """Build a ViT by timm-style name, on the CPU, in eval mode."""
    if name.startswith(_CNN_PREFIXES):
        raise NotImplementedError(
            f"{name}: the CNN zoo is not ported yet (ROADMAP.md, Queue 1)")
    cfg = parse_model_name(name)
    cfg = dataclasses.replace(
        cfg,
        num_classes=num_classes,
        img_size=img_size or cfg.img_size,
        dtype=dtype,
        use_kernel_attention=use_kernel_attention,
        use_fused_mlp=use_fused_mlp,
        dense_pallas_bwd=dense_pallas_bwd,
    )
    return VisionTransformer(cfg).eval()
