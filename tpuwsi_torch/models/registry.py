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


def list_models() -> list:
    """Every ViT name of the reference's ``list_models`` (the run-book sizes;
    any patch and image size parses). The CNN names are not listed until the
    CNN zoo is ported."""
    return [f"vit_{size}_patch{p}_224{suffix}"
            for size in _VIT_FACTORIES for p in (8, 16, 32) for suffix in ("", "_dino")]


def create_model(
    name: str,
    num_classes: int = 2,
    drop_rate: float = 0.0,
    drop_path_rate: float = 0.0,
    img_size: Optional[int] = None,
    dtype: torch.dtype = torch.bfloat16,
    use_kernel_attention: bool = True,
    grad_checkpointing: bool = False,
    bn_momentum=None,
    bn_eps=None,
    attn_save_probs: bool = False,
    quant_int8: bool = False,
    use_fused_mlp: bool = False,
    dense_pallas_bwd: bool = False,
) -> VisionTransformer:
    """Build a ViT by timm-style name, on the CPU, in eval mode.

    The keywords up to ``quant_int8`` are the reference's
    (``tpuwsi/models/registry.py:79-92``, ``use_kernel_attention`` standing for
    its ``use_pallas_attention``): ``bn_momentum`` and ``bn_eps`` only reach
    the CNN families and are ignored by a ViT, as there; ``grad_checkpointing``
    recomputes each block in the backward (``remat_blocks``); ``quant_int8``
    raises ``NotImplementedError`` when set, until int8 serving is ported. ``use_fused_mlp``
    and ``dense_pallas_bwd`` are the port's own: the reference reaches those
    ``ViTConfig`` fields through ``vit_overrides`` only."""
    if name.startswith(_CNN_PREFIXES):
        raise NotImplementedError(
            f"{name}: the CNN zoo is not ported yet (ROADMAP.md, Queue 1)")
    if quant_int8:
        raise NotImplementedError(
            "quant_int8 (int8 serving) is not ported yet (ROADMAP.md, Queue 1, M8)")
    try:
        cfg = parse_model_name(name)
    except ValueError:
        raise ValueError(
            f"unknown model name: {name!r} — expected "
            "vit_{tiny|small|base|large}_patch{P}_{S}[_dino] "
            "(tpuwsi_torch.models.registry.list_models())") from None
    cfg = dataclasses.replace(
        cfg,
        num_classes=num_classes,
        drop_rate=drop_rate,
        drop_path_rate=drop_path_rate,
        img_size=img_size or cfg.img_size,
        dtype=dtype,
        remat_blocks=grad_checkpointing,
        use_kernel_attention=use_kernel_attention,
        attn_save_probs=attn_save_probs,
        use_fused_mlp=use_fused_mlp,
        dense_pallas_bwd=dense_pallas_bwd,
    )
    return VisionTransformer(cfg).eval()
