"""JAX-package ViT parameters → the port's ``state_dict``.

The mapping of ``tpuwsi/models/convert.py:311 flax_vit_to_torch``, in numpy
only. The port keeps timm/DINO key names and torch layouts, so a timm DINO
``state_dict`` loads into it as it is.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v, dtype=np.float32)
    return flat


_BLOCK_KEYS = (
    # (torch key under blocks.{i}., flax path under the block, transpose)
    ("norm1.weight", ("norm1", "scale"), False),
    ("norm1.bias", ("norm1", "bias"), False),
    ("attn.qkv.weight", ("attn", "qkv", "kernel"), True),
    ("attn.qkv.bias", ("attn", "qkv", "bias"), False),
    ("attn.proj.weight", ("attn", "proj", "kernel"), True),
    ("attn.proj.bias", ("attn", "proj", "bias"), False),
    ("norm2.weight", ("norm2", "scale"), False),
    ("norm2.bias", ("norm2", "bias"), False),
    ("mlp.fc1.weight", ("mlp", "fc1", "kernel"), True),
    ("mlp.fc1.bias", ("mlp", "fc1", "bias"), False),
    ("mlp.fc2.weight", ("mlp", "fc2", "kernel"), True),
    ("mlp.fc2.bias", ("mlp", "fc2", "bias"), False),
)


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (``jax.device_get(variables)``, with or
    without the top ``"params"`` level) → fp32 ``state_dict`` for
    ``tpuwsi_torch.models.vit.VisionTransformer``.

    Takes the unrolled (``blocks_{i}``) and the scanned (``blocks_scan``,
    leading depth axis) trees; the head and the qkv bias are optional.
    """
    flat = _flatten(tree.get("params", tree))
    sd: Dict[str, np.ndarray] = {}
    k = flat[("patch_embed", "proj", "kernel")]  # (p*p*c, D), rows (p, p, c)
    d = k.shape[1]
    p = int(round((k.shape[0] // 3) ** 0.5))
    if p * p * 3 != k.shape[0]:
        raise ValueError(f"patch-embed kernel rows {k.shape[0]} != p*p*3")
    sd["patch_embed.proj.weight"] = k.reshape(p, p, 3, d).transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = flat[("patch_embed", "proj", "bias")]
    sd["cls_token"] = flat[("cls_token",)]
    sd["pos_embed"] = flat[("pos_embed",)]

    def block(name):
        return {path[1:]: v for path, v in flat.items() if path[0] == name}

    if ("blocks_scan", "norm1", "scale") in flat:
        stacked = block("blocks_scan")
        depth = stacked[("norm1", "scale")].shape[0]
        blocks = [{path: v[i] for path, v in stacked.items()} for i in range(depth)]
    else:
        blocks = []
        while (f"blocks_{len(blocks)}", "norm1", "scale") in flat:
            blocks.append(block(f"blocks_{len(blocks)}"))
    for i, leaves in enumerate(blocks):
        for torch_key, path, transpose in _BLOCK_KEYS:
            if path in leaves:
                v = leaves[path]
                sd[f"blocks.{i}.{torch_key}"] = v.T if transpose else v

    sd["norm.weight"] = flat[("norm", "scale")]
    sd["norm.bias"] = flat[("norm", "bias")]
    if ("head", "kernel") in flat:
        sd["head.weight"] = flat[("head", "kernel")].T
        sd["head.bias"] = flat[("head", "bias")]
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}
