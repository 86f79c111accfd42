"""JAX-package parameters ↔ the port's ``state_dict``.

The mapping of ``tpuwsi/models/convert.py:311 flax_vit_to_torch``, in numpy
only, for the ViT and for the ``DINOModel`` tree (``backbone`` + ``head``),
and of the MIL heads (``mil_params_from_flax``). The port keeps timm/DINO
key names and torch layouts, so a timm DINO ``state_dict`` loads into it as
it is.
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


def _vit_from_flat(flat) -> Dict[str, np.ndarray]:
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
    return sd


# DINOHead leaves: flax leaf name → (torch suffix, transpose)
_HEAD_LEAVES = {"kernel": ("weight", True), "bias": ("bias", False),
                "scale": ("weight", False), "v": ("v", True), "g": ("g", False)}


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (``jax.device_get(variables)``, with or
    without the top ``"params"`` level) → fp32 ``state_dict``.

    A ViT tree gives the keys of ``tpuwsi_torch.models.vit.VisionTransformer``;
    it may be unrolled (``blocks_{i}``) or scanned (``blocks_scan``, leading
    depth axis), and the head and the qkv bias are optional. A ``DINOModel``
    tree (``backbone/...``, ``head/mlp_{i}``, ``head/mlp_out``,
    ``head/last_layer/{v,g}``, optional ``head/bn_{i}``) gives the keys of
    ``tpuwsi_torch.ssl_dino.dino.DINOModel``.
    """
    tree = tree.get("params", tree)
    if "backbone" in tree:
        sd = {f"backbone.{k}": v for k, v in _vit_from_flat(_flatten(tree["backbone"])).items()}
        for (layer, leaf), v in _flatten(tree["head"]).items():
            suffix, transpose = _HEAD_LEAVES[leaf]
            sd[f"head.{layer}.{suffix}"] = v.T if transpose else v
    else:
        sd = _vit_from_flat(_flatten(tree))
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of ``params_from_flax`` for the parameters (buffers are
    left out): the port's ``state_dict`` → the JAX package's nested tree of
    fp32 numpy arrays under ``"params"``, with unrolled ``blocks_{i}``."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}

    def vit_tree(prefix: str) -> Dict:
        w = sd[f"{prefix}patch_embed.proj.weight"]  # (D, C, p, p)
        out: Dict = {
            "patch_embed": {"proj": {
                "kernel": w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0]),
                "bias": sd[f"{prefix}patch_embed.proj.bias"]}},
            "cls_token": sd[f"{prefix}cls_token"],
            "pos_embed": sd[f"{prefix}pos_embed"],
            "norm": {"scale": sd[f"{prefix}norm.weight"], "bias": sd[f"{prefix}norm.bias"]},
        }
        i = 0
        while f"{prefix}blocks.{i}.norm1.weight" in sd:
            blk: Dict = {}
            for torch_key, path, transpose in _BLOCK_KEYS:
                key = f"{prefix}blocks.{i}.{torch_key}"
                if key in sd:
                    node = blk
                    for name in path[:-1]:
                        node = node.setdefault(name, {})
                    node[path[-1]] = sd[key].T if transpose else sd[key]
            out[f"blocks_{i}"] = blk
            i += 1
        if f"{prefix}head.weight" in sd:
            out["head"] = {"kernel": sd[f"{prefix}head.weight"].T,
                           "bias": sd[f"{prefix}head.bias"]}
        return out

    if not any(k.startswith("backbone.") for k in sd):
        return {"params": vit_tree("")}
    head: Dict = {}
    for key, v in sd.items():
        if not key.startswith("head."):
            continue
        _, layer, suffix = key.split(".")
        if suffix in ("mean", "var"):
            continue  # BatchNorm running statistics are not parameters
        if layer.startswith("bn_"):
            head.setdefault(layer, {})["scale" if suffix == "weight" else "bias"] = v
        elif suffix in ("v", "g"):
            head.setdefault(layer, {})[suffix] = v.T if suffix == "v" else v
        else:
            head.setdefault(layer, {})["kernel" if suffix == "weight" else "bias"] = (
                v.T if suffix == "weight" else v)
    return {"params": {"backbone": vit_tree("backbone."), "head": head}}


def mil_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A MIL head's flax tree (``GatedAttentionMIL``, ``MeanPoolMIL``; with or
    without the top ``"params"`` level) → the port's ``state_dict``: each
    Dense ``kernel`` (in, out) becomes ``<layer>.weight`` (out, in)."""
    sd = {}
    for (layer, leaf), v in _flatten(tree.get("params", tree)).items():
        sd[f"{layer}.weight" if leaf == "kernel" else f"{layer}.bias"] = (
            v.T if leaf == "kernel" else v)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def mil_params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of ``mil_params_from_flax``: → ``{"params": {layer:
    {"kernel", "bias"}}}`` of fp32 numpy arrays."""
    out: Dict = {}
    for key, v in state_dict.items():
        layer, leaf = key.split(".")
        v = v.detach().cpu().float().numpy()
        out.setdefault(layer, {})["kernel" if leaf == "weight" else "bias"] = (
            v.T if leaf == "weight" else v)
    return {"params": out}
