"""Slide scoring and feature extraction (``tpuwsi/cli/train.py:1100-1294``).

Both entry points take the stream of padded ``InferChunk``s in place of the
slide table that the JAX CLI walks; the argparse ``main`` comes with the
walker port. ``params`` is the port's ``state_dict`` (for example from
``models.convert.params_from_flax``); it is loaded into ``model``, which is
moved to ``device`` and put in eval mode.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable

import torch
from torch import nn

from tpuwsi_torch.infer.aggregate import SlideAggregator
from tpuwsi_torch.infer.pipeline import eval_stream
from tpuwsi_torch.infer.slide_walker import InferChunk
from tpuwsi_torch.preprocess.recipes import make_recipe
from tpuwsi_torch.train.supervised import make_eval_step


def _prepare(model: nn.Module, params, device: torch.device) -> nn.Module:
    model.load_state_dict(params)
    return model.to(device).eval()


def _images_on(device: torch.device):
    """chunk → its uint8 tiles on ``device`` (staged through pinned memory
    on a CUDA device, so the copy does not wait for queued work)."""
    def images_of(chunk: InferChunk) -> torch.Tensor:
        images = torch.from_numpy(chunk.images)
        if device.type == "cpu":
            return images
        return images.pin_memory().to(device, non_blocking=True)

    return images_of


def evaluate_slides(chunks: Iterable[InferChunk], model: nn.Module, params,
                    device: torch.device, dispatch_ahead: int = 4,
                    norm_type: str = "Ron"):
    """Slide-level validation: mean tile softmax per slide, per-patch and
    per-slide AUC. Returns ``(metrics, aggregator)``, ``({}, None)`` for an
    empty stream."""
    model = _prepare(model, params, device)
    norm = make_recipe("none", train=False, tile_size=model.config.img_size,
                       norm_type=norm_type)
    eval_step = make_eval_step(model, preprocess_fn=norm)
    agg = SlideAggregator()
    with torch.inference_mode():
        for chunk, (_logits, probs) in eval_stream(
                chunks, _images_on(device), eval_step, depth=dispatch_ahead):
            agg.add_chunk(chunk, probs)
    if not agg.results:
        return {}, None
    return {"auc": agg.slide_auc(), "patch_auc": agg.patch_auc()}, agg


def extract_features(chunks: Iterable[InferChunk], model: nn.Module, params,
                     output_dir: str, device: torch.device, dispatch_ahead: int = 4,
                     norm_type: str = "Ron") -> SlideAggregator:
    """Tile features and head probabilities from ONE backbone forward per
    chunk; writes ``<output_dir>/features/<slide>_features.pt`` and the
    reference-format ``inference.data`` for the MIL pipeline."""
    model = _prepare(model, params, device)
    if model.head is None:
        raise ValueError("extract_features scores tiles with the model's head: "
                         "build the model with num_classes > 0")
    norm = make_recipe("none", train=False, tile_size=model.config.img_size,
                       norm_type=norm_type)
    w_h, b_h = model.head.weight, model.head.bias

    def feat_probs_step(images):
        feats = model.forward_features(norm(images))
        logits = feats @ w_h.T + b_h
        return torch.softmax(logits, dim=-1), feats

    agg = SlideAggregator(extract_features=True)
    with torch.inference_mode():
        for chunk, (probs, feats) in eval_stream(
                chunks, _images_on(device), feat_probs_step, depth=dispatch_ahead):
            agg.add_chunk(chunk, probs, feats)
    feat_dir = os.path.join(output_dir, "features")
    agg.save_features_pt(feat_dir)
    agg.save_inference_data(os.path.join(feat_dir, "inference.data"))
    logging.info("features for %d slides → %s", len(agg.results), feat_dir)
    return agg
