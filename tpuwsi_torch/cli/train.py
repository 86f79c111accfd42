"""Slide scoring, feature extraction and the DINO SSL step bundle
(``tpuwsi/cli/train.py:1100-1294`` and ``:1560-1680``).

The serving entry points take the stream of padded ``InferChunk``s in place
of the slide table that the JAX CLI walks; the argparse ``main`` comes with
the walker port. ``params`` is the port's ``state_dict`` (for example from
``models.convert.params_from_flax``); it is loaded into ``model``, which is
moved to ``device`` and put in eval mode.

``ssl_step_bundle`` assembles the DINO training step from parsed arguments,
on a CUDA device unless the caller passes ``torch.device("cpu")``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import types
from typing import Iterable, Optional

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


def _opt_extra_kwargs(args) -> dict:
    """--opt-eps / --opt-betas override the OptimConfig defaults only when given."""
    extra = {}
    if args.opt_eps is not None:
        extra["eps"] = args.opt_eps
    if args.opt_betas is not None:
        if len(args.opt_betas) != 2:
            raise SystemExit("--opt-betas takes exactly two values")
        extra["betas"] = tuple(args.opt_betas)
    return extra


def ssl_backbone_config(args, on_cuda: bool):
    """The ViTConfig the SSL step trains, tuned defaults included."""
    from tpuwsi_torch.core.tuned import tuned_vit_kwargs
    from tpuwsi_torch.models.registry import parse_model_name

    return dataclasses.replace(
        parse_model_name(args.model),
        num_classes=0,
        img_size=args.dino_global_size,
        # DINO recipe default 0.1; an explicit --drop-path 0 must win
        drop_path_rate=0.1 if args.drop_path is None else args.drop_path,
        gelu_approx=True,  # from-scratch SSL: no checkpoint parity constraint
        remat_blocks=args.grad_checkpointing,
        **tuned_vit_kwargs(on_cuda),
    )


def ssl_multicrop_config(args, on_cuda: bool):
    """The MultiCropConfig the SSL step trains (bf16 augmentation on CUDA)."""
    from tpuwsi_torch.core.tuned import tuned_multicrop_kwargs
    from tpuwsi_torch.preprocess.multicrop import MultiCropConfig

    return MultiCropConfig(
        global_size=args.dino_global_size,
        local_size=args.dino_local_size,
        n_local=args.dino_local_crops,
        **tuned_multicrop_kwargs(on_cuda),
    )


def init_dino_weights(model: nn.Module, seed: int) -> None:
    """The reference's initialisation from one seeded CPU generator, in
    ``named_parameters`` order: matrices, the class token, the position table
    and the last layer's directions are normal(0, 0.02) truncated at two
    standard deviations; biases are 0; norm scales and the last layer's
    gains are 1."""
    from tpuwsi_torch.models.dino_head import trunc_normal_

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim > 1:
                trunc_normal_(p, generator=gen)
            elif leaf in ("g", "weight"):  # 1-D: a gain or a norm's scale
                p.fill_(1.0)
            else:
                p.zero_()


def ssl_step_bundle(args, steps_per_epoch: int, global_batch: int,
                    device: Optional[torch.device] = None, on_cuda: Optional[bool] = None,
                    vit_overrides: Optional[dict] = None):
    """Assemble the DINO SSL step from parsed args (``cli.args.parse_args``):
    the ViT student and its EMA teacher with the 65,536-wide head, multi-crop,
    AdamW with the warm-up-cosine schedule and the global-norm clip at 3.0.

    ``device`` None means the CUDA device (and raises where there is none);
    ``on_cuda`` (default: whether ``device`` is a CUDA device) switches the
    tuned configuration; ``vit_overrides`` patches the ViTConfig. Returns a
    namespace of ``model`` (the student, which ``state.student`` also refers
    to), ``params`` (its ``state_dict``), ``dcfg``, ``ocfg``, ``optimizer``,
    ``multicrop``, ``raw_step(state, batch, generator)``, ``state`` and a
    ``generator`` on the device seeded with ``args.seed``. Model parallelism
    (the reference's ``shard_fn``) is not ported (ROADMAP.md, M7).
    """
    from tpuwsi_torch.core.device import require_cuda
    from tpuwsi_torch.core.tuned import tuned_dino_kwargs, tuned_head_kwargs
    from tpuwsi_torch.models.dino_head import DINOHead
    from tpuwsi_torch.models.vit import VisionTransformer
    from tpuwsi_torch.preprocess.multicrop import make_multicrop
    from tpuwsi_torch.ssl_dino.dino import (
        DINOConfig,
        DINOModel,
        create_dino_state,
        make_dino_train_step,
    )
    from tpuwsi_torch.train.optim import OptimConfig, make_optimizer

    if device is None:
        device = require_cuda()
    if on_cuda is None:
        on_cuda = device.type == "cuda"
    cfg = ssl_backbone_config(args, on_cuda)
    if vit_overrides:
        cfg = dataclasses.replace(cfg, **vit_overrides)
    model = DINOModel(
        backbone=VisionTransformer(cfg),
        head=DINOHead(cfg.embed_dim, out_dim=args.dino_out_dim, gelu_approx=True,
                      **tuned_head_kwargs(on_cuda)),
    )
    init_dino_weights(model, args.seed)
    model = model.to(device)
    total_steps = args.epochs * steps_per_epoch
    dcfg = DINOConfig(
        out_dim=args.dino_out_dim,
        n_local=args.dino_local_crops,
        teacher_temp=args.teacher_temp,
        warmup_teacher_temp=args.warmup_teacher_temp,
        warmup_teacher_temp_steps=args.warmup_teacher_temp_epochs * steps_per_epoch,
        ema_base=args.ema_base,
        total_steps=total_steps,
        **tuned_dino_kwargs(on_cuda),
    )
    ocfg = OptimConfig(
        opt=args.opt if args.opt != "sgd" else "adamw",
        lr=args.lr,
        base_lr=args.lr_base,
        lr_base_scale="sqrt",
        weight_decay=args.weight_decay,
        sched=args.sched,
        epochs=args.epochs,
        warmup_epochs=args.warmup_epochs,
        steps_per_epoch=steps_per_epoch,
        clip_grad=args.clip_grad or 3.0,
        clip_mode=args.clip_mode,
        decay_epochs=args.decay_epochs, decay_rate=args.decay_rate,
        **_opt_extra_kwargs(args),
    )
    optimizer, _ = make_optimizer(ocfg, global_batch)
    state = create_dino_state(model, optimizer, dcfg)
    mc = make_multicrop(ssl_multicrop_config(args, on_cuda))
    raw_step = make_dino_train_step(model, optimizer, dcfg, multicrop_fn=mc)
    return types.SimpleNamespace(
        model=model, params=model.state_dict(), dcfg=dcfg, ocfg=ocfg, optimizer=optimizer,
        multicrop=mc, raw_step=raw_step, state=state,
        generator=torch.Generator(device=device).manual_seed(args.seed),
    )
