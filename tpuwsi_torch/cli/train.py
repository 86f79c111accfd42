"""Training entry point: ``python -m tpuwsi_torch.cli.train ...``
(``tpuwsi/cli/train.py``).

``main`` takes the JAX CLI's arguments and runs four of its modes:

- supervised tile classification (neither ``--ssl`` nor ``-ef``;
  ``train_supervised``): over the slide table's training folds (WSI mode:
  ``WSITileSampler``, the named recipes, slide evaluation of the test fold
  every --eval_rate epochs) or over a folder of images (``--data-dir``:
  top-1, top-5, mean CE and two-class AUC of the validation split), with
  SGD, Nesterov SGD or AdamW, label smoothing, --model-ema, best-K and
  recovery checkpoints, --resume, ``summary.csv``, ``metrics.jsonl`` and the
  ledger;
- ``--ssl``: the DINO SSL loop (``train_ssl``) over a folder of images
  (``--data-dir``) or over the slide table's tissue tiles (WSI mode): the
  step that ``ssl_step_bundle`` assembles, the shared per-epoch shuffle,
  checkpoints, the kNN probe (folder mode), ``log.txt``, ``run_data.jsonl``
  and ``summary.csv``;
- ``-tar Survival_Time`` / ``Survival_Binary``: survival training
  (``train_survival``) over the survival slide table's training folds, Cox
  risk regression or the masked 5-year status, with the slide C-index (and
  the binary AUC) of the test fold every --eval_rate epochs;
- ``-ef``: per-tile features and head probabilities of the test fold's
  slides (``extract_features_from_table``), a model initialised from
  ``--seed`` or loaded from a supervised checkpoint (--resume,
  --initial-checkpoint, -tl).

Every other mode, and every slide format this package cannot read, raises
``NotImplementedError`` naming its ROADMAP.md item before any file is
written. There is no console script: ``pyproject.toml``'s scripts name the
JAX package's entry points.

The serving functions ``evaluate_slides`` and ``extract_features`` take a
stream of padded ``InferChunk``s (``SlideWalker.walk()`` gives one);
``evaluate_slide_table`` walks the slide table itself. ``params`` is the
port's ``state_dict`` (for example from ``models.convert.params_from_flax``);
it is loaded into ``model``, which is moved to ``device`` and put in eval
mode.

Everything runs on a CUDA device unless the caller passes
``torch.device("cpu")``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
import types
from typing import Iterable, Optional

import numpy as np
import torch
from torch import nn

from tpuwsi_torch.infer.aggregate import SlideAggregator
from tpuwsi_torch.infer.pipeline import eval_stream
from tpuwsi_torch.infer.slide_walker import InferChunk
from tpuwsi_torch.preprocess.recipes import make_recipe
from tpuwsi_torch.train.supervised import eval_module, make_eval_step, make_train_step

SURVIVAL_TARGETS = ("Survival_Time", "Survival_Binary")


def _prepare(model: nn.Module, params, device: torch.device) -> nn.Module:
    """``model`` with ``params`` loaded (None: as it is), on ``device``, in
    eval mode."""
    if params is not None:
        model.load_state_dict(params)
    return model.to(device).eval()


def _images_on(device: torch.device, images_of=lambda chunk: chunk.images):
    """chunk → its uint8 tiles on ``device`` (staged through pinned memory
    on a CUDA device, so the copy does not wait for queued work)."""
    def on_device(chunk) -> torch.Tensor:
        images = torch.from_numpy(images_of(chunk))
        if device.type == "cpu":
            return images
        return images.pin_memory().to(device, non_blocking=True)

    return on_device


def _scored(chunks: Iterable[InferChunk], model: nn.Module, params, device: torch.device,
            dispatch_ahead: int, norm_type: str, images_of=lambda chunk: chunk.images):
    """→ ``(chunk, (logits, probs))`` on the host for each chunk."""
    model = _prepare(model, params, device)
    norm = make_recipe("none", train=False, tile_size=model.config.img_size,
                       norm_type=norm_type)
    eval_step = make_eval_step(model, preprocess_fn=norm)
    with torch.inference_mode():
        yield from eval_stream(chunks, _images_on(device, images_of), eval_step,
                               depth=dispatch_ahead)


def evaluate_slides(chunks: Iterable[InferChunk], model: nn.Module, params,
                    device: torch.device, dispatch_ahead: int = 4,
                    norm_type: str = "Ron"):
    """Slide-level validation: mean tile softmax per slide, per-patch and
    per-slide AUC. Returns ``(metrics, aggregator)``, ``({}, None)`` for an
    empty stream."""
    agg = SlideAggregator()
    for chunk, (_logits, probs) in _scored(chunks, model, params, device, dispatch_ahead,
                                           norm_type):
        agg.add_chunk(chunk, probs)
    if not agg.results:
        return {}, None
    return {"auc": agg.slide_auc(), "patch_auc": agg.patch_auc()}, agg


def evaluate_slide_table(args, model: nn.Module, params, device: torch.device,
                         table=None):
    """Slide-level validation over the test fold's slides
    (``tpuwsi/cli/train.py:1100``; ``params`` None scores ``model`` as it
    is, as the training loop does): ``--n_patches_test`` tiles a slide,
    mean softmax per slide, per-patch and per-slide AUC. A '+'-joined
    ``--target`` has one two-class head per target: an aggregator each,
    slides whose label for a head is -1 left out of it, and the mean of the
    heads' AUCs as ``auc`` and ``patch_auc``. The walk runs behind a
    ``Prefetcher`` of depth 2. Returns ``(metrics, aggregator)``, ``({},
    None)`` when nothing was scored."""
    from tpuwsi_torch.infer.slide_walker import SlideWalker
    from tpuwsi_torch.io.prefetch import Prefetcher

    table = table or infer_slide_table(args)
    walker = SlideWalker(table, tiles_per_iter=args.tiles_per_iter,
                         num_tiles=args.n_patches_test, threads=args.workers)
    feed = Prefetcher(walker.walk(), depth=2)
    try:
        return _score_table(args, _scored(feed, model, params, device, args.dispatch_ahead,
                                          norm_type=norm_bank(args)))
    finally:
        feed.close()


def _score_table(args, scored):
    """``evaluate_slide_table``'s aggregation of the scored chunks."""
    names = args.target.split("+")
    if len(names) == 1:
        agg = SlideAggregator()
        for chunk, (_logits, probs) in scored:
            agg.add_chunk(chunk, probs)
        if not agg.results:
            return {}, None
        return {"auc": agg.slide_auc(), "patch_auc": agg.patch_auc()}, agg
    aggs = [SlideAggregator() for _ in names]
    for chunk, (logits, _probs) in scored:
        logits = np.asarray(logits, dtype=np.float32)
        for t, a in enumerate(aggs):
            lab = int(np.asarray(chunk.label).ravel()[t])
            if lab < 0:
                # unknown target for this head: -1 labels would inflate the
                # rank sums of roc_auc
                continue
            lt = logits[:, 2 * t : 2 * t + 2]
            e = np.exp(lt - lt.max(axis=-1, keepdims=True))
            a.add_chunk(dataclasses.replace(chunk, label=lab), e / e.sum(axis=-1, keepdims=True))
    if not any(a.results for a in aggs):
        return {}, None
    metrics, heads = {}, []
    for name, a in zip(names, aggs):
        if not a.results:
            continue  # every slide had -1 for this head
        metrics[f"auc_{name}"] = a.slide_auc()
        metrics[f"patch_auc_{name}"] = a.patch_auc()
        heads.append(name)
    metrics["auc"] = float(np.mean([metrics[f"auc_{n}"] for n in heads]))
    metrics["patch_auc"] = float(np.mean([metrics[f"patch_auc_{n}"] for n in heads]))
    return metrics, next(a for a in aggs if a.results)


def evaluate_folder(val_ds, model: nn.Module, batch_size: int, device: torch.device,
                    dispatch_ahead: int = 2, params=None, norm_type: str = "Ron") -> dict:
    """Folder-mode validation (``tpuwsi/cli/train.py:1056``): top-1 and top-5
    accuracy and mean cross-entropy over the validation set in its order,
    and the AUC of class 1 when there are two classes; ``{}`` for an empty
    set. The batches are decoded behind a ``Prefetcher`` of depth 2."""
    from tpuwsi_torch.infer.aggregate import roc_auc
    from tpuwsi_torch.io.prefetch import Prefetcher
    from tpuwsi_torch.train.losses import cross_entropy
    from tpuwsi_torch.train.metrics import accuracy_topk

    n_correct1 = n_correct5 = n_total = 0
    loss_sum = 0.0
    all_scores, all_labels = [], []
    feed = Prefetcher(val_ds.batches(batch_size, shuffle=False, drop_last=False), depth=2)
    try:
        for batch, (logits, probs) in _scored(feed, model, params, device, dispatch_ahead,
                                              norm_type, images_of=lambda b: b["images"]):
            labels = batch["labels"]
            logits_t = torch.as_tensor(np.asarray(logits, dtype=np.float32))
            labels_t = torch.as_tensor(labels)
            n = len(labels)
            k = min(5, logits_t.shape[-1])
            n_correct1 += round(float(accuracy_topk(logits_t, labels_t, 1)) * n)
            n_correct5 += round(float(accuracy_topk(logits_t, labels_t, k)) * n)
            n_total += n
            loss_sum += float(cross_entropy(logits_t, labels_t)) * n
            if probs.shape[-1] == 2:
                all_scores.extend(probs[:, 1].tolist())
                all_labels.extend(labels.tolist())
    finally:
        feed.close()
    if n_total == 0:
        return {}
    metrics = {"top1": n_correct1 / n_total, "top5": n_correct5 / n_total,
               "loss": loss_sum / n_total}
    if all_scores:
        metrics["auc"] = roc_auc(all_scores, all_labels)
    return metrics


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
    ``generator`` on the device seeded with ``args.seed``, which ``state``
    carries too (its ``state_dict`` saves it). Model parallelism
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
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = create_dino_state(model, optimizer, dcfg, generator)
    mc = make_multicrop(ssl_multicrop_config(args, on_cuda))
    raw_step = make_dino_train_step(model, optimizer, dcfg, multicrop_fn=mc)
    return types.SimpleNamespace(
        model=model, params=model.state_dict(), dcfg=dcfg, ocfg=ocfg, optimizer=optimizer,
        multicrop=mc, raw_step=raw_step, state=state, generator=generator,
    )


def _resolve_input_geometry(args):
    """--input-size (c h w) / --in-chans / --img-size precedence: --input-size
    wins on both axes; --in-chans defaults to 3. Mutates ``args``."""
    if args.input_size is not None:
        c, h, w = args.input_size
        if h != w:
            raise SystemExit("--input-size: only square inputs supported")
        args.img_size = h
        if args.in_chans is None:
            args.in_chans = c
    if args.in_chans is None:
        args.in_chans = 3
    if args.in_chans != 3:
        if args.ssl or args.target in SURVIVAL_TARGETS or not args.data_dir:
            raise SystemExit(
                "--in-chans != 3 only applies to folder-mode supervised "
                "training (WSI tiles and the DINO multi-crop are RGB)"
            )
        if args.transform_type != "timm":
            raise SystemExit(
                "--in-chans != 3 needs --transform_type timm (the GipMed "
                "recipes are RGB: color jitter + RGB normalization banks)"
            )
    return args.img_size, args.in_chans


def _chunked_enumerate(iterable, n: int):
    """Yield (first_step_index, [up to n batches]): the grouping of
    --steps-per-dispatch. Closes a closeable source (the Prefetcher) on exit,
    also when the consumer stops early (--max-steps-per-epoch)."""
    try:
        buf, start = [], 0
        for b in iterable:
            buf.append(b)
            if len(buf) == n:
                yield start, buf
                start += n
                buf = []
        if buf:
            yield start, buf
    finally:
        close = getattr(iterable, "close", None)
        if close is not None:
            close()


def _interval_hit(i: int, j: int, n: int) -> bool:
    """True iff some step index k in [i, j] has k % n == 0."""
    if n <= 0:
        return False
    return True if i <= 0 else (j // n) > ((i - 1) // n)


def _check_ssl_mode(args) -> None:
    """The SSL modes the port runs: folder mode and WSI mode."""
    if args.knn_eval_rate and not args.data_dir:
        raise SystemExit(
            "--knn-eval-rate needs folder-mode labels (--data-dir); "
            "the WSI SSL stream is unlabeled"
        )
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel is not ported yet (ROADMAP.md, Queue 1, M7)")


def _check_extract_mode(args) -> None:
    """-ef runs a model initialised from --seed, or loaded from a supervised
    checkpoint, over the slide table."""
    if args.model_ema:
        raise NotImplementedError(
            "-ef with --model-ema (the two-forward route: probabilities from the EMA copy) "
            "is not ported yet (ROADMAP.md, Queue 1, M8)")
    if args.quantize == "int8":
        raise NotImplementedError(
            "-ef with --quantize int8 (int8 serving) is not ported yet "
            "(ROADMAP.md, Queue 1, M8)")
    if args.data_dir:
        raise NotImplementedError(
            "-ef with --data-dir (features of a folder's images) is not ported yet "
            "(ROADMAP.md, Queue 1, M3b); -ef walks the slide table")


def _jax_cli_exits(args) -> None:
    """The JAX CLI's own ``SystemExit`` refusals of the supervised setup, in
    its order (``tpuwsi/cli/train.py:270-640``), raised here before any file
    is written."""
    folder_mode = bool(args.data_dir)
    if args.aug_repeats and not folder_mode:
        raise SystemExit("--aug-repeats is a folder-mode (timm loader) "
                         "feature; WSI sampling has factor-based virtual "
                         "epochs instead")
    multi_target = "+" in args.target and not folder_mode
    if multi_target:
        if args.focal or args.bce_loss:
            raise SystemExit(
                "multi-target ('+') training uses the masked per-head CE "
                "(train_instruct.txt:3-8 patched-gather semantics); drop "
                "--focal/--bce-loss")
        if args.mixup > 0 or args.cutmix > 0 or args.cutmix_minmax:
            raise SystemExit(
                "--mixup/--cutmix need single-label targets; not supported "
                "with multi-target ('+') training")
    if args.jsd_loss:
        if args.aug_splits < 2:
            raise SystemExit("--jsd-loss needs --aug-splits > 1 (timm "
                             "asserts the same)")
        if multi_target or args.focal or args.bce_loss:
            raise SystemExit("--jsd-loss replaces the base loss; drop "
                             "--focal/--bce-loss/multi-target")
    if args.aug_splits:
        if args.aug_splits < 2:
            raise SystemExit("--aug-splits must be 0 or > 1 (timm asserts "
                             "the same)")
        if not (folder_mode and args.transform_type == "timm") or args.no_aug:
            raise SystemExit(
                "--aug-splits needs folder mode with the timm transform "
                "stack (--transform_type timm), the reference's "
                "timm_train.py loader surface; --no-aug conflicts")
        if args.mixup > 0 or args.cutmix > 0 or args.cutmix_minmax:
            raise SystemExit("--aug-splits with mixup/cutmix is not "
                             "supported; drop one of them")
        if not args.jsd_loss:
            raise SystemExit("--aug-splits needs --jsd-loss (the split-BN "
                             "variant is a documented non-goal)")


def _m3b(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, Queue 1, M3b)")


def _check_supervised_mode(args) -> None:
    """The supervised route the port runs: the named recipes, no batch
    mixing, SGD / momentum / Nesterov / AdamW under the warm-up-cosine
    schedule, global-norm clipping."""
    from tpuwsi_torch.models.registry import _CNN_PREFIXES
    from tpuwsi_torch.train.optim import make_optimizer

    _jax_cli_exits(args)
    if args.model.startswith(_CNN_PREFIXES):
        raise NotImplementedError(
            f"{args.model}: the CNN zoo is not ported yet (ROADMAP.md, Queue 1, M6)")
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel is not ported yet (ROADMAP.md, Queue 1, M7)")
    if args.transform_type == "timm":
        raise _m3b("--transform_type timm (the timm transform stack, timm_aug.py)")
    if args.mixup > 0 or args.cutmix > 0 or args.cutmix_minmax:
        raise _m3b("--mixup / --cutmix / --cutmix-minmax (batch_aug.py)")
    if args.aa:
        raise _m3b(f"--aa {args.aa} (RandAugment, AutoAugment, AugMix: batch_aug.py)")
    if args.aug_splits or args.jsd_loss or args.aug_repeats:
        raise _m3b("--aug-splits, --jsd-loss and --aug-repeats")
    if args.reprob > 0:
        raise _m3b("--reprob (random erasing, batch_aug.py)")
    # the optimizer and schedule refuse what they do not port (M3b)
    make_optimizer(supervised_optim_config(args, 1), args.batch_size)
    if args.images or args.save_images:
        raise _m3b("-im and --save-images (batch image dumps)")
    if args.log_wandb:
        raise _m3b("--log-wandb")


def _check_mode_ported(args) -> None:
    """Raise for every mode of the JAX CLI that the port does not run yet."""
    if args.ssl:
        _check_ssl_mode(args)
    elif args.target in SURVIVAL_TARGETS:
        _check_survival_mode(args)
    elif args.extract_features:
        _check_extract_mode(args)
    else:
        _check_supervised_mode(args)


def ssl_slide_table(args):
    """WSI-mode SSL's table: the training folds, REG, slides with at least
    --n_patches_train tissue tiles (``tpuwsi/cli/train.py:1707-1711``)."""
    from tpuwsi_torch.io.metadata import load_slide_table

    return load_slide_table(
        args.dataset, tile_size=args.tile_size, target_kind=args.target,
        test_fold=args.test_fold, train=True, train_type="REG",
        n_tiles=args.n_patches_train, desired_magnification=args.mag,
        data_root=args.data_root,
    )


def norm_bank(args) -> str:
    """The normalization bank of the recipes, the slide and folder
    evaluations and -ef: 'Amir' (BGR order, for the TMA cohorts' cores read
    as cv2 reads them) for a TMA dataset, else 'Ron'
    (``tpuwsi/cli/train.py:548``, ``:577``, ``:740``, ``:1209``)."""
    return "Amir" if args.dataset.startswith("TMA") else "Ron"


def infer_slide_table(args):
    """The serving table: the test fold's slides (``tpuwsi/cli/train.py:1186-1196``)."""
    from tpuwsi_torch.io.metadata import load_slide_table

    return load_slide_table(
        args.dataset, tile_size=args.tile_size, target_kind=args.target,
        test_fold=args.test_fold, train=False, train_type="Infer",
        infer_folds=[args.test_fold], desired_magnification=args.mag,
        data_root=args.data_root,
    )


def check_slides_readable(table, presaved_ok: bool = False) -> None:
    """Raise, before any file is written, for a slide this package cannot
    read: an unknown extension, or JPEG 2000 tiles (M1c, found by opening the
    slide). ``presaved_ok``: the ABCTB_TILES cohort's slides are read as
    presaved tiles."""
    from tpuwsi_torch.io.slide_readers import check_readable

    for i in range(len(table)):
        if not (presaved_ok and table.cohort_ids[i] == "ABCTB_TILES"):
            check_readable(table.slide_path(i))


def feature_model(args):
    """-ef's model and its weights: ``create_model(args.model)`` with
    --num-output, --num-classes or two classes a target, at --img-size (else
    --tile-size), with the parameters of a supervised checkpoint (--resume,
    else --initial-checkpoint or -tl: the latest step under that directory)
    or else initialised from --seed (``init_dino_weights``). → (model, its
    ``state_dict``)."""
    from tpuwsi_torch.models.registry import create_model
    from tpuwsi_torch.train.checkpoint import load_checkpoint

    n_targets = len(args.target.split("+")) if "+" in args.target else 1
    model = create_model(args.model,
                         num_classes=args.num_output or args.num_classes or 2 * n_targets,
                         img_size=args.img_size or args.tile_size)
    source = args.resume or args.initial_checkpoint or args.transfer_learning
    saved = load_checkpoint(source) if source else None
    if saved is not None:
        model.load_state_dict(saved["params"])
        logging.info("-ef: parameters of step %d from %s", int(saved["step"]), source)
    else:
        init_dino_weights(model, args.seed)
    return model, model.state_dict()


def extract_features_from_table(args, table, output_dir: str, device: torch.device):
    """-ef (``tpuwsi/cli/train.py:1176``): the table's slides walked in
    chunks of --tiles_per_iter (--num_tiles tiles a slide; --workers threads
    cut the tiles and as many decode the next slides) behind a
    ``Prefetcher`` of depth 2, one backbone forward a chunk; writes
    ``<output_dir>/features/<slide>_features.pt`` and ``inference.data``.
    --eval-steps-per-dispatch > 1 runs its chunks one after another."""
    from tpuwsi_torch.infer.slide_walker import SlideWalker
    from tpuwsi_torch.io.prefetch import Prefetcher

    model, params = feature_model(args)
    walker = SlideWalker(table, tiles_per_iter=args.tiles_per_iter, num_tiles=args.num_tiles,
                         threads=args.workers)
    feed = Prefetcher(walker.walk(), depth=2)
    try:
        return extract_features(feed, model, params, output_dir, device,
                                dispatch_ahead=args.dispatch_ahead, norm_type=norm_bank(args))
    finally:
        feed.close()


def _host_tensor(batch, key) -> torch.Tensor:
    """A batch's array under ``key`` as a contiguous CPU tensor, labels as
    int64."""
    return torch.from_numpy(
        np.ascontiguousarray(batch[key], np.int64 if key == "labels" else None))


def _pinned(batches, keys=("images", "labels")):
    """The producer's side of the copy to the card: each batch's arrays under
    ``keys`` (uint8 tiles, int64 labels, targets) in pinned host memory, so
    the copies do not wait for queued work (a copy from pageable memory waits
    for the whole stream)."""
    for batch in batches:
        yield {**batch, **{k: _host_tensor(batch, k).pin_memory() for k in keys if k in batch}}


def _on_device(batch, keys, device: torch.device) -> dict:
    """The batch's arrays under ``keys`` as tensors on ``device`` (from
    ``_pinned``'s pinned tensors on a CUDA device)."""
    if device.type == "cuda":
        return {k: batch[k].to(device, non_blocking=True) for k in keys}
    return {k: _host_tensor(batch, k) for k in keys}


def train_ssl(args, output_dir: str, device: Optional[torch.device] = None,
              pindex: int = 0, pcount: int = 1, table=None):
    """DINO student/teacher SSL loop (``tpuwsi/cli/train.py:1683``) over
    ``args.data_dir`` or, without one, over the tissue tiles of ``table``
    (default ``ssl_slide_table(args)``): per epoch one shuffle from ``seed +
    epoch``, batches decoded on ``--workers`` threads (a folder's files, or
    the ``WSITileSampler``'s slides and tile cuts) behind a ``Prefetcher``,
    the steps of each --steps-per-dispatch chunk one after another, a host
    read of the loss every --dispatch-ahead steps (the bound on run-ahead)
    and every --log-interval steps (logged), then the kNN probe every
    --knn-eval-rate epochs (folder mode), a checkpoint ranked by the loss and
    a row of ``summary.csv`` when the probe is on. ``main`` has checked the
    mode and passes this host's index and count. Returns the state.
    """
    from tpuwsi_torch.core.device import require_cuda
    from tpuwsi_torch.io.folder import ImageFolderDataset
    from tpuwsi_torch.io.prefetch import Prefetcher
    from tpuwsi_torch.io.wsi import WSITileSampler
    from tpuwsi_torch.train.checkpoint import CheckpointManager
    from tpuwsi_torch.utils.runlog import update_summary

    if device is None:
        device = require_cuda()
    sampler = None
    if args.data_dir:
        ds = ImageFolderDataset(args.data_dir)
        n_items = len(ds)

        def epoch_batches(rng):
            return ds.batches(args.batch_size, rng=rng, process_index=pindex,
                              process_count=pcount, workers=args.workers)
    else:
        ds = None
        sampler = WSITileSampler(table or ssl_slide_table(args), n_tiles=args.n_patches_train,
                                 bag_size=1, num_threads=args.workers, print_timing=args.time)
        n_items = len(sampler)

        def epoch_batches(rng):
            return sampler.batches(rng, args.batch_size, process_index=pindex,
                                   process_count=pcount)
    # per-host steps: each host sees a 1/pcount strided slice
    steps_per_epoch = max(n_items // (args.batch_size * pcount), 1)
    global_batch = args.batch_size * pcount
    bundle = ssl_step_bundle(args, steps_per_epoch, global_batch, device)
    state = bundle.state
    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"), metric_name="loss",
                             mode="min")
    knn_probe = _make_ssl_knn_probe(args, bundle, ds, device) if args.knn_eval_rate else None
    on_cuda = device.type == "cuda"
    spd = max(args.steps_per_dispatch, 1)
    for epoch in range(args.epochs):
        # the same seed on every host: the strided slices come from one shuffle
        epoch_rng = np.random.default_rng(args.seed + epoch)
        batches = epoch_batches(epoch_rng)
        feed = Prefetcher(_pinned(batches) if on_cuda else batches, depth=3)
        metrics, t0 = {}, time.perf_counter()
        for i, chunk in _chunked_enumerate(feed, spd):
            if args.max_steps_per_epoch:
                if i >= args.max_steps_per_epoch:
                    break
                chunk = chunk[: args.max_steps_per_epoch - i]
            j = i + len(chunk) - 1
            for b in chunk:
                state, metrics = bundle.raw_step(state, _on_device(b, ("images",), device),
                                                 bundle.generator)
            if args.dispatch_ahead and _interval_hit(i, j, args.dispatch_ahead):
                float(metrics["loss"])  # bound device run-ahead
            if args.log_interval and _interval_hit(i, j, args.log_interval):
                logging.info("ssl epoch %d step %d loss %.4f momentum %.5f",
                             epoch, j, float(metrics["loss"]), float(metrics["ema_momentum"]))
        epoch_metrics = {"loss": float(metrics.get("loss", 0.0))}
        loop_s = time.perf_counter() - t0
        logging.info("ssl epoch %d: loop %.3f s, waiting on the data %.3f s (%.1f%%)",
                     epoch, loop_s, feed.wait_s, 100.0 * feed.wait_s / max(loop_s, 1e-9))
        if args.time and sampler is not None:  # -time: the sampler's stage times
            logging.info("ssl epoch %d time dict: %s", epoch, sampler.stage_timer.time_dict())
        if knn_probe and (epoch + 1) % args.knn_eval_rate == 0:
            epoch_metrics["knn_acc"] = knn_probe(state)
            logging.info("ssl epoch %d knn@20 acc %.4f", epoch, epoch_metrics["knn_acc"])
        ckpt.save(int(state.step), state, epoch_metrics)
        if knn_probe:
            update_summary(
                epoch, {"loss": epoch_metrics["loss"]},
                {"knn_acc": epoch_metrics.get("knn_acc", float("nan"))},
                os.path.join(output_dir, "summary.csv"),
                write_header=epoch == 0,
            )
    ckpt.close()
    if sampler is not None:
        sampler.close()
    return state


def supervised_slide_table(args, reshuffle_rng=None):
    """WSI mode's training table (``tpuwsi/cli/train.py:290-316``): the
    training folds, REG, slides with at least --n_patches_train tissue
    tiles; with --supervised the test fold's slides, 80% of them drawn from
    --seed. ``reshuffle_rng``: --RAM_saver's new quarter of the slides
    (every 100 epochs, ``:787-800``)."""
    from tpuwsi_torch.io.metadata import load_slide_table, split_table

    common = dict(tile_size=args.tile_size, target_kind=args.target,
                  test_fold=args.test_fold, train_type="REG", n_tiles=args.n_patches_train,
                  desired_magnification=args.mag, dx=args.dx, er_eq_pr=args.er_eq_pr,
                  data_root=args.data_root)
    if reshuffle_rng is not None:
        return load_slide_table(args.dataset, train=True, ram_saver=True, rng=reshuffle_rng,
                                **common)
    table = load_slide_table(
        args.dataset, train=not args.supervised,
        infer_folds=[args.test_fold] if args.supervised else (None,),
        ram_saver=args.RAM_saver, balanced_dataset=args.balanced_dataset,
        slide_per_block=args.slide_per_block, **common)
    if args.supervised:
        table, _ = split_table(table, 0.8, np.random.default_rng(args.seed))
    return table


def supervised_model(args, num_classes: int, on_cuda: bool) -> nn.Module:
    """The classifier ``main`` trains, built on the CPU; on the card its
    attention forward saves the probabilities that its backward reads
    (``tpuwsi/cli/train.py:320-337``)."""
    from tpuwsi_torch.models.registry import create_model

    return create_model(
        args.model, num_classes=num_classes, drop_rate=args.drop,
        drop_path_rate=args.drop_path or 0.0, img_size=args.img_size or args.tile_size,
        grad_checkpointing=args.grad_checkpointing, bn_momentum=args.bn_momentum,
        bn_eps=args.bn_eps, attn_save_probs=on_cuda)


def supervised_optim_config(args, steps_per_epoch: int, offset: int = 0):
    """``OptimConfig`` from the arguments (``tpuwsi/cli/train.py:356-396``):
    the linear LR scaling rule for SGD, the square root for adaptive
    optimizers; ``offset`` advances the schedule (--start-epoch on a fresh
    run, --no-resume-opt)."""
    from tpuwsi_torch.train.optim import OptimConfig

    if not offset and args.start_epoch and not args.resume:
        offset = args.start_epoch * steps_per_epoch
    return OptimConfig(
        opt=args.opt, lr=args.lr, base_lr=args.lr_base, lr_base_size=args.lr_base_size,
        lr_base_scale=args.lr_base_scale
        or ("sqrt" if any(o in args.opt for o in ("ada", "lamb")) else "linear"),
        momentum=args.momentum, weight_decay=args.weight_decay, clip_grad=args.clip_grad,
        clip_mode=args.clip_mode, sched=args.sched, epochs=args.epochs,
        warmup_epochs=args.warmup_epochs, warmup_lr=args.warmup_lr, min_lr=args.min_lr,
        cooldown_epochs=args.cooldown_epochs, steps_per_epoch=steps_per_epoch,
        decay_epochs=args.decay_epochs, decay_rate=args.decay_rate,
        decay_milestones=tuple(args.decay_milestones) if args.decay_milestones else None,
        patience_epochs=args.patience_epochs, lr_cycle_mul=args.lr_cycle_mul,
        lr_cycle_decay=args.lr_cycle_decay, lr_cycle_limit=args.lr_cycle_limit,
        lr_k_decay=args.lr_k_decay, warmup_prefix=args.warmup_prefix,
        lr_noise=tuple(args.lr_noise) if args.lr_noise else None,
        lr_noise_pct=args.lr_noise_pct, lr_noise_std=args.lr_noise_std, seed=args.seed,
        layer_decay=args.layer_decay, schedule_offset_steps=offset,
        **_opt_extra_kwargs(args))


def supervised_loss(args, multi_target: bool):
    """``loss_fn(logits, labels)`` as ``main`` picks it
    (``tpuwsi/cli/train.py:499-518``)."""
    from tpuwsi_torch.train import losses

    if multi_target:
        return lambda l, y: losses.multi_target_cross_entropy(l, y, args.smoothing)
    if args.focal:
        return losses.focal_loss
    if args.bce_loss:
        return lambda l, y: losses.binary_cross_entropy(
            l, y, args.smoothing, target_thresh=args.bce_target_thresh)
    return lambda l, y: losses.cross_entropy(l, y, args.smoothing)


def _supervised_state(args, model, spe: int, global_batch: int, device, offset: int = 0):
    """→ (optimizer, schedule, state): --no-grad leaves the head alone to
    train; the generator on ``device`` is seeded with --seed."""
    from tpuwsi_torch.train.optim import freeze_non_head, make_optimizer
    from tpuwsi_torch.train.state import create_train_state

    optimizer, schedule = make_optimizer(supervised_optim_config(args, spe, offset),
                                         global_batch)
    if args.no_grad:
        freeze_non_head(model)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    return optimizer, schedule, create_train_state(model, optimizer, ema=args.model_ema,
                                                   generator=generator)


def train_supervised(args, output_dir: str, ledger, exp: dict,
                     device: Optional[torch.device] = None, pindex: int = 0, pcount: int = 1,
                     table=None, eval_table=None):
    """Supervised tile classification (``tpuwsi/cli/train.py:270-950``):
    batches of --batch-size raw tiles from the ``WSITileSampler`` over
    ``table`` (default ``supervised_slide_table(args)``) or from
    --data-dir, the named recipe on the device, the step of
    ``train.supervised.make_train_step``; per epoch one shuffle from ``seed
    + epoch`` behind a ``Prefetcher``, the steps of each --steps-per-dispatch
    chunk one after another, host reads of the step's metrics every
    --dispatch-ahead and --log-interval steps, recovery checkpoints every
    --recovery-interval steps, then every --eval_rate epochs (and the last)
    the evaluation of the test fold's slides (``eval_table``, default
    ``infer_slide_table(args)``) or of the folder's validation split, on
    the EMA copy under --model-ema, a best-K checkpoint ranked by
    --eval-metric, a row of ``summary.csv`` and the ledger. Ctrl-C ends the
    loop and keeps what was saved. Returns the state."""
    from tpuwsi_torch.core.device import require_cuda
    from tpuwsi_torch.io.prefetch import Prefetcher
    from tpuwsi_torch.io.wsi import WSITileSampler
    from tpuwsi_torch.train.checkpoint import CheckpointManager, load_checkpoint
    from tpuwsi_torch.utils.runlog import update_summary
    from tpuwsi_torch.utils.tracking import Tracker

    if device is None:
        device = require_cuda()
    on_cuda = device.type == "cuda"
    folder_mode = bool(args.data_dir)
    sampler = val_ds = None
    if folder_mode:
        from tpuwsi_torch.io.folder import load_folder_datasets

        train_ds, val_ds = load_folder_datasets(
            args.data_dir, image_size=args.img_size, train_split=args.train_split,
            class_map=args.class_map or None, channels=args.in_chans)
        if val_ds is None and args.val_split > 0 and len(train_ds) >= 10:
            train_ds, val_ds = train_ds.split(1.0 - args.val_split,
                                              np.random.default_rng(args.seed))
        num_classes = args.num_output or args.num_classes or train_ds.num_classes
        n_items = len(train_ds)
    else:
        sampler = WSITileSampler(
            table or supervised_slide_table(args), n_tiles=args.n_patches_train, bag_size=1,
            num_threads=args.workers, balanced_sampling=args.balanced_sampling,
            loan=args.loan, print_timing=args.time)
        n_targets = len(args.target.split("+")) if "+" in args.target else 1
        num_classes = args.num_output or args.num_classes or 2 * n_targets
        n_items = len(sampler)
    # per-host steps: each host takes a 1/pcount strided slice
    spe = max(n_items // (args.batch_size * pcount), 1)
    global_batch = args.batch_size * pcount

    model = supervised_model(args, num_classes, on_cuda)
    init_dino_weights(model, args.seed)
    model = model.to(device)
    optimizer, schedule, state = _supervised_state(args, model, spe, global_batch, device)
    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"),
                             max_history=args.checkpoint_hist, metric_name=args.eval_metric)
    # recovery checkpoints keep the latest two: under the best-K manager
    # they would rank worst and be collected first
    ckpt_rec = (CheckpointManager(os.path.join(output_dir, "checkpoints", "recovery"),
                                  max_history=2, rank_by_metric=False)
                if args.recovery_interval else None)
    sched_count_offset = 0  # the schedule's count = step - this
    if args.resume:
        saved = load_checkpoint(args.resume)
        if saved is not None and args.no_resume_opt:
            # weights, EMA, step and generator come back; the optimizer
            # starts afresh on a schedule advanced to the saved step
            sched_count_offset = int(saved["step"])
            optimizer, schedule, state = _supervised_state(args, model, spe, global_batch,
                                                           device, offset=sched_count_offset)
            state.load_state_dict(saved, opt_state=False)
        elif saved is not None:
            state.load_state_dict(saved)
        if saved is not None:
            logging.info("resumed from %s at step %d", args.resume, state.step)
    warm = args.initial_checkpoint or args.transfer_learning
    if warm and not args.resume:
        # params only; the EMA copy stays the initial one, as in the reference
        donor = load_checkpoint(warm)
        if donor is not None:
            model.load_state_dict(donor["params"])
            logging.info("warm-started params from %s", warm)

    aug = make_recipe(args.transform_type, train=not args.no_aug,
                      tile_size=args.img_size or args.tile_size, color_param=args.c_param,
                      norm_type=norm_bank(args))
    step_fn = make_train_step(model, optimizer, augment_fn=aug,
                              loss_fn=supervised_loss(args, "+" in args.target and not folder_mode),
                              ema_decay=args.model_ema_decay if args.model_ema else None)
    eval_model = eval_module(state, args.model_ema)
    if not folder_mode and eval_table is None:
        eval_table = infer_slide_table(args)
    tracker = Tracker(output_dir, use_wandb=args.log_wandb)
    summary_path = os.path.join(output_dir, "summary.csv")
    start_epoch = args.start_epoch
    if start_epoch is None:
        start_epoch = state.step // max(spe, 1)
    spd = max(args.steps_per_dispatch, 1)
    try:
        for epoch in range(start_epoch, args.epochs):
            # the same seed on every host: the strided slices come from one shuffle
            epoch_rng = np.random.default_rng(args.seed + epoch)
            if sampler is not None and args.RAM_saver and epoch > 0 and epoch % 100 == 0:
                sampler.close()
                sampler = WSITileSampler(
                    supervised_slide_table(args, reshuffle_rng=epoch_rng),
                    n_tiles=args.n_patches_train, bag_size=1, num_threads=args.workers,
                    balanced_sampling=args.balanced_sampling)
            if folder_mode:
                batches = train_ds.batches(args.batch_size, rng=epoch_rng, process_index=pindex,
                                           process_count=pcount, workers=args.workers)
            else:
                batches = sampler.batches(epoch_rng, args.batch_size, process_index=pindex,
                                          process_count=pcount)
            feed = Prefetcher(_pinned(batches) if on_cuda else batches, depth=3)
            metrics, t0 = {}, time.perf_counter()
            for i, chunk in _chunked_enumerate(feed, spd):
                if args.max_steps_per_epoch:
                    if i >= args.max_steps_per_epoch:
                        break
                    chunk = chunk[: args.max_steps_per_epoch - i]
                j = i + len(chunk) - 1
                for b in chunk:
                    state, metrics = step_fn(state, _on_device(b, ("images", "labels"), device),
                                             state.generator)
                if args.dispatch_ahead and _interval_hit(i, j, args.dispatch_ahead):
                    float(metrics["loss"])  # bound device run-ahead
                if args.log_interval and _interval_hit(i, j, args.log_interval):
                    m = {k: float(v) for k, v in metrics.items()}
                    rate = (j + 1) * args.batch_size / (time.perf_counter() - t0)
                    logging.info("epoch %d step %d loss %.4f auc %.3f (%.1f tiles/s)",
                                 epoch, j, m.get("loss", 0), m.get("auc", 0.5), rate)
                    tracker.log({**m, "rate": rate}, step=state.step)
                if ckpt_rec is not None and _interval_hit(max(i, 1), j,
                                                          max(args.recovery_interval, 1)):
                    ckpt_rec.save(state.step, state, {"recovery": 1.0})
            loop_s = time.perf_counter() - t0
            logging.info("epoch %d: loop %.3f s, waiting on the data %.3f s (%.1f%%)",
                         epoch, loop_s, feed.wait_s, 100.0 * feed.wait_s / max(loop_s, 1e-9))
            # in key order, as the reference's jitted step hands its dict back
            train_metrics = {k: float(metrics[k]) for k in sorted(metrics)}
            train_metrics["lr"] = float(schedule(state.step - sched_count_offset))
            if args.time and sampler is not None:  # -time: the sampler's stage times
                td = sampler.stage_timer.time_dict()
                logging.info("epoch %d time dict: %s", epoch, td)
                tracker.log({"extract_tile_sec": td["Average time to extract a tile"]},
                            step=state.step)

            eval_metrics = {}
            if epoch % args.eval_rate == 0 or epoch == args.epochs - 1:
                if folder_mode and val_ds is not None and len(val_ds) > 0:
                    eval_metrics = evaluate_folder(
                        val_ds, eval_model, args.validation_batch_size or args.batch_size,
                        device, dispatch_ahead=args.dispatch_ahead, norm_type=norm_bank(args))
                    logging.info("epoch %d folder eval: %s", epoch, eval_metrics)
                    tracker.log({f"eval_{k}": v for k, v in eval_metrics.items()},
                                step=state.step)
                elif not folder_mode:
                    eval_metrics, agg = evaluate_slide_table(args, eval_model, None, device,
                                                             table=eval_table)
                    logging.info("epoch %d eval: %s", epoch, eval_metrics)
                    if agg is not None and agg.results:
                        tracker.log_roc_pr([r.slide_score for r in agg.results],
                                           [r.label for r in agg.results],
                                           prefix="eval_slide_", step=state.step)
                        if args.bootstrap:
                            bmean, bstd = agg.bootstrap_slide_auc()
                            eval_metrics["auc_bootstrap_mean"] = bmean
                            eval_metrics["auc_bootstrap_std"] = bstd
                    tracker.log({f"eval_{k}": v for k, v in eval_metrics.items()},
                                step=state.step)
            ckpt.save(state.step, state, eval_metrics or {args.eval_metric: 0.0})
            update_summary(epoch, train_metrics, eval_metrics, summary_path)
            ledger.update(exp["Experiment"], **{"Last Epoch": epoch})
            if eval_metrics.get("auc") is not None:
                ledger.update(exp["Experiment"], **{"TestSet Mean AUC": eval_metrics["auc"]})
    except KeyboardInterrupt:
        logging.info("KeyboardInterrupt — finishing gracefully")
    ckpt.close()
    if ckpt_rec is not None:
        ckpt_rec.close()
    tracker.finish()
    if sampler is not None:
        sampler.close()
    return state


def survival_slide_tables(args):
    """Survival training's two tables (``tpuwsi/cli/train.py:1368-1377``,
    ``:1468-1473``): the training folds (REG, slides with at least
    --n_patches_train tissue tiles, censor-balanced under
    --balanced_dataset) and the test fold's slides. → (train, eval)."""
    from tpuwsi_torch.io.survival import load_survival_slide_table

    common = dict(tile_size=args.tile_size, test_fold=args.test_fold,
                  desired_magnification=args.mag, data_root=args.data_root)
    train = load_survival_slide_table(args.dataset, train=True, train_type="REG",
                                      n_tiles=args.n_patches_train,
                                      censor_balance=args.balanced_dataset, **common)
    infer = load_survival_slide_table(args.dataset, train=False, train_type="Infer",
                                      infer_folds=[args.test_fold], bag_size=0, **common)
    return train, infer


def survival_optim_config(args, steps_per_epoch: int):
    """The ``OptimConfig`` of survival training (``tpuwsi/cli/train.py:
    1408-1420``): the fields the JAX loop passes, the linear LR scaling rule
    for every optimizer."""
    from tpuwsi_torch.train.optim import OptimConfig

    return OptimConfig(
        opt=args.opt, lr=args.lr, base_lr=args.lr_base, lr_base_size=args.lr_base_size,
        momentum=args.momentum, weight_decay=args.weight_decay, clip_grad=args.clip_grad,
        clip_mode=args.clip_mode, sched=args.sched, epochs=args.epochs,
        warmup_epochs=args.warmup_epochs, warmup_lr=args.warmup_lr, min_lr=args.min_lr,
        steps_per_epoch=steps_per_epoch, decay_epochs=args.decay_epochs,
        decay_rate=args.decay_rate, layer_decay=args.layer_decay, **_opt_extra_kwargs(args))


def _check_survival_mode(args) -> None:
    """The survival route the port runs: a ViT, the named recipes, SGD /
    momentum / Nesterov / AdamW under the warm-up-cosine schedule,
    global-norm clipping. The options the JAX loop does not read (mixing,
    --model-ema, --log-wandb, ...) are ignored, as there."""
    import copy

    from tpuwsi_torch.models.registry import _CNN_PREFIXES
    from tpuwsi_torch.train.optim import make_optimizer

    _resolve_input_geometry(copy.copy(args))  # the JAX CLI's own exits come first
    if args.model.startswith(_CNN_PREFIXES):
        raise NotImplementedError(
            f"{args.model}: the CNN zoo is not ported yet (ROADMAP.md, Queue 1, M6)")
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel is not ported yet (ROADMAP.md, Queue 1, M7)")
    if args.transform_type == "timm":
        raise _m3b("--transform_type timm (the timm transform stack, timm_aug.py)")
    # the optimizer and schedule refuse what they do not port (M3b)
    make_optimizer(survival_optim_config(args, 1), args.batch_size)


def train_survival(args, output_dir: str, ledger, exp: dict,
                   device: Optional[torch.device] = None, pindex: int = 0, pcount: int = 1,
                   table=None, eval_table=None):
    """Survival training (``tpuwsi/cli/train.py:1329``): ``-tar
    Survival_Time`` trains Cox risk regression on a one-output head,
    ``Survival_Binary`` the masked cross-entropy of the 5-year status on a
    two-output head (``train.survival.make_survival_train_step``), over
    batches of --batch-size raw tiles of ``table`` (default: the training
    folds of ``survival_slide_tables``) with the recipe on the device and the
    "Ron" bank. Per epoch one shuffle from ``seed + epoch`` behind a
    ``Prefetcher``, the steps of each --steps-per-dispatch chunk one after
    another, host reads every --dispatch-ahead and --log-interval steps,
    recovery checkpoints every --recovery-interval steps; every --eval_rate
    epochs (and the last) the test fold's slides (``eval_table``) are walked
    by ``SurvivalSlideWalker`` and scored (the risk is the Cox output, or
    the margin of logit 0 over logit 1), giving the slide C-index and the
    binary AUC; then a best-K checkpoint ranked by ``c_index`` (Cox) or
    ``auc`` (binary), a row of ``summary.csv`` and the ledger's "Last Epoch".
    The epochs run from 0 also after --resume, as in the JAX loop. Returns
    the state."""
    from tpuwsi_torch.core.device import require_cuda
    from tpuwsi_torch.infer.survival_walker import SurvivalAggregator, SurvivalSlideWalker
    from tpuwsi_torch.io.prefetch import Prefetcher
    from tpuwsi_torch.io.survival import survival_batches
    from tpuwsi_torch.io.wsi import WSITileSampler
    from tpuwsi_torch.train.checkpoint import CheckpointManager, load_checkpoint
    from tpuwsi_torch.train.optim import freeze_non_head, make_optimizer
    from tpuwsi_torch.train.state import create_train_state
    from tpuwsi_torch.train.survival import make_survival_train_step
    from tpuwsi_torch.utils.runlog import update_summary

    if device is None:
        device = require_cuda()
    on_cuda = device.type == "cuda"
    mode = "cox" if args.target == "Survival_Time" else "binary"
    if table is None or eval_table is None:
        table, eval_table = survival_slide_tables(args)
    sampler = WSITileSampler(table, n_tiles=args.n_patches_train, bag_size=1,
                             num_threads=args.workers, print_timing=args.time)
    spe = max(len(sampler) // (args.batch_size * pcount), 1)
    img_size = args.img_size or args.tile_size

    model = supervised_model(args, 1 if mode == "cox" else 2, on_cuda)
    init_dino_weights(model, args.seed)
    model = model.to(device)
    optimizer, _ = make_optimizer(survival_optim_config(args, spe), args.batch_size * pcount)
    if args.no_grad:
        freeze_non_head(model)
    state = create_train_state(model, optimizer,
                               generator=torch.Generator(device=device).manual_seed(args.seed))
    metric_name = "c_index" if mode == "cox" else "auc"
    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"),
                             max_history=args.checkpoint_hist, metric_name=metric_name)
    ckpt_rec = (CheckpointManager(os.path.join(output_dir, "checkpoints", "recovery"),
                                  max_history=2, rank_by_metric=False)
                if args.recovery_interval else None)
    if args.resume:
        saved = load_checkpoint(args.resume)
        if saved is not None:
            state.load_state_dict(saved)
            logging.info("resumed from %s at step %d", args.resume, state.step)

    aug = make_recipe(args.transform_type, train=True, tile_size=img_size,
                      color_param=args.c_param, norm_type="Ron")
    step_fn = make_survival_train_step(model, optimizer, mode=mode, augment_fn=aug)
    eval_norm = make_recipe(args.transform_type, train=False, tile_size=img_size,
                            norm_type="Ron")

    def risk_fn(images):
        out = model(eval_norm(images))
        if mode == "cox":
            return out[:, 0] if out.dim() > 1 else out
        return out[:, 0] - out[:, 1]  # the margin toward "not survived"

    walker = SurvivalSlideWalker(eval_table, tiles_per_iter=args.tiles_per_iter,
                                 num_tiles=args.n_patches_test, threads=args.workers)
    summary_path = os.path.join(output_dir, "summary.csv")
    keys = ("images", "binary_targets", "time_targets", "censored")
    spd = max(args.steps_per_dispatch, 1)
    for epoch in range(args.epochs):
        epoch_rng = np.random.default_rng(args.seed + epoch)
        batches = survival_batches(sampler, epoch_rng, args.batch_size,
                                   process_index=pindex, process_count=pcount)
        feed = Prefetcher(_pinned(batches, keys) if on_cuda else batches, depth=3)
        metrics, t0 = {}, time.perf_counter()
        for i, chunk in _chunked_enumerate(feed, spd):
            if args.max_steps_per_epoch:
                if i >= args.max_steps_per_epoch:
                    break
                chunk = chunk[: args.max_steps_per_epoch - i]
            j = i + len(chunk) - 1
            for b in chunk:
                state, metrics = step_fn(state, _on_device(b, keys, device), state.generator)
            if args.dispatch_ahead and _interval_hit(i, j, args.dispatch_ahead):
                float(metrics["loss"])  # bound device run-ahead
            if args.log_interval and _interval_hit(i, j, args.log_interval):
                m = {k: float(v) for k, v in metrics.items()}
                logging.info("survival(%s) epoch %d step %d loss %.4f %s %.3f", mode, epoch, j,
                             m.get("loss", 0.0), metric_name, m.get(metric_name, 0.5))
            if ckpt_rec is not None and _interval_hit(max(i, 1), j,
                                                      max(args.recovery_interval, 1)):
                ckpt_rec.save(state.step, state, {"recovery": 1.0})
        loop_s = time.perf_counter() - t0
        logging.info("survival epoch %d: loop %.3f s, waiting on the data %.3f s (%.1f%%)",
                     epoch, loop_s, feed.wait_s, 100.0 * feed.wait_s / max(loop_s, 1e-9))
        # in key order, as the reference's jitted step hands its dict back
        train_metrics = {k: float(metrics[k]) for k in sorted(metrics)}

        eval_metrics = {}
        if epoch % args.eval_rate == 0 or epoch == args.epochs - 1:
            agg = SurvivalAggregator()
            walk = Prefetcher(walker.walk(), depth=2)
            try:
                with torch.inference_mode():
                    for chunk, risks in eval_stream(walk, _images_on(device), risk_fn,
                                                    depth=args.dispatch_ahead):
                        agg.add_chunk(chunk, risks)
            finally:
                walk.close()
            if agg.results:
                eval_metrics = {"c_index": agg.slide_c_index(), "auc": agg.slide_binary_auc()}
                logging.info("survival epoch %d eval: %s", epoch, eval_metrics)
        ckpt.save(state.step, state, eval_metrics or {metric_name: 0.0})
        update_summary(epoch, train_metrics, eval_metrics, summary_path)
        ledger.update(exp["Experiment"], **{"Last Epoch": epoch})
    ckpt.close()
    if ckpt_rec is not None:
        ckpt_rec.close()
    sampler.close()
    return state


def _make_ssl_knn_probe(args, bundle, ds, device: torch.device):
    """kNN probe (k = 20) over the teacher backbone's cls features
    (``tpuwsi/cli/train.py:1801``): every fifth image is a query, the rest
    the bank; each image centre-cropped to --dino-global-size (images
    smaller than that resized up with PIL's bicubic), normalised with the
    "Ron" bank. ``num_classes`` is the dataset's."""
    from tpuwsi_torch.io.image import resize_bicubic
    from tpuwsi_torch.preprocess.normalize import normalize
    from tpuwsi_torch.ssl_dino.knn import knn_accuracy

    idx = np.arange(len(ds))
    te = idx[::5]
    tr = np.setdiff1d(idx, te)
    labels = torch.as_tensor([ds.samples[i][1] for i in idx], dtype=torch.int64)
    g = args.dino_global_size

    def _crop(img):
        h, w = img.shape[:2]
        if h < g or w < g:
            return resize_bicubic(img, g)
        y0, x0 = (h - g) // 2, (w - g) // 2
        return img[y0:y0 + g, x0:x0 + g]

    crops = np.stack([_crop(ds.load(int(i))) for i in idx])

    def probe(state) -> float:
        backbone = state.teacher.backbone
        b = max(args.batch_size, 1)
        feats = []
        with torch.no_grad():
            for i in range(0, len(crops), b):
                x = torch.from_numpy(crops[i:i + b]).to(device)
                x = normalize(x.to(torch.float32) / 255.0, "Ron")
                feats.append(backbone(x, deterministic=True).float().cpu())
        feats = torch.cat(feats)
        tr_t, te_t = torch.from_numpy(tr), torch.from_numpy(te)
        return knn_accuracy(feats[tr_t], labels[tr_t], feats[te_t], labels[te_t],
                            k=min(20, len(tr)), num_classes=ds.num_classes)

    return probe


def main(argv=None, default_overrides=None, device: Optional[torch.device] = None):
    """The JAX CLI's ``main`` for supervised training, --ssl, survival and
    -ef: the refusals, the slide tables where the mode walks them (checked
    for formats this package reads), the run log, the experiment ledger and
    output directory, then ``train_supervised``, ``train_ssl``,
    ``train_survival`` or ``extract_features_from_table``. ``device`` None means the CUDA device,
    and raises where there is none."""
    from tpuwsi_torch.cli.args import parse_args
    from tpuwsi_torch.core.device import require_cuda
    from tpuwsi_torch.core.distributed import initialize_multihost
    from tpuwsi_torch.utils.ledger import ExperimentLedger
    from tpuwsi_torch.utils.runlog import start_log

    args = parse_args(argv, default_overrides=default_overrides)
    if args.pretrained:
        raise SystemExit(
            "--pretrained downloads from the timm hub, which this "
            "environment cannot reach. Convert torch weights offline with "
            "tpuwsi.models.convert (ViT + ResNet-50-trunc, golden-tested) "
            "and pass them via --initial-checkpoint."
        )
    if args.drop_connect is not None:
        raise SystemExit(
            "--drop-connect is timm's deprecated alias — pass --drop-path "
            "(ViT layer-drop / EfficientNet per-block stochastic depth)."
        )
    if getattr(args, "model_parallel", 1) > 1 and not args.model.startswith("vit_"):
        raise SystemExit(
            "--model-parallel covers the ViT family; CNN classifiers "
            f"({args.model}) run data-parallel — drop --model-parallel."
        )
    _check_mode_ported(args)
    if device is None:
        device = require_cuda()
    pindex, pcount = initialize_multihost()
    _resolve_input_geometry(args)
    table = eval_table = None
    if args.ssl and not args.data_dir:
        table = ssl_slide_table(args)
        check_slides_readable(table, presaved_ok=True)
    elif not args.ssl and args.target in SURVIVAL_TARGETS:
        table, eval_table = survival_slide_tables(args)
        check_slides_readable(table, presaved_ok=True)
        check_slides_readable(eval_table)
    elif args.extract_features:
        table = infer_slide_table(args)
        check_slides_readable(table)
    elif not args.ssl and not args.data_dir:
        table, eval_table = supervised_slide_table(args), infer_slide_table(args)
        check_slides_readable(table, presaved_ok=True)
        check_slides_readable(eval_table)
    start_log(args, to_file=bool(args.output), output_dir=args.output or None)

    ledger = ExperimentLedger(args.output or "runs")
    exp = ledger.create(
        args.target,
        test_fold=args.test_fold,
        name=args.experiment or None,
        subname=args.subexperiment or None,
        DataSet=args.dataset,
        Model=args.model,
        Transformations=args.transform_type,
        **{"Tile Size": args.tile_size, "Learning Rate": args.lr or args.lr_base,
           "Weight Decay": args.weight_decay,
           "Desired Slide Magnification": args.mag},
    )
    if args.ssl:
        return train_ssl(args, exp["Location"], device, pindex, pcount, table)
    if args.target in SURVIVAL_TARGETS:
        return train_survival(args, exp["Location"], ledger, exp, device, pindex, pcount, table,
                              eval_table)
    if args.extract_features:
        return extract_features_from_table(args, table, exp["Location"], device)
    return train_supervised(args, exp["Location"], ledger, exp, device, pindex, pcount, table,
                            eval_table)


if __name__ == "__main__":
    main()
