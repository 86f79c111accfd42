"""Training entry point: ``python -m tpuwsi_torch.cli.train --ssl --data-dir <folder> ...``
(``tpuwsi/cli/train.py``).

``main`` takes the JAX CLI's arguments and runs the DINO SSL loop
(``train_ssl``) over a folder of images: the step that ``ssl_step_bundle``
assembles, the shared per-epoch shuffle, checkpoints, the kNN probe,
``log.txt``, ``run_data.jsonl`` and ``summary.csv``. Every other mode raises
``NotImplementedError`` naming its ROADMAP.md item. There is no console
script: ``pyproject.toml``'s scripts name the JAX package's entry points.

The serving entry points (``evaluate_slides``, ``extract_features``) take
the stream of padded ``InferChunk``s in place of the slide table that the
JAX CLI walks. ``params`` is the port's ``state_dict`` (for example from
``models.convert.params_from_flax``); it is loaded into ``model``, which is
moved to ``device`` and put in eval mode.

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
        survival = args.target in ("Survival_Time", "Survival_Binary")
        if args.ssl or survival or not args.data_dir:
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
    """The SSL modes the port runs: folder mode; WSI mode waits for M1."""
    if args.knn_eval_rate and not args.data_dir:
        raise SystemExit(
            "--knn-eval-rate needs folder-mode labels (--data-dir); "
            "the WSI SSL stream is unlabeled"
        )
    if not args.data_dir:
        raise NotImplementedError(
            "WSI-mode SSL (the slide table and WSITileSampler) is not ported yet "
            "(ROADMAP.md, Queue 1, M1); pass --data-dir with a folder of image tiles")
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel is not ported yet (ROADMAP.md, Queue 1, M7)")


def _check_mode_ported(args) -> None:
    """Raise for every mode of the JAX CLI that the port does not run yet."""
    if args.ssl:
        _check_ssl_mode(args)
    elif args.target in ("Survival_Time", "Survival_Binary"):
        raise NotImplementedError(
            f"--target {args.target} (survival training) is not ported yet "
            "(ROADMAP.md, Queue 1, M5)")
    elif args.extract_features:
        raise NotImplementedError(
            "-ef (feature extraction over the slide table) is not ported yet: the slide "
            "walker is ROADMAP.md, Queue 1, M1 (cli.train.extract_features takes an "
            "InferChunk stream)")
    else:
        raise NotImplementedError(
            "supervised training and slide evaluation are not ported yet "
            "(ROADMAP.md, Queue 1, M3; the slide tables M1); --ssl runs")


def _pinned(batches):
    """The producer's side of the copy to the card: each batch's uint8 tiles
    in pinned host memory, so the copy does not wait for queued work."""
    for batch in batches:
        yield {**batch, "images": torch.from_numpy(batch["images"]).pin_memory()}


def train_ssl(args, output_dir: str, device: Optional[torch.device] = None,
              pindex: int = 0, pcount: int = 1):
    """DINO student/teacher SSL loop over ``args.data_dir``
    (``tpuwsi/cli/train.py:1683``): per epoch one shuffle from ``seed +
    epoch``, batches decoded on ``--workers`` threads behind a
    ``Prefetcher``, the steps of each --steps-per-dispatch chunk one after
    another, a host read of the loss every --dispatch-ahead steps (the
    bound on run-ahead) and every --log-interval steps (logged), then the
    kNN probe every --knn-eval-rate epochs, a checkpoint ranked by the loss
    and a row of ``summary.csv`` when the probe is on. ``main`` has checked
    the mode and passes this host's index and count. Returns the state.
    """
    from tpuwsi_torch.core.device import require_cuda
    from tpuwsi_torch.io.folder import ImageFolderDataset
    from tpuwsi_torch.io.prefetch import Prefetcher
    from tpuwsi_torch.train.checkpoint import CheckpointManager
    from tpuwsi_torch.utils.runlog import update_summary

    if device is None:
        device = require_cuda()
    ds = ImageFolderDataset(args.data_dir)
    # per-host steps: each host sees a 1/pcount strided slice
    steps_per_epoch = max(len(ds) // (args.batch_size * pcount), 1)
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
        batches = ds.batches(args.batch_size, rng=epoch_rng, process_index=pindex,
                             process_count=pcount, workers=args.workers)
        feed = Prefetcher(_pinned(batches) if on_cuda else batches, depth=3)
        metrics, t0 = {}, time.perf_counter()
        for i, chunk in _chunked_enumerate(feed, spd):
            if args.max_steps_per_epoch:
                if i >= args.max_steps_per_epoch:
                    break
                chunk = chunk[: args.max_steps_per_epoch - i]
            j = i + len(chunk) - 1
            for b in chunk:
                images = (b["images"].to(device, non_blocking=True) if on_cuda
                          else torch.from_numpy(b["images"]))
                state, metrics = bundle.raw_step(state, {"images": images}, bundle.generator)
            if args.dispatch_ahead and _interval_hit(i, j, args.dispatch_ahead):
                float(metrics["loss"])  # bound device run-ahead
            if args.log_interval and _interval_hit(i, j, args.log_interval):
                logging.info("ssl epoch %d step %d loss %.4f momentum %.5f",
                             epoch, j, float(metrics["loss"]), float(metrics["ema_momentum"]))
        epoch_metrics = {"loss": float(metrics.get("loss", 0.0))}
        loop_s = time.perf_counter() - t0
        logging.info("ssl epoch %d: loop %.3f s, waiting on the data %.3f s (%.1f%%)",
                     epoch, loop_s, feed.wait_s, 100.0 * feed.wait_s / max(loop_s, 1e-9))
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
    """The JAX CLI's ``main`` up to its --ssl dispatch: the refusals, the run
    log, the experiment ledger and output directory, then ``train_ssl``.
    ``device`` None means the CUDA device, and raises where there is none."""
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
    return train_ssl(args, exp["Location"], device, pindex, pcount)


if __name__ == "__main__":
    main()
