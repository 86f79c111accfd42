"""Command-line argument surface (the port's own copy of
``tpuwsi/cli/args.py``, pure argparse, so that a run of the port loads
nothing of the JAX package; flags whose feature is not ported yet parse and
their entry points raise).

Parity: train.py:83-393 — the timm flag set (load-bearing subset) plus every
GipMed flag (train.py:359-393), with the same two-stage ``--config`` YAML
parse (train.py:83-85, 396-410: YAML values become parser defaults, command
line wins).
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def _yaml_load(path: str) -> dict:
    try:
        import yaml

        with open(path) as f:
            return yaml.safe_load(f) or {}
    except ImportError:
        # tiny fallback: "key: value" lines only
        out = {}
        with open(path) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if ":" in line:
                    k, v = line.split(":", 1)
                    v = v.strip()
                    for cast in (int, float):
                        try:
                            v = cast(v)
                            break
                        except (TypeError, ValueError):
                            pass
                    if v in ("true", "True"):
                        v = True
                    if v in ("false", "False"):
                        v = False
                    out[k.strip()] = v
        return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("tpuwsi_torch training")
    # core timm-compatible flags
    parser.add_argument("--config", default="", type=str, metavar="FILE")
    parser.add_argument("--model", default="vit_small_patch16_224_dino", type=str)
    parser.add_argument("-b", "--batch-size", default=256, type=int)
    parser.add_argument("--epochs", default=300, type=int)
    parser.add_argument("--opt", default="sgd", type=str)
    parser.add_argument("--opt-eps", default=None, type=float,
                        help="optimizer epsilon (timm --opt-eps; None keeps "
                             "the optimizer default)")
    parser.add_argument("--opt-betas", default=None, type=float, nargs="+",
                        help="optimizer betas (timm --opt-betas)")
    parser.add_argument("--lr", default=None, type=float)
    parser.add_argument("--layer-decay", default=None, type=float,
                        help="layer-wise LR decay factor for fine-tuning "
                             "(timm --layer-decay)")
    parser.add_argument("--lr-base", default=0.1, type=float)
    parser.add_argument("--lr-base-size", default=512, type=int)
    parser.add_argument("--lr-base-scale", default="", type=str)
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--weight-decay", default=2e-5, type=float)
    parser.add_argument("--sched", default="cosine", type=str,
                        choices=["cosine", "tanh", "step", "multistep",
                                 "plateau", "poly", "constant", "none"])
    parser.add_argument("--decay-epochs", default=90, type=float,
                        help="epoch interval for the step scheduler "
                             "(timm --decay-epochs)")
    parser.add_argument("--decay-milestones", default=None, type=float,
                        nargs="+",
                        help="multistep scheduler milestone epochs "
                             "(timm --decay-milestones)")
    parser.add_argument("--patience-epochs", default=10, type=int,
                        help="plateau scheduler patience in eval epochs "
                             "(timm --patience-epochs)")
    parser.add_argument("--lr-cycle-mul", default=1.0, type=float,
                        help="SGDR cycle length multiplier (timm)")
    parser.add_argument("--lr-cycle-decay", default=0.5, type=float,
                        help="SGDR per-cycle peak decay (timm)")
    parser.add_argument("--lr-cycle-limit", default=1, type=int,
                        help="SGDR cycle count, 0 = unlimited (timm)")
    parser.add_argument("--lr-k-decay", default=1.0, type=float,
                        help="cosine k-decay exponent (timm --lr-k-decay)")
    parser.add_argument("--warmup-prefix", action="store_true",
                        help="decay span starts after warmup (timm)")
    parser.add_argument("--lr-noise", default=None, type=float, nargs="+",
                        help="per-epoch LR noise range as epoch fractions "
                             "or epochs (timm --lr-noise)")
    parser.add_argument("--lr-noise-pct", default=0.67, type=float)
    parser.add_argument("--lr-noise-std", default=1.0, type=float)
    parser.add_argument("--decay-rate", "--dr", default=0.1, type=float,
                        help="step scheduler decay factor (timm --decay-rate)")
    parser.add_argument("--warmup-epochs", default=5, type=int)
    parser.add_argument("--warmup-lr", default=1e-5, type=float)
    parser.add_argument("--min-lr", default=0.0, type=float)
    parser.add_argument("--clip-grad", default=None, type=float)
    parser.add_argument("--clip-mode", default="norm", type=str,
                        help="gradient clipping mode: norm | value | agc")
    parser.add_argument("--cooldown-epochs", default=0, type=int,
                        help="hold min_lr for the final N epochs (timm)")
    parser.add_argument("--start-epoch", default=None, type=int,
                        help="manual epoch offset (timm --start-epoch); "
                             "defaults to 0 or the resumed epoch")
    parser.add_argument("--smoothing", default=0.1, type=float)
    parser.add_argument("--bce-loss", action="store_true", default=False)
    parser.add_argument("--bce-target-thresh", default=None, type=float,
                        help="re-binarize soft BCE targets above this "
                             "threshold (timm --bce-target-thresh)")
    parser.add_argument("--drop", default=0.0, type=float)
    parser.add_argument("--drop-path", default=None, type=float)
    parser.add_argument("--drop-connect", default=None, type=float,
                        help="timm's deprecated alias for --drop-path — "
                             "rejected with a pointer, not silently "
                             "remapped (PARITY.md non-goals)")
    parser.add_argument("--grad-checkpointing", action="store_true",
                        default=False,
                        help="rematerialize transformer blocks in the "
                             "backward (timm --grad-checkpointing)")
    parser.add_argument("--model-ema", action="store_true", default=False)
    parser.add_argument("--model-ema-decay", default=0.9998, type=float)
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--log-interval", default=50, type=int)
    parser.add_argument("--recovery-interval", default=0, type=int)
    parser.add_argument("--checkpoint-hist", default=10, type=int)
    parser.add_argument("-j", "--workers", default=4, type=int)
    parser.add_argument("--output", default="", type=str)
    parser.add_argument("--experiment", default="", type=str)
    parser.add_argument("--subexperiment", default="", type=str,
                        help="sub-folder under the experiment run dir "
                             "(train.py:346,857-865 get_outdir nesting)")
    parser.add_argument("--eval-metric", default="auc", type=str)
    parser.add_argument("-vb", "--validation-batch-size", default=None,
                        type=int, help="eval batch size (defaults to -b)")
    parser.add_argument("--save-images", action="store_true", default=False,
                        help="save a PNG grid of the first augmented batch "
                             "each epoch (train.py:1114-1120)")
    # folder-mode validation split when no explicit val/ subtree exists
    # (timm --val-split analogue); 0 disables folder-mode validation.
    parser.add_argument("--val-split", default=0.2, type=float)
    parser.add_argument("--resume", default="", type=str)
    parser.add_argument("--no-resume-opt", action="store_true", default=False,
                        help="resume weights/epoch but start a fresh "
                             "optimizer (timm --no-resume-opt)")
    parser.add_argument("--pretrained", action="store_true", default=False,
                        help="timm hub download — unsupported (no egress); "
                             "use --initial-checkpoint with locally "
                             "converted torch weights (models/convert.py)")
    parser.add_argument("--initial-checkpoint", default="", type=str)
    parser.add_argument("--num-classes", type=int, default=None)
    parser.add_argument("--img-size", type=int, default=None)
    parser.add_argument("--input-size", default=None, nargs=3, type=int,
                        metavar="N N N",
                        help="input dims c h w (timm --input-size); the "
                             "spatial size overrides --img-size")
    parser.add_argument("--in-chans", type=int, default=None,
                        help="input channels (timm --in-chans; default 3, "
                             "or --input-size's first dim)")
    parser.add_argument("--no-aug", action="store_true", default=False,
                        help="disable train-time augmentation — train "
                             "batches get the eval transform (timm --no-aug)")
    parser.add_argument("--interpolation", default="", type=str,
                        help="resize interpolation: bilinear | bicubic "
                             "(timm --interpolation; empty = the model "
                             "data-config default, bicubic for ViT)")
    parser.add_argument("--train-interpolation", default="random", type=str,
                        help="train-time interpolation: random | bilinear | "
                             "bicubic (timm --train-interpolation)")
    parser.add_argument("--log-wandb", action="store_true", default=False)
    parser.add_argument("--data-dir", default="", type=str,
                        help="image-folder mode (timm_train.py path)")
    parser.add_argument("--train-split", default="train", type=str,
                        help="train subtree name in folder mode (timm)")
    parser.add_argument("--class-map", default="", type=str,
                        help="class-name→index file, one class per line "
                             "(timm --class-map)")
    # GipMed flags (train.py:359-393)
    parser.add_argument("--no-grad", action="store_true", default=False)
    parser.add_argument("--num-output", type=int, default=None)
    parser.add_argument("-balsam", "--balanced_sampling", action="store_true")
    parser.add_argument("-tf", "--test_fold", default=1, type=int)
    parser.add_argument("-d", dest="dx", action="store_true")
    parser.add_argument("-time", dest="time", action="store_true")
    parser.add_argument("-tar", "--target", default="ER", type=str)
    parser.add_argument("--n_patches_test", default=1, type=int)
    parser.add_argument("--n_patches_train", default=10, type=int)
    parser.add_argument("--transform_type", default="rvf", type=str)
    parser.add_argument("--bootstrap", action="store_true")
    parser.add_argument("--eval_rate", type=int, default=5)
    parser.add_argument("--c_param", default=0.1, type=float)
    parser.add_argument("-im", dest="images", action="store_true")
    parser.add_argument("--mag", type=int, default=10)
    parser.add_argument("--loan", action="store_true")
    parser.add_argument("--er_eq_pr", action="store_true")
    parser.add_argument("--focal", action="store_true")
    parser.add_argument("--slide_per_block", action="store_true")
    parser.add_argument("-baldat", "--balanced_dataset", action="store_true")
    parser.add_argument("--RAM_saver", action="store_true")
    parser.add_argument("-tl", "--transfer_learning", default="", type=str)
    parser.add_argument("-nt", "--num_tiles", type=int, default=500)
    parser.add_argument("-tpi", "--tiles_per_iter", type=int, default=500)
    parser.add_argument("--supervised", action="store_true")
    parser.add_argument("-ef", "--extract_features", action="store_true")
    # dataset selection
    parser.add_argument("--dataset", default="TCGA", type=str)
    parser.add_argument("--tile-size", default=256, type=int)
    parser.add_argument("--data-root", default=None, type=str)
    # DINO SSL flags (the latent capability made real)
    parser.add_argument("--ssl", action="store_true", help="DINO student/teacher SSL")
    parser.add_argument("--dino-out-dim", default=65536, type=int)
    parser.add_argument("--dino-local-crops", default=6, type=int)
    parser.add_argument("--dino-global-size", default=224, type=int)
    parser.add_argument("--dino-local-size", default=96, type=int)
    parser.add_argument("--teacher-temp", default=0.04, type=float)
    parser.add_argument("--warmup-teacher-temp", default=0.04, type=float)
    parser.add_argument("--warmup-teacher-temp-epochs", default=0, type=int)
    parser.add_argument("--ema-base", default=0.996, type=float)
    parser.add_argument("--knn-eval-rate", default=0, type=int,
                        help="folder-mode SSL only: every N epochs run the "
                             "DINO kNN probe (teacher CLS features, k=20) "
                             "on a held-out 20%% of the folder labels and "
                             "log knn_acc to summary.csv; 0 = off")
    # timm folder-mode transform stack (timm create_transform surface,
    # timm_train.py:614-663) — active with --transform_type timm
    parser.add_argument("--hflip", default=0.5, type=float)
    parser.add_argument("--vflip", default=0.0, type=float)
    parser.add_argument("--color-jitter", default=0.4, type=float)
    parser.add_argument("--scale", default=[0.08, 1.0], type=float,
                        nargs="+", help="RandomResizedCrop area range")
    parser.add_argument("--ratio", default=[3. / 4., 4. / 3.], type=float,
                        nargs="+", help="RandomResizedCrop aspect range")
    parser.add_argument("--crop-pct", default=0.875, type=float,
                        help="eval center-crop fraction")
    parser.add_argument("--mean", default=None, type=float, nargs="+",
                        help="normalization mean override (3 floats)")
    parser.add_argument("--std", default=None, type=float, nargs="+",
                        help="normalization std override (3 floats)")
    # timm folder-mode batch augmentations (timm_train.py:238-271)
    parser.add_argument("--bn-momentum", default=None, type=float,
                        help="BatchNorm momentum, torch convention "
                             "(timm --bn-momentum; default 0.1)")
    parser.add_argument("--bn-eps", default=None, type=float,
                        help="BatchNorm epsilon (timm --bn-eps)")
    parser.add_argument("--aa", default=None, type=str,
                        help="auto-augment spec, e.g. rand-m9-mstd0.5 or "
                             "augmix-m3-w3")
    parser.add_argument("--aug-splits", default=0, type=int,
                        help="augmentation splits per sample (timm AugMix "
                             "protocol; 0 or >1, split 0 is clean)")
    parser.add_argument("--jsd-loss", action="store_true",
                        help="Jensen-Shannon consistency loss across "
                             "--aug-splits (timm JsdCrossEntropy)")
    parser.add_argument("--resplit", action="store_true",
                        help="skip random erasing on the clean split "
                             "(timm --resplit)")
    parser.add_argument("--aug-repeats", default=0, type=int,
                        help="repeated-augmentation instances per sample "
                             "in each batch (timm RASampler / DeiT)")
    parser.add_argument("--reprob", default=0.0, type=float,
                        help="random-erasing probability")
    parser.add_argument("--remode", default="pixel", type=str)
    parser.add_argument("--recount", default=1, type=int)
    parser.add_argument("--mixup", default=0.0, type=float,
                        help="mixup alpha; enabled if > 0")
    parser.add_argument("--cutmix", default=0.0, type=float,
                        help="cutmix alpha; enabled if > 0")
    parser.add_argument("--mixup-prob", default=1.0, type=float)
    parser.add_argument("--mixup-switch-prob", default=0.5, type=float)
    parser.add_argument("--mixup-mode", default="batch", type=str,
                        choices=["batch", "pair", "elem"],
                        help="how mixup/cutmix params apply (timm)")
    parser.add_argument("--cutmix-minmax", default=None, type=float,
                        nargs="+",
                        help="cutmix min/max box ratio — overrides the "
                             "cutmix alpha (timm --cutmix-minmax)")
    parser.add_argument("--mixup-off-epoch", default=0, type=int,
                        help="disable mixup/cutmix after this epoch (timm)")
    # parallelism (SURVEY §5.8): data axis sized automatically; model axis
    # opt-in (the reference is DP-only; TP is the TPU-native extension)
    parser.add_argument("--model-parallel", default=1, type=int,
                        help="mesh 'model' axis size (tensor parallelism); "
                             "1 = pure data parallel (reference parity)")
    # debug/smoke
    parser.add_argument("--max-steps-per-epoch", default=0, type=int,
                        help="0 = full epoch (testing hook)")
    parser.add_argument("--eval-steps-per-dispatch", default=8, type=int,
                        help="serving-side scan loop: stack N eval chunks "
                             "per device dispatch (lax.scan), amortizing "
                             "per-call dispatch+fetch overhead; 1 = one "
                             "dispatch per chunk (reference parity). "
                             "Default 8: measured round 5 — "
                             "scanned+pipelined is fastest AND robust to "
                             "dispatch-latency jitter (BENCH.md round-5 "
                             "serving table)")
    parser.add_argument("--dispatch-ahead", default=4, type=int,
                        help="bound device run-ahead: sync every N steps "
                             "(unbounded queues hold N optimizer states in "
                             "HBM and thrash; measured 5x slowdown)")
    parser.add_argument("--steps-per-dispatch", default=1, type=int,
                        help="scan N optimizer steps in ONE device dispatch "
                             "(the bench.py K-step loop, productionized): "
                             "amortizes per-call dispatch latency; "
                             "log/recovery granularity becomes N steps")
    parser.add_argument("--quantize", default="none",
                        choices=["none", "int8"],
                        help="inference quantization for -ef feature "
                             "extraction (ViT family): int8 body GEMMs — "
                             "per-channel int8 weights + dynamic per-token "
                             "activations (ops/quant). Accuracy-pinned but "
                             "measured NEUTRAL-TO-SLOWER on v5e-class "
                             "chips (XLA int8 emitter; BENCH.md round-4 "
                             "int8 study) — for int8-native deployments")
    return parser


def parse_args(
    argv: Optional[List[str]] = None,
    default_overrides: Optional[dict] = None,
) -> argparse.Namespace:
    """Two-stage parse: --config YAML sets defaults (train.py:396-410).

    ``default_overrides`` (dest -> value) sits BELOW the YAML config and the
    command line in precedence — it replaces the parser's built-in defaults
    only. This is how timm_train pins timm's own defaults without shadowing
    user config values (injecting them as argv would beat the YAML, since
    argparse keeps the last occurrence)."""
    parser = build_parser()
    if default_overrides:
        parser.set_defaults(**default_overrides)
    config_parser = argparse.ArgumentParser(add_help=False)
    config_parser.add_argument("--config", default="", type=str)
    given, remaining = config_parser.parse_known_args(argv)
    if given.config:
        cfg = _yaml_load(given.config)
        parser.set_defaults(**cfg)
    args = parser.parse_args(argv)
    return args
