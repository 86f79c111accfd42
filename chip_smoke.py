#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card's name and power limit (nvidia-smi);
  2. build the Hopper kernels from tpuwsi_torch/ops/csrc with nvcc (ptxas'
     report of csrc/mlp_sm90.cu's, csrc/attn_block.cu's and
     csrc/dense_sm90.cu's kernels must show 0 spill bytes and no serialised
     wgmma);
  3. each of the nineteen kernels against its plain PyTorch version on the
     card, at the shapes the paths give it (the four whole-sequence kernels
     at 37-257 tokens, the training kernels also at the supervised step's
     (256, 257), and at every branch edge of the forward kernel from 1 to
     511 tokens, the four tiled flash kernels at 512-1,024 tokens,
     through strided views of a fused qkv and contiguous, and with key
     lengths; both flash pairs also at the edges of their tiles: Sq != Sk
     both ways, 1, 37 and 197 tokens through fused_attention (with a
     gradient for the backward pair), lengths on either side of each 64-row
     stage and of the backward's 128-key and 192-query items, a negative
     scale, the forward at key lengths on either side of each tile edge, and
     the same bits from two launches of each; the four whole-sequence
     kernels also at 65,536 sequences of 16 tokens (past the old 65,535
     cap); the four fused-MLP kernels at the step's and the serving chunk's
     row counts, at ViT-B width and at 7 rows, both GELU forms, and all four
     at both widths at the row counts where their tiles and clusters end (1,
     63-65, 127-129, 321), K5f and K5b also timed back to back beside the
     unfused route at the step's two row counts, K6f at the serving chunk's
     and K6b at the step's global views; the
     five dense-layer kernels at the qkv and proj layers of the same row
     counts, K7 also on nn.Linear's weight layout, and K7, K9c, K9d at the
     row counts where dense_sm90.cu's tiles and clusters end (1-129), both of
     K9c's input and K9d's output widths; the two attention sub-block kernels at the step's global and
     local views, a serving chunk, a batch of 8 tiles, one token, the
     longest sequence they take, ViT-B at 197 and 257 tokens and 65,536
     images of 16 tokens (past the old 65,535 cap), then the op itself at
     ViT-B through autograd, against the plain version),
     plus median times (CUDA events) beside the plain version's and
     one PyTorch library call's (scaled_dot_product_attention, forward or
     its autograd backward; F.linear or its autograd backward, with
     F.layer_norm or the residual sum where the kernel holds them; for the
     MLP and sub-block kernels the unfused route of several calls), which the port
     itself never calls, and the least time the card could take;
  4. the serving slice: full-width ViT-S/16 at 256 px (seeded random weights
     in the JAX package's layout, through params_from_flax) runs 4 slides x
     500 uint8 tiles through extract_features; the kernel's launch count,
     the outputs and the files are checked, and the same model with plain
     attention must agree;
  5. the training slice: the DINO SSL step that ssl_step_bundle assembles
     from the benchmark's arguments (ViT-S/16, depth 12, 65,536-wide head,
     96 uint8 tiles of 256 px per step, tuned configuration) takes 2 + 6
     steps; losses, the teacher's EMA, the centre, the gradient norm and the
     per-kernel launch counts are checked, the same seeds with plain
     attention must give the same losses, and so must a depth-4 run with
     attn_save_probs off, which takes the recomputing backward kernel (timed
     at full depth too);
  5b. the DINO trainer through its entry point: a seeded folder of 2 x 160
     uint8 256-px tissue-like PNG tiles (written by this script, each
     scanline filtered as libpng chooses, all five filter types present; a
     sample decoded back byte for byte), then
     tpuwsi_torch.cli.train.main --ssl over it with the step above for 2
     epochs of 3 steps with the kNN probe after each, once as is and once
     with --grad-checkpointing: per step K1a = K1b = 24 (K1a = 48
     recomputing) and K2 = 12, the probe's K2 = 12 per batch, finite losses
     that agree between the arms, two checkpoints each, summary.csv, and a
     restore into a fresh bundle equal to the final state in every tensor;
     the loop's wall ms per step (spot readings) beside the bare step's, its
     wait on the data and each arm's peak device memory;
  5c. the WSI paths: a TCGA-layout cohort of 12 PNG slides of 8192 x 8192 px
     (objective 20; ssl_tile's tissue-like picture at slide scale, each
     scanline filtered as libpng chooses; each decoded back byte for byte),
     their tissue grids for --mag 20 and 10 from build_tissue_grid and the
     two xlsx tables from write_xlsx; the C crop-and-resize held against
     resize_bicubic on 60 tiles; then tpuwsi_torch.cli.train.main -ef over
     the 8 slides of test fold 1 at --mag 20 (500 crops a slide) and 10
     (512² regions resized to 256²): K2 = 12 per chunk, one feature file a
     slide and inference.data, 384-wide features, the first chunk held
     against plain attention and main()'s saved features; tiles/s over
     main() and over the walk, the host's seconds a slide (decode, walk,
     pinned copy), the wait on the Prefetcher and the card's idle share
     (CUDA events around each chunk's copy and forward), and an arm with the
     slides decoded in turn; then [wsi_formats]: the committed fixtures
     (tests/data/torch_m1b) read by the port's C readers against their
     committed digests, a JPEG tile's host decode time, and main -ef over
     Deflate-tiled TIFFs of two of those slides (features equal the PNG
     run's bit for bit), 12 JPEG SVS slides of 8192 px assembled from the
     fixture's tile payloads, 8 MIRAX slides of ~8192 px assembled from the
     MIRAX fixture's camera payloads (overlapping cameras, a region of each
     at levels 0 and 1 held against a numpy stitch of its tiles; --mag 20
     and 10) and a TMA cohort of JPEG cores (the Amir bank), each with K2 =
     12 per chunk and its first chunk held against plain attention, and
     supervised main over the SVS slides at --mag 10 (K1a = K1b = 12 a
     step, finite losses); then [mil]: tpuwsi_torch.cli.mil_train.main on
     the card over -ef's features (fold 2's 4 slides at --mag 20 train, K2 =
     12 a chunk; [wsi_ef]'s 8 fold-1 slides evaluate), over a cohort of 400 +
     100 slides of up to 500 tiles x 384 written from the seed as -ef's
     pickle (both held against the same runs on the CPU: the final
     evaluation and slide_scores.xlsx's cells), and in the paired
     Receptor+is_Tumor mode at 768 through the feature registry; ms per
     epoch and the card's idle share; the MIL head launches no kernel; then
     main --ssl over the 4 slides of fold 2 at
     --mag 10 (10 steps of 96 tiles): K1a = K1b = 24 and K2 = 12 per step,
     finite losses, a checkpoint, the loop's ms per step beside the bare
     step's, its wait on the data, the first step's wait and peak device
     memory;
  5d. supervised receptor-status training through the same entry point
     (tpuwsi_torch.cli.train.main without --ssl): ViT-S/16 at 256 px (257
     tokens), -b 256, the pcbnfrsc recipe at --mag 10, Nesterov SGD,
     smoothed CE, --model-ema, over the 4 slides of fold 2 for 2 epochs of
     3 steps, the 8 slides of test fold 1 evaluated after each: per step
     K1a = K1b = 12 at 257 tokens and no other kernel, K2 = 12 per chunk of
     the slide evaluation, finite losses, two checkpoints and summary.csv
     with eval_auc; the same run with plain attention (every loss, the
     final weights and EMA copies against the kernel run's, the EMA copy
     against a float64 replay of its update); ms per step (the step's
     stream time, CUDA events; and the gaps between step starts), tiles/s,
     the wait on the data and peak device memory;
  5e. survival training through the same entry point (-tar Survival_Time,
     then Survival_Binary) over the same slides listed as an ABCTB cohort
     with the four survival columns (censored slides, an excluded one,
     unknown 5-year statuses): ViT-S/16 at 257 tokens, -b 256, 2 epochs of 2
     steps, the 7 valid slides of test fold 1 evaluated after each: K1a =
     K1b = 12 a step, K2 = 12 a chunk of the evaluations, finite losses, two
     checkpoints and summary.csv with eval_c_index; the same run with plain
     attention (losses and weights to [train_sup]'s bounds); one epoch of
     Survival_Binary, its masked loss and AUC against the host's from the
     step's own logits;
  6. the fused-MLP route (use_fused_mlp), full width and depth: the serving
     slice again (12 sub-block forwards per chunk) and the DINO step for
     2 + 6 steps (per step 14 sub-block forwards, 2 sub-block backwards, 22
     MLP forwards and 22 MLP backwards), each held against the default route
     from the same seeds and timed beside it; then the hybrid route
     (mlp_pallas_bwd) at depth 4 (8 MLP backwards per step, no forward
     kernel);
  7. the hybrid-dense route (dense_pallas_bwd), full width and depth: the
     DINO step for 2 + 6 steps (48 dense backwards per step: qkv and proj of
     12 blocks in the student's two passes), held against the default route
     from the same seeds and timed beside it;
  8. the attention sub-block as one op (fused_attention_block) and composed
     from the LN+GEMM and GEMM+residual ops around mha_from_qkv, with block
     0's weights of the seeded full-width model: forward and backward at the
     step's global and local views (192 x 197 and 576 x 37 tokens) and
     forward at one serving chunk (500 x 257) and a batch of 8 tiles, each
     arm held against the model's own norm1, attention and residual sum and
     timed beside them, launch counts asserted per arm;
  9. small-batch serving through a full-depth ViT-S/16 at 256 px whose every
     block takes its attention half as one fused_attention_block launch (12
     per forward, no other kernel): batches of 8 tiles and one 500-tile
     chunk, held against forward_features and timed beside it; then a
     full-depth ViT-B/16 at 256 px the same way at batch 8;
  10. the long-sequence slices, ViT-S/16 at 448 px (785 tokens), full width
     and depth: 2 chunks of 128 tiles through extract_features, and the same
     DINO step with --dino-global-size 448 for 2 + 4 steps, each with its
     launch counts asserted and held against plain attention;
  11. one step each of the tuned step, the fused-MLP step, the hybrid-dense
     step and the 448-px step under torch.profiler, for a breakdown by kernel
     kind, then 5d's run under it for the device's busy time between step
     starts. They come last: once the profiler has run, the process launches
     kernels more slowly.
A line "[time]" gives each phase's wall seconds. The line before the last
but one is a JSON summary of the kernels, then the
card's name and power limit once more, and the last line
{"ok": true, "device": {...}}. Any failure raises: the script then exits
non-zero without that line. Without a CUDA device it fails at once.
Outputs go to build/chip_smoke/.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from tpuwsi_torch.cli.args import parse_args
from tpuwsi_torch.cli.train import extract_features, ssl_step_bundle
from tpuwsi_torch.core.device import require_cuda
from tpuwsi_torch.core.tuned import tuned_vit_kwargs
from tpuwsi_torch.infer.slide_walker import InferChunk
from tpuwsi_torch.models.convert import params_from_flax
from tpuwsi_torch.models.registry import create_model
from tpuwsi_torch.models.vit import VisionTransformer, interpolate_pos_encoding
from tpuwsi_torch.ops import _build, attention, dense, mlp
from tpuwsi_torch.cli import train as cli_train
from tpuwsi_torch.io import prefetch
from tpuwsi_torch.io.image import decode_png
from tpuwsi_torch.preprocess.recipes import make_recipe
from tpuwsi_torch.train.checkpoint import CheckpointManager

SEED = 0
OUT = Path(__file__).resolve().parent / "build" / "chip_smoke"

# the card's data-sheet peaks (NVIDIA H100 SXM): device memory and dense bf16
PEAK_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12

# The forward kernel's branch edges (mha_qkv_fwd.cu): one token, one 16-key
# chunk, the 48-key score width and one past it (the 208-key one), one and two
# 64-row tiles, the last key held in registers and the first parked in the
# stash, the last a warpgroup takes alone (272) and the first where two share
# a tile, the longest sequence, a block mask across tiles. (B, N, D, H, block_len).
FWD_EDGES = [
    (7, 1, 384, 6, 0), (5, 16, 384, 6, 0), (4, 48, 384, 6, 0), (4, 49, 384, 6, 0),
    (4, 64, 384, 6, 0), (4, 65, 384, 6, 0), (3, 208, 384, 6, 0), (3, 209, 384, 6, 0),
    (3, 272, 384, 6, 0), (3, 273, 384, 6, 0), (2, 511, 384, 6, 0), (2, 400, 384, 6, 37),
]
# (B, N, D, H, block_len): bf16 qkv ~ N(0, 1)
K2_SHAPES = [
    (500, 257, 384, 6, 0),   # serving: ViT-S/16 at 256 px, -tpi 500 (timed)
    (192, 197, 384, 6, 0),   # the DINO step's teacher, global views (timed)
    (64, 257, 768, 12, 0),   # ViT-B/16 at 256 px
    (64, 111, 384, 6, 37),   # packed: three 37-token sequences per row
    *FWD_EDGES,
]
K2_TIMED = {(500, 257), (192, 197)}
# the DINO step at 96 tiles: 2 global views of 197 tokens, 6 local of 37;
# the supervised step: 256 tiles of 256 px, 257 tokens (the backward's
# streamed form)
SUP_SHAPE = (256, 257, 384, 6, 0)
TRAIN_SHAPES = [
    (192, 197, 384, 6, 0),   # student and teacher, global views (timed)
    (576, 37, 384, 6, 0),    # student, local views as the step launches them (timed)
    SUP_SHAPE,               # the supervised step (timed)
    (192, 111, 384, 6, 37),  # the same sequences packed three to a row
    (32, 197, 768, 12, 0),   # ViT-B/16
    *FWD_EDGES,
]
TRAIN_TIMED = TRAIN_SHAPES[:3]
# The backward kernels' branch edges (mha_qkv_bwd.cu): one token, one k16
# step, the local views, the last length with three item slots a warpgroup
# (48) and the first with two, one and two 64-row tiles, the last length where
# each warpgroup runs its own items (128) and the first where both share one,
# the fourth tile, the last resident length (208: kResidentMax) and the first
# streamed one, the forward's 272/273, the longest sequence, a block mask in
# the streamed and in the resident form. (B, N, D, H, block_len)
BWD_EDGES = [
    (7, 1, 384, 6, 0), (5, 16, 384, 6, 0), (4, 37, 384, 6, 0), (4, 48, 384, 6, 0),
    (4, 49, 384, 6, 0), (4, 64, 384, 6, 0), (4, 65, 384, 6, 0), (3, 128, 384, 6, 0),
    (3, 129, 384, 6, 0), (3, 192, 384, 6, 0), (3, 193, 384, 6, 0), (3, 208, 384, 6, 0),
    (3, 209, 384, 6, 0), (3, 272, 384, 6, 0), (3, 273, 384, 6, 0), (2, 511, 384, 6, 0),
    (2, 400, 384, 6, 37), (4, 111, 384, 6, 37),
]
# bf16 rounding of q*scale, of p and of dS, fp32 accumulation
K_MAX_ABS, K_MEAN_ABS = 2e-2, 2e-3

# flash family: (B, H, S, strided): strided = q, k, v are views of a fused
# (B, S, 3 * H * 64) qkv and o, dO of (B, S, H * 64); else contiguous (B, H, S, 64)
FLASH_SHAPES = [
    (192, 6, 785, True),    # the 448-px DINO step's global views (timed, all four)
    (128, 6, 785, True),    # a 448-px serving chunk (timed, the forward pair)
    (4, 6, 1024, False),
    (8, 6, 512, True),      # the first length that takes the flash family
    (2, 6, 513, False),     # one key into the ninth tile
]
FLASH_NAMES = ("flash_fwd", "flash_fwd_stats", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_TIMED_FWD = FLASH_SHAPES[:2]
FLASH_TIMED_BWD = [FLASH_SHAPES[0], FLASH_SHAPES[2]]
# masked forward, one element per length: (S, kv_lengths); the second puts a
# length on either side of the first two edges of the forward's 64-key tiles,
# and one at the full 785
FLASH_LENGTHS = [(512, [512, 300, 37, 1, 0]), (785, [63, 64, 65, 127, 128, 129, 785])]
FLASH_UNEQUAL = [(4, 6, 100, 1000), (4, 6, 900, 200)]  # (B, H, Sq, Sk), contiguous
FLASH_SHORT = [1, 37, 197]  # fused_attention(force_kernel=True) at (4, 6, S, 64)
# the backward's item and stage edges at (2, 6, S, 64), forward and backward:
# a 64-row stage (both kernels), the 128 keys of a dK/dV item, the 192 query
# rows of a dQ item
FLASH_EDGES = [63, 64, 65, 127, 128, 129, 191, 192, 193]
# outputs: one bf16 ulp of a value below 4 where a rounding falls the other
# way (p, dS, o), else fp32 accumulation order; lse is fp32 throughout
FLASH_MAX_ABS, FLASH_MEAN_ABS, FLASH_LSE_MAX_ABS = 2e-2, 1e-5, 1e-4

# F6: the whole-sequence kernels past the old 65,535-sequence cap (B, N, D, H, block_len)
F6_SHAPE = (65536, 16, 384, 6, 0)

# fused MLP: (rows, D, F): bf16 x, dy ~ N(0, 1), weights ~ N(0, 1 / fan_in)
MLP_SHAPES = [
    (37824, 384, 1536),   # the DINO step's student global views, 192 x 197 (timed)
    (21312, 384, 1536),   # its local views, 576 x 37 (also with the erf GELU)
    (128500, 384, 1536),  # one serving chunk, 500 x 257 (the sub-block forward timed)
    (6304, 768, 3072),    # ViT-B/16, 32 x 197
    (7, 384, 1536),       # less than one row tile
]
# the four fused-MLP kernels at both widths (F = 4 D) where their row tiles
# and clusters end: one row, either side of one and two 64-row tiles, and five
# tiles and a row (csrc/mlp_sm90.cu's second cluster of four tiles holds two,
# one of a row)
MLP_EDGE_ROWS = [1, 63, 64, 65, 127, 128, 129, 5 * 64 + 1]
MLP_TIMED_B2B = MLP_SHAPES[:2]  # K5f, K5b back to back beside the unfused route
# bf16 outputs (y, dx): one bf16 ulp of a value below 8, where the rounding of
# the result, or of h, du or LN(x) before a product, falls the other way
MLP_MAX_ABS, MLP_MEAN_ABS = 4e-2, 2e-3
# fp32 parameter gradients, relative to the gradient's largest element: sums
# over the rows of products of bf16 operands, a few of which differ by one ulp
# (2^-8 of the operand: all of it shows where a sum has as few as 7 rows)
MLP_GRAD_REL = 4e-3

# dense layers: (rows, K, N) with K the input and N the output width: bf16 x,
# dy ~ N(0, 1), w ~ N(0, 1 / K)
DENSE_SHAPES = [
    (37824, 384, 1152),   # the student's global views, qkv layer (timed)
    (37824, 384, 384),    # the same rows, proj layer (timed)
    (21312, 384, 1152),   # the student's local views, qkv layer
    (128500, 384, 1152),  # one serving chunk, qkv layer: the forward kernels only
    (6304, 768, 2304),    # ViT-B/16, qkv layer
    (6304, 768, 768),     # ViT-B/16, proj layer
    (7, 384, 384),        # less than one row tile
]
# K7, K9c, K9d, K9a and K9b at width 384 (csrc/dense_sm90.cu,
# csrc/ln_gemm_sm90.cu) where their row tiles and clusters of four tiles end:
# one row, less than a tile, either side of one tile, two tiles and a row
# (three past the end in the one cluster), four tiles and a row (the second
# cluster: a tile of one row, three past the end); K7, K9a and K9b with the
# qkv and proj layers' output widths, K9c with both input widths, K9d with
# both output widths
DENSE_EDGE_ROWS = [1, 7, 63, 64, 65, 129, 257]
# parameter gradients that both routes round to bf16 on their way to the fp32
# parameters: one bf16 ulp of the largest element, 2^-7 of it
ROUNDED_GRAD_REL = 8e-3

# attention sub-block: (B, N, D, H, what is checked): x, dy ~ N(0, 1) bf16,
# weights ~ N(0, 1 / D); "both" = forward and backward, "fwd" = forward only
ATTN_BLOCK_SHAPES = [
    (192, 197, 384, 6, "both"),   # the DINO step's student global views (timed)
    (500, 257, 384, 6, "fwd"),    # one serving chunk (timed)
    (576, 37, 384, 6, "both"),    # the student's local views
    (8, 257, 384, 6, "fwd"),      # small-batch serving (timed)
    (3, 1, 384, 6, "both"),       # one token
    (2, attention.ATTN_BLOCK_MAX_SEQ[384], 384, 6, "both"),
    (16, 197, 768, 12, "both"),   # ViT-B/16 at 224 px (timed)
    (64, 257, 768, 12, "fwd"),    # ViT-B/16 at 256 px (timed)
    (2, attention.ATTN_BLOCK_MAX_SEQ[768], 768, 12, "both"),
    (65536, 16, 384, 6, "both"),  # past the old 65,535 cap of the grid
]
ATTN_BLOCK_TIMED = {(192, 197): ("attn_block_fwd", "attn_block_bwd"),
                    (500, 257): ("attn_block_fwd",), (8, 257): ("attn_block_fwd",),
                    (16, 197): ("attn_block_fwd", "attn_block_bwd"), (64, 257): ("attn_block_fwd",)}
ATTN_BLOCK_OP = (16, 197, 768, 12)  # ViT-B/16 through fused_attention_block and autograd
ATTN_BLOCK_REFUSED = (2, 5, 512, 8)  # a width no kernel is built for: refused by name
SMALL_BATCH = 8                          # tiles per forward of the small-batch serving walk

MODEL, TILE, TILES_PER_ITER, N_SLIDES = "vit_small_patch16_224", 256, 500, 4
ATTN_BLOCK_MODELS = {384: MODEL, 768: "vit_base_patch16_224"}  # a tuned block of each width
VALID = [500, 500, 437, 311]  # two slides end in a padded chunk
MODEL_448, TILE_448, TILES_PER_ITER_448, VALID_448 = "vit_small_patch16_448", 448, 128, [128, 77]
FEAT_COSINE_MIN, PROBS_MAX_DIFF = 0.999, 1e-2

TRAIN_ARGV = ["--ssl", "--model", "vit_small_patch16_224_dino", "--epochs", "300",
              "--warmup-epochs", "10", "--opt", "adamw", "--lr-base", "0.0005",
              "--weight-decay", "0.04"]
TRAIN_BATCH, STEPS_PER_EPOCH, WARMUP_STEPS, TIMED_STEPS = 96, 1000, 2, 6
TRAIN_ARGV_448, TIMED_STEPS_448 = TRAIN_ARGV + ["--dino-global-size", "448"], 4
# kernel path against plain-attention path, same seeds: the two differ in the
# summation order inside attention only, then in what bf16 makes of that
LOSS_MAX_DIFF = 2e-2
# the trainer's folder: classes x tiles of SSL_TILE px, class means apart
SSL_DIR, SSL_RUNS = OUT / "ssl_folder", OUT / "train_ssl"
SSL_CLASSES, SSL_PER_CLASS, SSL_TILE = 2, 160, 256
SSL_MEANS = [(70, 60, 110), (190, 150, 200)]
SSL_EPOCHS, SSL_STEPS = 2, 3
SSL_ARGV = ["--ssl", "--model", "vit_small_patch16_224_dino", "-b", str(TRAIN_BATCH),
            "--dino-out-dim", "65536", "--epochs", str(SSL_EPOCHS), "--max-steps-per-epoch",
            str(SSL_STEPS), "--warmup-epochs", "10", "--opt", "adamw", "--lr-base", "0.0005",
            "--weight-decay", "0.04", "--knn-eval-rate", "1", "--log-interval", "1"]
# the WSI cohort: TCGA's layout under WSI_ROOT, PNG slides of WSI_SIZE² px at
# objective 20 with tissue grids at 256-px tiles for --mag 20 and 10; fold 1
# (8 slides) is -ef's test fold, fold 2 (4 slides, nearly all tissue) --ssl's
WSI_ROOT, WSI_RUNS = OUT / "wsi", OUT / "wsi_runs"
WSI_COHORT = WSI_ROOT / "Breast" / "TCGA"
WSI_SIZE, WSI_OBJECTIVE, WSI_TILE, WSI_MAGS, WSI_BAND = 8192, 20, 256, (20, 10), 256
WSI_FOLDS = [1] * 8 + [2] * 4
WSI_TISSUE_CELLS, WSI_TISSUE_OFFSET = 16, {1: 0.5, 2: 2.0}
WSI_EF_TILES, WSI_SSL_TILES = 500, 240
WSI_TURN_SLIDES = 4  # [wsi_ef]'s arm that decodes each slide in turn walks this many
WSI_EF_ARGV = ["-ef", "--dataset", "TCGA", "--data-root", str(WSI_ROOT), "--model", MODEL,
               "--tile-size", str(WSI_TILE), "-nt", str(WSI_EF_TILES), "-tpi",
               str(WSI_EF_TILES)]
WSI_SSL_ARGV = ["--ssl", "--dataset", "TCGA", "--data-root", str(WSI_ROOT), "--mag", "10",
                "--tile-size", str(WSI_TILE), "-b", str(TRAIN_BATCH), "--n_patches_train",
                str(WSI_SSL_TILES), "--model", "vit_small_patch16_224_dino", "--dino-out-dim",
                "65536", "--epochs", "1", "--warmup-epochs", "10", "--opt", "adamw",
                "--lr-base", "0.0005", "--weight-decay", "0.04", "--log-interval", "1"]
# supervised training over the cohort (scripts/train-supervised.sh's recipe):
# fold 2's 4 slides, 240 tiles each at --mag 10, 3 steps of 256 an epoch;
# test fold 1's 8 slides evaluated with 64 tiles each after every epoch; -j 8:
# the 8 slides of an evaluation decode at once
SUP_RUNS = OUT / "train_sup"
SUP_BATCH, SUP_EPOCHS, SUP_STEPS, SUP_TEST_TILES = 256, 2, 3, 64
# the kernel run against the same run with plain attention, step for step:
# the largest loss difference, and the distance between the two runs' final
# weights (and EMA copies) over the distance each moved from the initial ones;
# measured 1.3e-3, 2.6e-3 and 4.1e-3 on the H100 at learning rates to 1.7e-2
SUP_LOSS_MAX_DIFF, SUP_PARAM_MAX_REL = 5e-3, 2e-2
# the EMA copy against a float64 replay of its update (with the fp32
# constants the device uses) over the plain run's steps: each element's gap
# over fp32's rounding bound, eps x the sum over steps of |ema| + (1 - decay) |p|
SUP_EMA_MAX_ROUNDING = 1.0
SUP_ARGV = ["--dataset", "TCGA", "--data-root", str(WSI_ROOT), "--model",
            "vit_small_patch16_224_dino", "--tile-size", str(WSI_TILE), "--mag", "10", "-b",
            str(SUP_BATCH), "--transform_type", "pcbnfrsc", "--opt", "sgd", "--lr-base", "0.1",
            "--smoothing", "0.1", "--model-ema", "--n_patches_train", str(WSI_SSL_TILES),
            "--n_patches_test", str(SUP_TEST_TILES), "-tpi", str(SUP_TEST_TILES), "-tf", "1",
            "--eval_rate", "1", "--seed", str(SEED), "--workers", "8"]
# survival training over [wsi_cohort]'s slides, listed as an ABCTB cohort whose
# slides_data holds the four survival columns: fold 2's 4 slides train (one
# censored, one of unknown 5-year status), fold 1's evaluate (one excluded, so
# 7; two censored, one unknown); 2 epochs of 2 steps of 256 at --mag 10, each
# evaluated (-j 8: the 7 slides decode at once), then the same with plain
# attention, then Survival_Binary's epoch
SURV_ROOT, SURV_RUNS = OUT / "survival", OUT / "train_survival"
SURV_EPOCHS, SURV_STEPS, SURV_EVAL_SLIDES = 2, 2, 7
SURVIVAL_CELLS = {
    "Censored": [False, True, False, False, True, False, False, False,
                 False, True, False, False],
    "Follow-up Months Since Diagnosis": [10.0, 60.0, 25.0, 40.0, 70.0, 15.0, 33.0, 5.0,
                                         20.0, 35.0, 50.0, 12.0],
    "survival status": ["Negative", "Positive", "Negative", "Positive", "Positive", None,
                        "Negative", "Negative", "Negative", "Positive", None, "Negative"],
    "Exclude for time prediction?": [None] * 7 + ["Exclude"] + [None] * 4,
}
SURV_ARGV = ["--dataset", "ABCTB", "--data-root", str(SURV_ROOT), "--model",
             "vit_small_patch16_224_dino", "--tile-size", str(WSI_TILE), "--mag", "10", "-b",
             str(SUP_BATCH), "--transform_type", "pcbnfrsc", "--opt", "sgd", "--lr-base", "0.1",
             "--n_patches_train", str(WSI_SSL_TILES), "--n_patches_test", str(SUP_TEST_TILES),
             "-tpi", str(SUP_TEST_TILES), "-tf", "1", "--eval_rate", "1", "--seed", str(SEED),
             "--log-interval", "1", "--workers", "8"]
# the binary step's loss and AUC against the host's reckoning from its logits
SURV_BINARY_LOSS_REL = 1e-5
# MIL over feature bags: (a) -ef over fold 2 (4 slides at --mag 20) trains the
# head, [wsi_ef]'s fold-1 inference.data evaluates it; (b) a cohort of
# MIL_SLIDES + MIL_TEST_SLIDES slides of up to MIL_TILES tiles x 384 fp32,
# written from SEED as -ef's pickle; (c) the paired Receptor+is_Tumor mode over
# two such sets through the registry, 768 wide. (a) and (b) also run on the CPU
# from the same weights and bag draws.
MIL_ROOT = OUT / "mil"
MIL_SLIDES, MIL_TEST_SLIDES, MIL_TILES, MIL_DIM, MIL_EPOCHS = 400, 100, 500, 384, 10
MIL_PAIRED_SLIDES, MIL_PAIRED_TEST = 200, 50
MIL_ARGV = ["--bag-size", "100", "-b", "16", "--hidden-dim", "128", "--seed", str(SEED),
            "--export-xlsx"]
# the card's run against the CPU's: fp32 on both (TF32 off), different
# summation orders. Probabilities, tile scores, attention after the softmax and
# before it less each run's att_w.bias (whose gradient is zero in exact
# arithmetic, so Adam moves it by rounding noise) within MIL_CELL_TOL; the AUC
# within one swapped pair, the accuracy within one slide
MIL_CELL_TOL = 1e-4
# step times of the bare step, by tag, for the phases that read them beside theirs
STEP_MS = {}
# tiles/s of the serving slice on resident chunks, by tag, for the same
SERVING_TILES_S = {}
# [wsi_ef]'s run at --mag 20: tiles/s, and each slide's (locations, features)
WSI_EF_PNG = {}
# [wsi_formats]: (a) the test fold's PNG slides as Deflate-tiled pyramidal
# TIFFs; (b) 12 JPEG SVS slides of WSI_SIZE px (folds as WSI_FOLDS) assembled
# from the committed YCbCr 4:2:0 fixture's tile payloads and JPEGTables (no
# JPEG encoder needed); (c) MIRAX slides assembled from the committed MIRAX
# slide's camera payloads, and copies of the committed JPEG core as a TMA
# cohort (the 'Amir' bank); supervised training
# over (b) at --mag 10 (level 1), one epoch of FORMATS_SUP_STEPS steps
FORMATS_ROOT = OUT / "wsi_formats"
FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "torch_m1b"
FORMATS_COPIES, FORMATS_SUP_TILES, FORMATS_SUP_STEPS, FORMATS_DECODES = 4, 200, 3, 200
FORMATS_TIFFS = 2  # of [wsi_cohort]'s test-fold slides, as Deflate TIFFs
# (c)'s MIRAX slides: MIRAX_CAMS² cameras of 2 x 2 tiles of MIRAX_TILE px (the
# fixture's payloads), overlapping by MIRAX_OVERLAP px, MIRAX_LEVELS zoom levels:
# 34 * 240 + 16 px a side, and the jitter (8,184 px for seed 3), near WSI_SIZE
MIRAX_SLIDES, MIRAX_CAMS, MIRAX_TILE, MIRAX_OVERLAP, MIRAX_LEVELS = 8, 34, 128, 16, 3


def all_launches() -> dict:
    """Launches per kernel since the last reset, of every module's kernels."""
    return {**attention.LAUNCHES, **mlp.LAUNCHES, **dense.LAUNCHES}


def reset_launches() -> None:
    attention.reset_launches()
    mlp.reset_launches()
    dense.reset_launches()


def cuda_median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {name}; "
          f"{torch.cuda.device_count()} device(s); {dev}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    fresh = not _build.library_path().exists()
    lib_path = _build.build()
    _build.load()
    verb = "built" if fresh else "loaded"
    print(f"[build] {verb} {lib_path.relative_to(OUT.parents[1])} in "
          f"{time.perf_counter() - t0:.2f} s")
    log = lib_path.with_suffix(".log")
    lines = log.read_text().splitlines() if log.exists() else []
    for line in lines:
        if ("registers" in line or "spill" in line or "Performance Loss" in line) and "C7519" not in line:
            print(f"[build] ptxas: {line.strip()}")
    # the Hopper redesigns whose build refuses a spill or a serialised wgmma in
    # any kernel compiled from them (the build log's "== <source>" parts)
    for source, what in (("mlp_sm90.cu", "K5f, K5b, K6f, K6b"),
                         ("attn_block.cu", "K8f, K8b's head kernel and tails, LN(x)"),
                         ("dense_sm90.cu", "K7, K9c, K9d at width 384: row and dW kernels"),
                         ("ln_gemm_sm90.cu", "K9a, K9b at width 384: the resident-LN(x) "
                          "forward, the row pass with the LayerNorm backward, LN(x), dW")):
        part, fn, spills, serialised = None, None, {}, []
        for line in lines:
            if line.startswith("== "):
                part = line[3:].strip()
            if part != source:
                continue
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                spills[fn] = int(m.group(1)) + int(m.group(2))
            if "Performance Loss" in line:
                serialised.append(line.strip())
        if not spills or any(spills.values()) or serialised:
            raise RuntimeError(f"csrc/{source}: spill bytes {spills}, serialised wgmma {serialised}")
        print(f"[build] ptxas: csrc/{source}'s {len(spills)} kernels ({what}): 0 spill bytes, no "
              "serialised wgmma (C7512-C7520)")


def heads_view(qkv, h):
    """Fused qkv (B, N, 3D) → strided q, k, v views (B, H, N, hd), no copy."""
    b, n, d3 = qkv.shape
    return qkv.view(b, n, 3, h, d3 // 3 // h).permute(2, 0, 3, 1, 4).unbind(0)


def sdpa_forward(qkv, h):
    """The library yardstick of the forward kernels; used nowhere in the port."""
    q, k, v = heads_view(qkv, h)
    return torch.nn.functional.scaled_dot_product_attention(q, k, v)


def sdpa_backward_fn(qkv, g, h):
    """→ a function that runs the autograd backward of the library forward."""
    q, k, v = (x.detach().requires_grad_() for x in heads_view(qkv, h))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    go = g.view(g.shape[0], g.shape[1], h, -1).permute(0, 2, 1, 3)
    return lambda: torch.autograd.grad(out, (q, k, v), go, retain_graph=True)


def attention_bound(kind: str, b, n, d, h) -> dict:
    """The least time the card could take: every input read once and every
    output written once at the memory peak, or the products that are needed
    at the dense bf16 peak, whichever is longer."""
    hd = d // h
    qkv, o = b * n * 3 * d * 2, b * n * d * 2
    p = b * h * n * attention.probs_stride(n) * 2
    product = b * h * 2 * n * n * hd
    nbytes, flops = {
        "fwd": (qkv + o, 2 * product),
        "fwd_saved": (qkv + o + p, 2 * product),
        "bwd_saved": (qkv + o + p + qkv, 4 * product),
        "bwd": (qkv + o + qkv, 5 * product),
    }[kind]
    t_bytes, t_flops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def check_close(name, shape, got, want):
    diff = (got.float() - want.float()).abs()
    mx, mean = diff.max().item(), diff.mean().item()
    finite = bool(torch.isfinite(got.float()).all())
    print(f"[{name}] B={shape[0]} N={shape[1]} D={shape[2]} H={shape[3]} block_len={shape[4]}: "
          f"max_abs={mx:.3e} mean_abs={mean:.3e} (bounds {K_MAX_ABS}, {K_MEAN_ABS})")
    if not finite or mx > K_MAX_ABS or mean > K_MEAN_ABS:
        raise RuntimeError(f"{name} disagrees with its plain version at {shape}")
    return mx


def back_to_back_ms(fn, launches: int = 50, runs: int = 5) -> float:
    """Median over ``runs`` of the time of ``launches`` calls between two
    events, per call: what a kernel costs without the host's launch between."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def timed_ab(kernel_fn, library_fn, plain_fn) -> dict:
    """Medians in the order kernel, library, library, kernel, then plain."""
    k1 = cuda_median_ms(kernel_fn)
    l1 = cuda_median_ms(library_fn)
    l2 = cuda_median_ms(library_fn)
    k2 = cuda_median_ms(kernel_fn)
    return {"ms": min(k1, k2), "ms_runs": [k1, k2], "library_ms": min(l1, l2),
            "library_ms_runs": [l1, l2], "plain_ms": cuda_median_ms(plain_fn, reps=10)}


def phase_k2(smi: str) -> dict:
    """K2 against its plain version at every shape of K2_SHAPES; timed at
    K2_TIMED. The line's own numbers are the serving shape's; ``timed`` holds
    every timed shape's."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err, timed = 0.0, []
    for shape in K2_SHAPES:
        b, n, d, h, block_len = shape
        scale = (d // h) ** -0.5
        qkv = torch.randn((b, n, 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
        out = attention.mha_from_qkv(qkv, h, block_len=block_len)
        ref = attention._mha_reference(qkv, h, scale, block_len)
        torch.cuda.synchronize()
        max_err = max(max_err, check_close("mha_qkv_fwd", shape, out, ref))
        if (b, n) in K2_TIMED:
            t = timed_ab(
                lambda: attention.mha_from_qkv(qkv, h, block_len=block_len),
                lambda: sdpa_forward(qkv, h),
                lambda: attention._mha_reference(qkv, h, scale, block_len))
            t.update(attention_bound("fwd", b, n, d, h))
            t["b2b_ms"] = back_to_back_ms(lambda: attention.mha_from_qkv(qkv, h,
                                                                         block_len=block_len))
            t["library_b2b_ms"] = back_to_back_ms(lambda: sdpa_forward(qkv, h))
            timed.append({"shape": [b, n, d, h], **t})
            print(f"[mha_qkv_fwd] ({b}, {n}, {d}, {h}), medians of 20 in the order kernel, "
                  f"library, library, kernel: kernel {t['ms_runs']} ms, library (SDPA) "
                  f"{t['library_ms_runs']} ms, plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms by {t['bound_by']}; 50 back to back: kernel "
                  f"{t['b2b_ms']:.4f} ms, SDPA {t['library_b2b_ms']:.4f} ms; on {smi}")
        del qkv, out, ref
    main = {k: v for k, v in timed[0].items() if k != "shape"}  # the serving shape
    return {"max_abs_err": max_err, **main, "timed": timed}


def phase_train_kernels(smi: str) -> dict:
    """K1a, K1b and K3 against their plain versions at the DINO step's shapes,
    the supervised step's (256, 257) and at the backward's branch edges
    (``BWD_EDGES``); the backward from
    saved probabilities is fed the p that the saving forward produced, and
    each backward launched twice must repeat its bits, at the edges also
    through autograd (which runs it on a thread of its own). Times at the
    student-global shape, K1a, K1b and K3 also at the local views as the step
    launches them and at the supervised step's (256, 257) (single calls and
    back to back), and of the local views packed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    names = ("mha_qkv_fwd_saved", "mha_qkv_bwd_saved", "mha_qkv_bwd")
    res = {name: {"max_abs_err": 0.0, "timed": []} for name in names}
    local_ms = {}
    shapes = TRAIN_SHAPES + [s for s in BWD_EDGES if s not in TRAIN_SHAPES]
    for shape in shapes:
        b, n, d, h, block_len = shape
        scale = (d // h) ** -0.5
        qkv = torch.randn((b, n, 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        out, p = attention._launch_fwd_saved(qkv, h, scale, block_len)
        out_ref, p_ref = attention._mha_saved_reference(qkv, h, scale, block_len)
        fns = {
            "mha_qkv_fwd_saved": (
                lambda: attention._launch_fwd_saved(qkv, h, scale, block_len),
                lambda: sdpa_forward(qkv, h),
                lambda: attention._mha_saved_reference(qkv, h, scale, block_len)),
            "mha_qkv_bwd_saved": (
                lambda: attention._launch_bwd_saved(qkv, g, p, h, scale),
                sdpa_backward_fn(qkv, g, h),
                lambda: attention._mha_bwd_saved_reference(qkv, g, p, h, scale)),
            "mha_qkv_bwd": (
                lambda: attention._launch_bwd(qkv, g, h, scale, block_len),
                sdpa_backward_fn(qkv, g, h),
                lambda: attention._mha_bwd_reference(qkv, g, h, scale, block_len)),
        }
        torch.cuda.synchronize()
        errs = {"mha_qkv_fwd_saved": max(
            check_close("mha_qkv_fwd_saved out", shape, out, out_ref),
            check_close("mha_qkv_fwd_saved p", shape, p, p_ref))}
        for name in names[1:]:
            got, again = fns[name][0](), fns[name][0]()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise RuntimeError(f"{name}: two launches on the same inputs differ at {shape}")
            errs[name] = check_close(name, shape, got, fns[name][2]())
            if shape not in TRAIN_SHAPES:
                # the same backward through autograd, on its own thread
                x = qkv.clone().requires_grad_()
                attention.mha_from_qkv(x, h, block_len=block_len, training=True,
                                       save_probs=name == "mha_qkv_bwd_saved").backward(g)
                torch.cuda.synchronize()
                if not torch.equal(x.grad, got):
                    raise RuntimeError(f"{name} through autograd differs at {shape}")
                del x
            del got, again
        if (p[..., n:] != 0).any():
            raise RuntimeError("mha_qkv_fwd_saved left pad columns of p non-zero")
        kinds = {"mha_qkv_fwd_saved": "fwd_saved", "mha_qkv_bwd_saved": "bwd_saved",
                 "mha_qkv_bwd": "bwd"}
        for name in names:
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], errs[name])
            if shape in TRAIN_TIMED:
                r = {**timed_ab(*fns[name]), **attention_bound(kinds[name], b, n, d, h)}
                r["b2b_ms"] = back_to_back_ms(fns[name][0])
                r["library_b2b_ms"] = back_to_back_ms(fns[name][1])
                if shape == TRAIN_SHAPES[0]:
                    res[name].update(r)
                res[name]["timed"].append({"shape": [b, n, d, h], **r})
                print(f"[{name}] ({b}, {n}, {d}, {h}), medians of 20 in the order kernel, "
                      f"library, library, kernel: kernel {r['ms_runs']} ms, library (SDPA"
                      f"{'' if name == 'mha_qkv_fwd_saved' else ' backward'}) "
                      f"{r['library_ms_runs']} ms, plain {r['plain_ms']:.4f} ms; 50 back to "
                      f"back (medians of 5, per launch): kernel {r['b2b_ms']:.4f} ms, library "
                      f"{r['library_b2b_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by "
                      f"{r['bound_by']}; on {smi}")
            if n in (37, 111) and d == 384 and shape in TRAIN_SHAPES:
                local_ms.setdefault(name, []).append(cuda_median_ms(fns[name][0]))
        del qkv, g, out, p, out_ref, p_ref, fns
    print("[mha_qkv_bwd_saved] [mha_qkv_bwd] two launches on the same inputs gave the same "
          f"bits at every one of {len(shapes)} shapes, and the backward through autograd "
          "gave them too at every BWD_EDGES shape")
    phase_f6()
    for name in names:
        as_is, packed = local_ms[name]
        print(f"[{name}] 576 local sequences of 37 tokens: as they are {as_is:.4f} ms, packed "
              f"three to a row (block_len 37) {packed:.4f} ms; the step launches them as "
              f"they are; on {smi}")
    return res


def phase_f6() -> None:
    """K2, K1a, K1b and K3 at F6_SHAPE, past the 65,535 sequences the
    launchers refused before their grids became persistent, against their
    plain versions at the usual bounds."""
    b, n, d, h, block_len = F6_SHAPE
    scale = (d // h) ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    qkv = torch.randn((b, n, 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
    check_close("mha_qkv_fwd F6", F6_SHAPE, attention._launch_fwd(qkv, h, scale, block_len),
                attention._mha_reference(qkv, h, scale, block_len))
    out, p = attention._launch_fwd_saved(qkv, h, scale, block_len)
    out_ref, p_ref = attention._mha_saved_reference(qkv, h, scale, block_len)
    check_close("mha_qkv_fwd_saved F6 out", F6_SHAPE, out, out_ref)
    check_close("mha_qkv_fwd_saved F6 p", F6_SHAPE, p, p_ref)
    del out_ref, p_ref
    check_close("mha_qkv_bwd_saved F6", F6_SHAPE, attention._launch_bwd_saved(qkv, g, p, h, scale),
                attention._mha_bwd_saved_reference(qkv, g, p, h, scale))
    check_close("mha_qkv_bwd F6", F6_SHAPE, attention._launch_bwd(qkv, g, h, scale, block_len),
                attention._mha_bwd_reference(qkv, g, h, scale, block_len))
    del qkv, g, out, p
    torch.cuda.empty_cache()


def flash_bound(kind: str, b, h, sq, sk) -> dict:
    """As ``attention_bound`` for the flash family: q, k, v (and dO, lse,
    delta) read once, the outputs written once; 2 * B * H * Sq * Sk * 64
    operations per product, of which the forward needs 2, dQ 3 and dK/dV 4."""
    hd = attention.KERNEL_HEAD_DIM
    rows_q, rows_k, stat = b * h * sq * hd * 2, b * h * sk * hd * 2, b * h * sq * 4
    product = 2 * b * h * sq * sk * hd
    nbytes, flops = {
        "flash_fwd": (rows_q + 2 * rows_k + rows_q, 2 * product),
        "flash_fwd_stats": (rows_q + 2 * rows_k + rows_q + stat, 2 * product),
        "flash_bwd_dq": (2 * rows_q + 2 * rows_k + 2 * stat + rows_q, 3 * product),
        "flash_bwd_dkv": (2 * rows_q + 2 * rows_k + 2 * stat + 2 * rows_k, 4 * product),
    }[kind]
    t_bytes, t_flops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bound_bytes": nbytes, "bound_flops": flops}


def check_flash(name, case, got, want, max_abs=FLASH_MAX_ABS, mean_abs=FLASH_MEAN_ABS):
    diff = (got.float() - want.float()).abs()
    mx, mean = diff.max().item(), diff.mean().item()
    print(f"[{name}] {case}: max_abs={mx:.3e} mean_abs={mean:.3e} "
          f"(bounds {max_abs}, {mean_abs})")
    if not bool(torch.isfinite(got.float()).all()) or mx > max_abs or mean > mean_abs:
        raise RuntimeError(f"{name} disagrees with its plain version at {case}")
    return mx


def flash_operands(gen, b, h, s, strided):
    """bf16 ~ N(0, 1): q, k, v, dO as (B, H, S, 64), and views to write o and
    (dq, dk, dv) into: column blocks of (B, S, D) and (B, S, 3D) buffers when
    ``strided``, as mha_from_qkv passes them, else None (the wrappers then
    allocate contiguous tensors)."""
    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    if not strided:
        q, k, v, do = (randn((b, h, s, 64)) for _ in range(4))
        return q, k, v, do, None, None
    qkv, g = randn((b, s, 3 * h * 64)), randn((b, s, h * 64))
    out = attention._heads(torch.empty_like(g), h, 1)[0]
    grads = attention._heads(torch.empty_like(qkv), h, 3)
    return (*attention._heads(qkv, h, 3), attention._heads(g, h, 1)[0], out, grads)


def flash_fwd_pair(case, q, k, v, lengths, scale, out=None, worse=None):
    """K4a' and K4a against ``_flash_reference`` on the same inputs: o and lse
    under the FLASH bounds, the same o from both, and the same bits of o and
    lse from a second launch; → (o, lse) of K4a'."""
    o_plain, lse_plain = attention._flash_reference(q, k, v, lengths, scale)
    o, lse = attention._launch_flash_fwd(q, k, v, lengths, scale, True, out)
    torch.cuda.synchronize()
    err = check_flash("flash_fwd_stats o", case, o, o_plain)
    check_flash("flash_fwd_stats lse", case, lse, lse_plain, FLASH_LSE_MAX_ABS)
    o = o.clone()  # the launches below write the same view
    o_only, none = attention._launch_flash_fwd(q, k, v, lengths, scale, False, out)
    torch.cuda.synchronize()
    if none is not None or not torch.equal(o_only, o):
        raise RuntimeError(f"flash_fwd and flash_fwd_stats differ in o at {case}")
    o_again, lse_again = attention._launch_flash_fwd(q, k, v, lengths, scale, True, out)
    torch.cuda.synchronize()
    if not (torch.equal(o_again, o) and torch.equal(lse_again, lse)):
        raise RuntimeError(f"two launches of flash_fwd_stats differ at {case}")
    if worse is not None:
        worse("flash_fwd_stats", err)
        worse("flash_fwd", err)
    return o, lse


def flash_bwd_pair(case, q, k, v, do, o, lse, scale, grads=None, worse=None):
    """K4b and K4b' against ``_flash_bwd_reference`` on the same inputs (lse
    and delta from the forward kernel's own o and lse): dq, dk, dv under the
    FLASH bounds, and the same bits from a second launch; → (dq, dk, dv) of
    the second launch (the views ``grads`` where given)."""
    delta = attention._flash_delta(o, do)
    want = attention._flash_bwd_reference(q, k, v, do, lse, delta, scale)
    first = [x.clone() for x in attention._launch_flash_bwd(q, k, v, do, lse, delta, scale, grads)]
    torch.cuda.synchronize()
    err_dq = check_flash("flash_bwd_dq", case, first[0], want[0])
    err_dkv = max(check_flash("flash_bwd_dkv dk", case, first[1], want[1]),
                  check_flash("flash_bwd_dkv dv", case, first[2], want[2]))
    del want
    again = attention._launch_flash_bwd(q, k, v, do, lse, delta, scale, grads)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise RuntimeError(f"two launches of flash_bwd_dq / flash_bwd_dkv differ at {case}")
    if worse is not None:
        worse("flash_bwd_dq", err_dq)
        worse("flash_bwd_dkv", err_dkv)
    return again


def phase_flash_kernels(smi: str) -> dict:
    """K4a, K4a', K4b, K4b' against their plain versions. The backward
    kernels and their plain version get the same lse and delta, those of the
    forward kernel's own output. Both pairs are also held at the edges of
    their tiles: Sq != Sk both ways, a negative scale, short sequences through
    fused_attention(force_kernel=True) with a gradient, lengths on either side
    of each stage and item edge; the forward also at key lengths on either
    side of a tile edge. Every case launches each kernel twice and must
    repeat its bits."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    names = FLASH_NAMES
    res = {name: {"max_abs_err": 0.0, "timed": []} for name in names}

    def worse(name, err):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in FLASH_SHAPES:
        b, h, s, strided = shape
        scale = 64 ** -0.5
        case = f"B={b} H={h} S={s} {'strided qkv views' if strided else 'contiguous'}"
        q, k, v, do, out, grads = flash_operands(gen, b, h, s, strided)
        o, lse = flash_fwd_pair(case, q, k, v, None, scale, out, worse)
        dq, dk, dv = flash_bwd_pair(case, q, k, v, do, o, lse, scale, grads, worse)
        delta = attention._flash_delta(o, do)
        timed = ((names[:2] if shape in FLASH_TIMED_FWD else ())
                 + (names[2:] if shape in FLASH_TIMED_BWD else ()))
        if timed:
            ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
            lib_out = sdpa(ql, kl, vl)

            def lib_bwd():
                return torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)

            def dq_only():  # the wrapper launches both; time each C function alone
                attention._call("flash_bwd_dq", q, dq_args)

            def dkv_only():
                attention._call("flash_bwd_dkv", q, dkv_args)

            dims = (b, h, s, s)
            stats = (lse.data_ptr(), delta.data_ptr())
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *stats)
            dq_args = (*ptrs, dq.data_ptr(), *dims, attention._strides(q, k, do, dq), scale)
            dkv_args = (*ptrs, dk.data_ptr(), dv.data_ptr(), *dims,
                        attention._strides(q, k, do, dk), scale)
            fns = {
                "flash_fwd": (lambda: attention._launch_flash_fwd(q, k, v, None, scale, False, out),
                              lambda: sdpa(q, k, v),
                              lambda: attention._flash_reference(q, k, v, None, scale)),
                "flash_fwd_stats": (
                    lambda: attention._launch_flash_fwd(q, k, v, None, scale, True, out),
                    lambda: sdpa(q, k, v),
                    lambda: attention._flash_reference(q, k, v, None, scale)),
                "flash_bwd_dq": (dq_only, lib_bwd, lambda: attention._flash_bwd_reference(
                    q, k, v, do, lse, delta, scale)),
                "flash_bwd_dkv": (dkv_only, lib_bwd, lambda: attention._flash_bwd_reference(
                    q, k, v, do, lse, delta, scale)),
            }
            for name in timed:
                r = {**timed_ab(*fns[name]), **flash_bound(name, b, h, s, s)}
                if shape == FLASH_SHAPES[0]:
                    res[name].update(r)  # the line's own numbers: the step's shape
                res[name]["timed"].append({"shape": [b, h, s, s], **r})
                lib = ("SDPA" if name.startswith("flash_fwd")
                       else "SDPA backward, which computes dq, dk and dv")
                print(f"[{name}] {case}, medians of 20 in the order kernel, library, library, "
                      f"kernel: kernel {r['ms_runs']} ms, library ({lib}) "
                      f"{r['library_ms_runs']} ms, plain {r['plain_ms']:.4f} ms (the plain "
                      f"backward computes dq, dk and dv), bound {r['bound_ms']:.4f} ms by "
                      f"{r['bound_by']} ({r['bound_bytes'] / 1e6:.1f} MB, "
                      f"{r['bound_flops'] / 1e9:.1f} GFLOP); on {smi}")
            del lib_out, ql, kl, vl, fns
        del q, k, v, do, out, grads, o, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()

    # Sq != Sk both ways, contiguous; a negative scale (the forward's other sign)
    for b, h, sq, sk in FLASH_UNEQUAL:
        q, do, k, v = randn((b, h, sq, 64)), randn((b, h, sq, 64)), randn((b, h, sk, 64)), \
            randn((b, h, sk, 64))
        case = f"B={b} H={h} Sq={sq} Sk={sk} contiguous"
        o, lse = flash_fwd_pair(case, q, k, v, None, 0.125, worse=worse)
        flash_bwd_pair(case, q, k, v, do, o, lse, 0.125, worse=worse)
    q, k, v, do = (randn((2, 6, 300, 64)) for _ in range(4))
    case = "B=2 H=6 S=300 contiguous, scale -0.125"
    o, lse = flash_fwd_pair(case, q, k, v, None, -0.125, worse=worse)
    flash_bwd_pair(case, q, k, v, do, o, lse, -0.125, worse=worse)

    # the backward's stage and item edges
    for s in FLASH_EDGES:
        q, k, v, do = (randn((2, 6, s, 64)) for _ in range(4))
        case = f"B=2 H=6 S={s} contiguous"
        o, lse = flash_fwd_pair(case, q, k, v, None, 0.125, worse=worse)
        flash_bwd_pair(case, q, k, v, do, o, lse, 0.125, worse=worse)

    # short sequences through the public function: K4a without a gradient,
    # K4a', K4b and K4b' with one, the same bits as the direct launches
    for s in FLASH_SHORT:
        q, k, v, do = (randn((4, 6, s, 64)) for _ in range(4))
        case = f"B=4 H=6 S={s} through fused_attention(force_kernel=True)"
        o, lse = flash_fwd_pair(case, q, k, v, None, 0.125, worse=worse)
        grads = flash_bwd_pair(case, q, k, v, do, o, lse, 0.125, worse=worse)
        before = dict(attention.LAUNCHES)
        via_api = attention.fused_attention(q, k, v, force_kernel=True)
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        with_grad = attention.fused_attention(*xs, scale=0.125, force_kernel=True)
        with_grad.backward(do)
        torch.cuda.synchronize()
        want = {name: before[name] + 1 for name in names}
        if ({name: attention.LAUNCHES[name] for name in names} != want
                or not torch.equal(via_api, o) or not torch.equal(with_grad, o)
                or not all(torch.equal(x.grad, g) for x, g in zip(xs, grads))):
            raise RuntimeError(f"fused_attention(force_kernel=True) did not take the flash "
                               f"kernels at {case}")
    print("[flash_fwd] [flash_bwd] two launches on the same inputs gave the same bits of o, "
          "lse, dq, dk and dv in every case")

    # the masked forward: keys at or past an element's length count for nothing
    for s, lens in FLASH_LENGTHS:
        b, h = len(lens), 6
        q, k, v, _, _, _ = flash_operands(gen, b, h, s, False)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        case = f"B={b} H={h} S={s} kv_lengths={lens}"
        o, lse = flash_fwd_pair(case, q, k, v, lengths, 0.125, worse=worse)
        via_api = attention.fused_attention(q, k, v, kv_lengths=lengths)
        torch.cuda.synchronize()
        if not torch.equal(via_api, o):
            raise RuntimeError("fused_attention(kv_lengths=...) did not take the forward kernel")
        if 0 in lens:
            empty = lens.index(0)
            if o[empty].any() or lse[empty].any():
                raise RuntimeError("an element with no valid key must give o = 0 and lse = 0")
            print("[flash_fwd] the element of length 0 gives o = 0 and lse = 0")
        full = lens.index(s)
        whole = attention.attention_reference(q[full:full + 1], k[full:full + 1],
                                              v[full:full + 1], lengths[full:full + 1])
        # another order of roundings (p normalised before it is rounded): the
        # whole-sequence kernels' bounds
        check_flash("flash_fwd o vs plain softmax attention", f"the full-length element, S={s}",
                    o[full:full + 1], whole, K_MAX_ABS, K_MEAN_ABS)
    return res


def mlp_bound(backward: bool, block: bool, rows, d, f) -> dict:
    """As ``attention_bound``: x (and dy) and the parameters read once, y (or
    dx and the fp32 parameter gradients) written once; two products forward,
    five backward, of 2 * rows * D * F operations each."""
    act, weights = rows * d * 2, (2 * d * f + d + f) * 2 + (2 * d * 4 if block else 0)
    if backward:
        nbytes = 3 * act + weights + (2 * d * f + d + f + (2 * d if block else 0)) * 4
        flops = 10 * rows * d * f
    else:
        nbytes, flops = 2 * act + weights, 4 * rows * d * f
    t_bytes, t_flops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bound_bytes": nbytes, "bound_flops": flops}


def check_mlp(name, case, got, want) -> float:
    """bf16 tensors against the absolute bounds, fp32 gradients against the
    relative one → the largest absolute error of the bf16 tensors."""
    worst = 0.0
    for label, a, b in zip(("out", "g1", "g2", "g3", "g4", "g5", "g6"), got, want):
        diff = (a.float() - b.float()).abs()
        mx, mean = diff.max().item(), diff.mean().item()
        ok = bool(torch.isfinite(a.float()).all()) and a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            worst = max(worst, mx)
            ok = ok and mx <= MLP_MAX_ABS and mean <= MLP_MEAN_ABS
            print(f"[{name}] {case} {label}: max_abs={mx:.3e} mean_abs={mean:.3e} "
                  f"(bounds {MLP_MAX_ABS}, {MLP_MEAN_ABS})")
        else:
            rel = mx / max(b.abs().max().item(), 1e-30)
            ok = ok and rel <= MLP_GRAD_REL
            print(f"[{name}] {case} {label} {tuple(a.shape)} fp32: max_abs={mx:.3e} = {rel:.3e} "
                  f"of the largest element (bound {MLP_GRAD_REL})")
        if not ok:
            raise RuntimeError(f"{name} disagrees with its plain version at {case} ({label})")
    return worst


def check_kernel(name, case, kernel_fn, plain_fn) -> float:
    """One launch against the plain version (``check_mlp``'s bounds); a
    backward kernel runs twice and must give the same bits."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    worst = check_mlp(name, case, got, want)
    if name.endswith("bwd"):
        again = kernel_fn()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{name}: two runs on the same inputs differ")
    return worst


def unfused_mlp(x, g, be, w1t, b1, w2t, b2, approx, block):
    """The route the port takes without the flag, on the same operands: library
    GEMMs with GELU (and fp32 LayerNorm and the residual sum) between them."""
    a = x
    if block:
        a = torch.nn.functional.layer_norm(x.float(), x.shape[-1:], g, be, 1e-6).to(x.dtype)
    h = torch.nn.functional.gelu(torch.nn.functional.linear(a, w1t, b1),
                                 approximate="tanh" if approx else "none")
    y = torch.nn.functional.linear(h, w2t, b2)
    return x + y if block else y


def phase_mlp_kernels(smi: str) -> dict:
    """K5f, K5b, K6f, K6b against their plain versions at MLP_SHAPES and at
    both widths at MLP_EDGE_ROWS; times at the student's global views (the
    sub-block forward at the serving chunk; K5f and K5b also at the local
    views), single and back to back, beside the plain version's, the unfused
    route's and the bound. The backward kernels run twice on the same inputs
    and must give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    names = ("mlp_fwd", "mlp_bwd", "mlp_block_fwd", "mlp_block_bwd")
    res = {name: {"max_abs_err": 0.0, "library_ms": None} for name in names}

    def randn(shape, std=1.0, dtype=torch.bfloat16):
        return (std * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    for shape in MLP_SHAPES:
        rows, d, f = shape
        x, dy = randn((rows, d)), randn((rows, d))
        g, be = 1.0 + randn((d,), 0.1, torch.float32), randn((d,), 0.1, torch.float32)
        w1, b1 = randn((d, f), d ** -0.5), randn((f,), 0.1)
        w2, b2 = randn((f, d), f ** -0.5), randn((d,), 0.1)
        for approx in ((True, False) if shape == MLP_SHAPES[1] else (True,)):
            case = f"rows={rows} D={d} F={f} {'tanh' if approx else 'erf'}"
            fns = {
                "mlp_fwd": (lambda: mlp._launch_mlp_fwd(x, w1, b1, w2, b2, approx),
                            lambda: mlp._mlp_fwd_reference(x, w1, b1, w2, b2, approx)),
                "mlp_bwd": (lambda: mlp._launch_mlp_bwd(x, dy, w1, b1, w2, approx),
                            lambda: mlp._mlp_bwd_reference(x, dy, w1, b1, w2, approx)),
                "mlp_block_fwd": (
                    lambda: mlp._launch_mlp_block_fwd(x, g, be, w1, b1, w2, b2, approx, 1e-6),
                    lambda: mlp._mlp_block_fwd_reference(x, g, be, w1, b1, w2, b2, approx, 1e-6)),
                "mlp_block_bwd": (
                    lambda: mlp._launch_mlp_block_bwd(x, dy, g, be, w1, b1, w2, approx, 1e-6),
                    lambda: mlp._mlp_block_bwd_reference(x, dy, g, be, w1, b1, w2, approx, 1e-6)),
            }
            for name in names:
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                               check_kernel(name, case, *fns[name]))
            timed = {MLP_SHAPES[0]: ("mlp_fwd", "mlp_bwd", "mlp_block_bwd"),
                     MLP_SHAPES[1]: ("mlp_fwd", "mlp_bwd"),
                     MLP_SHAPES[2]: ("mlp_block_fwd",)}.get(shape, ())
            if not approx or not timed:
                continue
            # the unfused route on nn.Linear's (out, in) weights
            leaves = [t.detach().requires_grad_() for t in
                      (x, g, be, w1.t().contiguous(), b1, w2.t().contiguous(), b2)]
            for name in timed:
                block = "block" in name
                if name.endswith("bwd"):
                    y_unfused = unfused_mlp(*leaves, approx, block)
                    wrt = leaves if block else [leaves[0], *leaves[3:]]

                    def unfused(y_unfused=y_unfused, wrt=wrt):
                        return torch.autograd.grad(y_unfused, wrt, dy, retain_graph=True)
                else:
                    def unfused(block=block):
                        with torch.no_grad():
                            return unfused_mlp(*leaves, approx, block)
                k1 = cuda_median_ms(fns[name][0])
                u1 = cuda_median_ms(unfused)
                u2 = cuda_median_ms(unfused)
                k2 = cuda_median_ms(fns[name][0])
                r = dict(ms=min(k1, k2), ms_runs=[k1, k2], unfused_ms=min(u1, u2),
                         unfused_ms_runs=[u1, u2],
                         plain_ms=cuda_median_ms(fns[name][1], reps=5, warmup=1),
                         **mlp_bound(name.endswith("bwd"), block, rows, d, f))
                if shape in MLP_TIMED_B2B or "block" in name:
                    # back to back in the order kernel, unfused, unfused, kernel
                    b2b = [back_to_back_ms(fns[name][0]), back_to_back_ms(unfused),
                           back_to_back_ms(unfused), back_to_back_ms(fns[name][0])]
                    r.update(b2b_ms=min(b2b[0], b2b[3]), b2b_ms_runs=[b2b[0], b2b[3]],
                             unfused_b2b_ms=min(b2b[1], b2b[2]),
                             unfused_b2b_ms_runs=[b2b[1], b2b[2]])
                    print(f"[{name}] {case}, 50 back to back (medians of 5, per launch) in "
                          f"the order kernel, unfused, unfused, kernel: kernel "
                          f"{r['b2b_ms_runs']} ms, unfused route {r['unfused_b2b_ms_runs']} ms, "
                          f"bound {r['bound_ms']:.4f} ms; on {smi}")
                res[name].setdefault("timed", []).append({"shape": [rows, d, f], **r})
                if shape == MLP_SHAPES[0] or name == "mlp_block_fwd":
                    res[name].update(r)
                print(f"[{name}] {case}, medians of 20 in the order kernel, unfused, unfused, "
                      f"kernel: kernel {r['ms_runs']} ms, unfused route (library GEMMs, GELU"
                      f"{', LayerNorm, residual sum' if block else ''}"
                      f"{', their autograd backward' if name.endswith('bwd') else ''}: several "
                      f"library calls) {r['unfused_ms_runs']} ms, plain {r['plain_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
                      f"({r['bound_bytes'] / 1e6:.1f} MB, {r['bound_flops'] / 1e9:.1f} GFLOP); "
                      f"no single library call computes it; on {smi}")
                del unfused
            del leaves
        del x, dy, g, be, w1, b1, w2, b2, fns
        torch.cuda.empty_cache()
    for d in (384, 768):
        f = 4 * d
        g, be = 1.0 + randn((d,), 0.1, torch.float32), randn((d,), 0.1, torch.float32)
        w1, b1 = randn((d, f), d ** -0.5), randn((f,), 0.1)
        w2, b2 = randn((f, d), f ** -0.5), randn((d,), 0.1)
        for rows in MLP_EDGE_ROWS:
            x, dy = randn((rows, d)), randn((rows, d))
            case = f"rows={rows} D={d} F={f} tanh"
            for name, fns in {
                    "mlp_fwd": (lambda: mlp._launch_mlp_fwd(x, w1, b1, w2, b2, True),
                                lambda: mlp._mlp_fwd_reference(x, w1, b1, w2, b2, True)),
                    "mlp_bwd": (lambda: mlp._launch_mlp_bwd(x, dy, w1, b1, w2, True),
                                lambda: mlp._mlp_bwd_reference(x, dy, w1, b1, w2, True)),
                    "mlp_block_fwd": (
                        lambda: mlp._launch_mlp_block_fwd(x, g, be, w1, b1, w2, b2, True, 1e-6),
                        lambda: mlp._mlp_block_fwd_reference(x, g, be, w1, b1, w2, b2, True,
                                                             1e-6)),
                    "mlp_block_bwd": (
                        lambda: mlp._launch_mlp_block_bwd(x, dy, g, be, w1, b1, w2, True, 1e-6),
                        lambda: mlp._mlp_block_bwd_reference(x, dy, g, be, w1, b1, w2, True,
                                                             1e-6))}.items():
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                               check_kernel(name, case, *fns))
    print("[mlp_bwd, mlp_block_bwd] two runs on the same inputs gave the same bits at every shape")
    return res


def dense_bound(name: str, rows, k, n) -> dict:
    """As ``attention_bound`` for one dense layer (rows, K) x (K, N): the
    activations, the weight (and the fp32 LayerNorm vectors) read once, the
    outputs (backward: dx and the fp32 parameter gradients) written once; one
    product forward, two backward, of 2 * rows * K * N operations each."""
    a, y, w, ln = rows * k * 2, rows * n * 2, k * n * 2, 2 * k * 4
    bwd = a + y + w + a + (k * n + n) * 4  # x, dy, W in; dx, dW, db out
    nbytes, flops = {
        "dense_bwd": (bwd, 4 * rows * k * n),
        "gemm_res_bwd": (bwd, 4 * rows * k * n),
        "ln_gemm_bwd": (bwd + 2 * ln, 4 * rows * k * n),
        "ln_gemm_fwd": (a + ln + w + n * 2 + y, 2 * rows * k * n),
        "gemm_res_fwd": (y + a + w + n * 2 + y, 2 * rows * k * n),
    }[name]
    t_bytes, t_flops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bound_bytes": nbytes, "bound_flops": flops}


def phase_dense_kernels(smi: str) -> dict:
    """K7 and K9a-d against their plain versions; times at the student's
    global views with the qkv layer (K7, K9a, K9b; K7 with the proj layer
    too) and the proj layer (K9c, K9d), single calls and back to back, beside
    one library route for the same function, the plain version's and the
    bound. The three backward kernels run twice on the same inputs and must
    give the same bits; K7, K9a and K9b also take W as nn.Linear keeps it (at
    width 384 read in place), K7 with the same dW and db bits, K9a and K9b
    with the same bits. Then K7, K9c, K9d, K9a and K9b at ``DENSE_EDGE_ROWS``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    F = torch.nn.functional
    names = ("dense_bwd", "ln_gemm_fwd", "ln_gemm_bwd", "gemm_res_fwd", "gemm_res_bwd")
    res = {name: {"max_abs_err": 0.0} for name in names}
    library = {
        "dense_bwd": "autograd backward of F.linear",
        "gemm_res_bwd": "autograd backward of F.linear",
        "ln_gemm_fwd": "F.layer_norm in fp32, cast, F.linear",
        "ln_gemm_bwd": "autograd backward of F.layer_norm in fp32, cast, F.linear",
        "gemm_res_fwd": "F.linear, add",
    }

    def randn(shape, std=1.0, dtype=torch.bfloat16):
        return (std * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    for shape in DENSE_SHAPES:
        rows, k, n = shape
        case = f"rows={rows} K={k} N={n}"
        forward_only = rows > 100000
        x, resid = randn((rows, k)), randn((rows, n))
        dy = None if forward_only else randn((rows, n))
        g, be = 1.0 + randn((k,), 0.1, torch.float32), randn((k,), 0.1, torch.float32)
        w, b = randn((k, n), k ** -0.5), randn((n,), 0.1)
        fns = {
            "dense_bwd": (lambda: dense._launch_dense_bwd(x, dy, w),
                          lambda: dense._dense_bwd_reference(x, dy, w)),
            "ln_gemm_fwd": (lambda: mlp._launch_ln_gemm_fwd(x, g, be, w, b, 1e-6),
                            lambda: mlp._ln_gemm_fwd_reference(x, g, be, w, b, 1e-6)),
            "ln_gemm_bwd": (lambda: mlp._launch_ln_gemm_bwd(x, dy, g, be, w, 1e-6),
                            lambda: mlp._ln_gemm_bwd_reference(x, dy, g, be, w, 1e-6)),
            "gemm_res_fwd": (lambda: mlp._launch_gemm_res_fwd(resid, x, w, b),
                             lambda: mlp._gemm_res_fwd_reference(resid, x, w, b)),
            "gemm_res_bwd": (lambda: mlp._launch_gemm_res_bwd(x, dy, w),
                             lambda: mlp._gemm_res_bwd_reference(x, dy, w)),
        }
        here = [name for name in names
                if (n in mlp.KERNEL_WIDTHS or not name.startswith("gemm_res"))
                and not (forward_only and name.endswith("bwd"))]
        for name in here:
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                           check_kernel(name, case, *fns[name]))
        if dy is not None:
            res["dense_bwd"]["max_abs_err"] = max(res["dense_bwd"]["max_abs_err"],
                                                  check_linear_layout(case, x, dy, w))
        if k in mlp.LINEAR_LAYOUT_WIDTHS:
            check_ln_layout(case, x, dy, g, be, w, b)
        timed = {DENSE_SHAPES[0]: ("dense_bwd", "ln_gemm_fwd", "ln_gemm_bwd"),
                 DENSE_SHAPES[1]: ("dense_bwd", "gemm_res_fwd", "gemm_res_bwd")}.get(shape, ())
        if timed:
            # the library routes on nn.Linear's (out, in) weight
            xl, gl, bel, wl, bl = (t.detach().requires_grad_() for t in
                                   (x, g, be, w.t().contiguous(), b))
            y_linear = F.linear(xl, wl, bl)
            y_ln = F.linear(F.layer_norm(xl.float(), (k,), gl, bel, 1e-6).to(x.dtype), wl, bl)

            def ln_linear():
                with torch.no_grad():
                    return F.linear(F.layer_norm(x.float(), (k,), g, be, 1e-6).to(x.dtype), wl, bl)

            def linear_add():
                with torch.no_grad():
                    return resid + F.linear(x, wl, bl)

            def linear_bwd():
                return torch.autograd.grad(y_linear, (xl, wl, bl), dy, retain_graph=True)

            lib_fns = {
                "dense_bwd": linear_bwd, "gemm_res_bwd": linear_bwd, "ln_gemm_fwd": ln_linear,
                "gemm_res_fwd": linear_add,
                "ln_gemm_bwd": lambda: torch.autograd.grad(y_ln, (xl, gl, bel, wl, bl), dy,
                                                           retain_graph=True),
            }
            for name in timed:
                t = timed_ab(fns[name][0], lib_fns[name], fns[name][1])
                t.update(dense_bound(name, rows, k, n), shape=list(shape), library=library[name],
                         back_to_back_ms=back_to_back_ms(fns[name][0]),
                         library_back_to_back_ms=back_to_back_ms(lib_fns[name]))
                if name == "dense_bwd":  # on nn.Linear's weight, as the model passes it
                    t["linear_layout_ms"] = cuda_median_ms(
                        lambda: dense._launch_dense_bwd(x, dy, wl.detach().t()))
                print(f"[{name}] {case}, medians of 20 in the order kernel, library, library, "
                      f"kernel: kernel {t['ms_runs']} ms"
                      + (f" (nn.Linear's layout {t['linear_layout_ms']:.4f})"
                         if name == "dense_bwd" else "")
                      + f", library ({library[name]}) {t['library_ms_runs']} ms; 50 back to "
                      f"back (median of 5, per launch): kernel {t['back_to_back_ms']:.4f} ms, "
                      f"library {t['library_back_to_back_ms']:.4f} ms; plain "
                      f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
                      f"{t['bound_by']} ({t['bound_bytes'] / 1e6:.1f} MB, "
                      f"{t['bound_flops'] / 1e9:.1f} GFLOP); on {smi}")
                if "ms" in res[name]:  # K7's second shape, the proj layer
                    res[name]["proj_layer"] = t
                else:
                    res[name].update(t)
            del xl, gl, bel, wl, bl, y_linear, y_ln, lib_fns
        del x, resid, dy, g, be, w, b, fns
        torch.cuda.empty_cache()
    for rows in DENSE_EDGE_ROWS:
        k = 384
        for n in (3 * k, k):  # K7 at the qkv and proj layers
            x, dy, w = randn((rows, k)), randn((rows, n)), randn((k, n), k ** -0.5)
            case = f"rows={rows} K={k} N={n}"
            res["dense_bwd"]["max_abs_err"] = max(
                res["dense_bwd"]["max_abs_err"],
                check_kernel("dense_bwd", case, lambda: dense._launch_dense_bwd(x, dy, w),
                             lambda: dense._dense_bwd_reference(x, dy, w)),
                check_linear_layout(case, x, dy, w))
        for n in (3 * k, k):  # K9a and K9b at the qkv and proj layers, both weight layouts
            x, dy = randn((rows, k)), randn((rows, n))
            g, be = 1.0 + randn((k,), 0.1, torch.float32), randn((k,), 0.1, torch.float32)
            w, b = randn((k, n), k ** -0.5), randn((n,), 0.1)
            case = f"rows={rows} K={k} N={n}"
            for name, fns in {
                "ln_gemm_fwd": (lambda: mlp._launch_ln_gemm_fwd(x, g, be, w, b, 1e-6),
                                lambda: mlp._ln_gemm_fwd_reference(x, g, be, w, b, 1e-6)),
                "ln_gemm_bwd": (lambda: mlp._launch_ln_gemm_bwd(x, dy, g, be, w, 1e-6),
                                lambda: mlp._ln_gemm_bwd_reference(x, dy, g, be, w, 1e-6)),
            }.items():
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                               check_kernel(name, case, *fns))
            check_ln_layout(case, x, dy, g, be, w, b)
        for f in (384, 768):  # K9c by its input width, K9d by its output width
            a, resid, dy = randn((rows, f)), randn((rows, k)), randn((rows, f))
            w, b, wd = randn((f, k), f ** -0.5), randn((k,), 0.1), randn((k, f), k ** -0.5)
            xk = randn((rows, k))
            res["gemm_res_fwd"]["max_abs_err"] = max(
                res["gemm_res_fwd"]["max_abs_err"],
                check_kernel("gemm_res_fwd", f"rows={rows} f={f} d={k}",
                             lambda: mlp._launch_gemm_res_fwd(resid, a, w, b),
                             lambda: mlp._gemm_res_fwd_reference(resid, a, w, b)))
            res["gemm_res_bwd"]["max_abs_err"] = max(
                res["gemm_res_bwd"]["max_abs_err"],
                check_kernel("gemm_res_bwd", f"rows={rows} f={k} d={f}",
                             lambda: mlp._launch_gemm_res_bwd(xk, dy, wd),
                             lambda: mlp._gemm_res_bwd_reference(xk, dy, wd)))
    print("[dense_bwd, ln_gemm_bwd, gemm_res_bwd] two runs on the same inputs gave the same "
          f"bits at every shape; K7, K9c, K9d, K9a, K9b also at rows {DENSE_EDGE_ROWS}")
    return res


def check_ln_layout(case, x, dy, g, be, w, b) -> None:
    """K9a and K9b (``dy`` None: K9a alone) on nn.Linear's (N, K) weight, read
    in place (layout 1): the same bits as from the (K, N) weight."""
    wl = w.t().contiguous()
    pairs = [(mlp._launch_ln_gemm_fwd(x, g, be, wl, b, 1e-6, 1),
              mlp._launch_ln_gemm_fwd(x, g, be, w, b, 1e-6))]
    if dy is not None:
        pairs += zip(mlp._launch_ln_gemm_bwd(x, dy, g, be, wl, 1e-6, 1),
                     mlp._launch_ln_gemm_bwd(x, dy, g, be, w, 1e-6))
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in pairs):
        raise RuntimeError(f"ln_gemm at {case}: nn.Linear's layout gave other bits")
    print(f"[ln_gemm_fwd, ln_gemm_bwd] {case}: nn.Linear's layout read in place, the same bits")


def check_linear_layout(case, x, dy, w) -> float:
    """K7 on nn.Linear's (N, K) weight, passed as its transposed view, as the
    ViT passes it: against the plain version, and dW, db with the same bits as
    from the (K, N) weight (they do not read W)."""
    wl = w.t().contiguous()
    got = dense._launch_dense_bwd(x, dy, wl.t())
    want = dense._dense_bwd_reference(x, dy, w)
    kn = dense._launch_dense_bwd(x, dy, w)
    torch.cuda.synchronize()
    worst = check_mlp("dense_bwd", f"{case}, nn.Linear's layout", got, want)
    if not all(torch.equal(a, b) for a, b in zip(got[1:], kn[1:])):
        raise RuntimeError(f"dense_bwd at {case}: dW, db differ between the two weight layouts")
    return worst


def attn_block_bound(backward: bool, b, n, d) -> dict:
    """As ``attention_bound`` for the sub-block: x (and dy) and the parameters
    read once, y (or dx and the fp32 parameter gradients) written once. Per
    token the forward is the qkv product (2 D 3D), the projection (2 D D) and
    two attention products (2 N D each); the backward needs five GEMM-sized
    products (qkv again, dWqkv, dln: 2 D 3D each; dWproj, do: 2 D D each) and
    six attention-sized ones (s, o, dP, dV, dQ, dK)."""
    act, weights = b * n * d * 2, (4 * d * d + 4 * d) * 2 + 2 * d * 4
    if backward:
        nbytes = 3 * act + weights + (4 * d * d + 4 * d + 2 * d) * 4
        flops = b * n * (3 * 6 * d * d + 2 * 2 * d * d + 12 * n * d)
    else:
        nbytes, flops = 2 * act + weights, b * n * (6 * d * d + 2 * d * d + 4 * n * d)
    t_bytes, t_flops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bound_bytes": nbytes, "bound_flops": flops}


def tuned_block(gamma, beta, wqkv, bqkv, wp, bp, model=MODEL):
    """One block of the tuned ViT (``model``, ViT-S/16 by default) on the
    card, its attention half holding these parameters (the ops' ``(in, out)``
    weights in nn.Linear's layout)."""
    base = create_model(model, num_classes=2, img_size=TILE).config
    blk = VisionTransformer(dataclasses.replace(base, depth=1, **tuned_vit_kwargs(True))).blocks[0]
    with torch.no_grad():
        for dst, src in ((blk.norm1.weight, gamma), (blk.norm1.bias, beta),
                         (blk.attn.qkv.weight, wqkv.t()), (blk.attn.qkv.bias, bqkv),
                         (blk.attn.proj.weight, wp.t()), (blk.attn.proj.bias, bp)):
            dst.copy_(src.float())
    return blk.cuda()


def unfused_attention_half(blk, x, training: bool):
    """The route the model takes: its own norm1, attention and residual sum."""
    return x + blk.attn(blk.norm1(x).to(x.dtype), deterministic=not training)


def attention_half_as_one_op(blk, x):
    """One block's attention half, ``x + attn(norm1(x))``, as ONE launch on
    that block's parameters (nn.Linear weights are ``(out, in)``; the op takes
    ``(in, out)``)."""
    return attention.fused_attention_block(
        x, blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight.t(), blk.attn.qkv.bias,
        blk.attn.proj.weight.t(), blk.attn.proj.bias, blk.attn.num_heads, eps=blk.norm1.eps)


def phase_attn_block_kernels(smi: str) -> dict:
    """K8f and K8b against their plain versions; times at the student's global
    views, one serving chunk and a batch of 8 tiles (forward), beside the
    unfused route's (the model's own norm1 + attention + residual sum, and its
    autograd backward: no single library call computes this function), the
    plain version's and the bound. The backward runs twice on the same inputs
    and must give the same bits in all seven outputs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    names = ("attn_block_fwd", "attn_block_bwd")
    res = {name: {"max_abs_err": 0.0, "library_ms": None} for name in names}

    def randn(shape, std=1.0, dtype=torch.bfloat16):
        return (std * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    def operands(b, n, d):
        return (randn((b, n, d)), 1.0 + randn((d,), 0.1, torch.float32),
                randn((d,), 0.1, torch.float32), randn((d, 3 * d), d ** -0.5),
                randn((3 * d,), 0.1), randn((d, d), d ** -0.5), randn((d,), 0.1))

    for b, n, d, h, what in ATTN_BLOCK_SHAPES:
        case = f"B={b} N={n} D={d} H={h}"
        scale = (d // h) ** -0.5
        x, g, be, wqkv, bqkv, wp, bp = operands(b, n, d)
        dy = randn((b, n, d))
        fns = {
            "attn_block_fwd": (
                lambda: attention._launch_attn_block_fwd(x, g, be, wqkv, bqkv, wp, bp, h, scale,
                                                         1e-6),
                lambda: attention._attn_block_fwd_reference(x, g, be, wqkv, bqkv, wp, bp, h,
                                                            scale, 1e-6)),
            "attn_block_bwd": (
                lambda: attention._launch_attn_block_bwd(x, dy, g, be, wqkv, bqkv, wp, h, scale,
                                                         1e-6),
                lambda: attention._attn_block_bwd_reference(x, dy, g, be, wqkv, bqkv, wp, h,
                                                            scale, 1e-6)),
        }
        for name in names if what == "both" else names[:1]:
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                           check_kernel(name, case, *fns[name]))
        timed = ATTN_BLOCK_TIMED.get((b, n), ())
        if timed:
            blk = tuned_block(g, be, wqkv, bqkv, wp, bp, ATTN_BLOCK_MODELS[d])
            xl = x.detach().requires_grad_()
            leaves = [xl, blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight,
                      blk.attn.qkv.bias, blk.attn.proj.weight, blk.attn.proj.bias]
        for name in timed:
            if name.endswith("bwd"):
                y_unfused = unfused_attention_half(blk, xl, True)

                def unfused(y_unfused=y_unfused):
                    return torch.autograd.grad(y_unfused, leaves, dy, retain_graph=True)
            else:
                def unfused():
                    with torch.no_grad():
                        return unfused_attention_half(blk, x, False)
            k1 = cuda_median_ms(fns[name][0])
            u1 = cuda_median_ms(unfused)
            u2 = cuda_median_ms(unfused)
            k2 = cuda_median_ms(fns[name][0])
            t = dict(ms=min(k1, k2), ms_runs=[k1, k2], unfused_ms=min(u1, u2),
                     unfused_ms_runs=[u1, u2], shape=[b, n, d, h],
                     plain_ms=cuda_median_ms(fns[name][1], reps=5, warmup=1),
                     **attn_block_bound(name.endswith("bwd"), b, n, d))
            launch_note = ("; one launch from the host costs more than this bound"
                           if t["bound_ms"] < 0.01 else "")
            print(f"[{name}] {case}, medians of 20 in the order kernel, unfused, unfused, kernel: "
                  f"kernel {t['ms_runs']} ms, unfused route (the model's norm1 + attention + "
                  f"residual sum{', their autograd backward' if name.endswith('bwd') else ''}: "
                  f"several library calls and the attention kernels) {t['unfused_ms_runs']} ms, "
                  f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
                  f"({t['bound_bytes'] / 1e6:.1f} MB, {t['bound_flops'] / 1e9:.1f} GFLOP)"
                  f"{launch_note}; no single library call computes it; on {smi}")
            if "ms" in res[name]:  # the forward's later shapes
                res[name].setdefault("other_shapes", []).append(t)
            else:
                res[name].update(t)
            del unfused
        if timed:
            del blk, xl, leaves
        del x, dy, g, be, wqkv, bqkv, wp, bp, fns
        torch.cuda.empty_cache()
    print("[attn_block_bwd] two runs on the same inputs gave the same bits in all seven outputs "
          "at every shape")

    # ViT-B/16 through the op and autograd: one launch of each kernel, values
    # and all seven gradients against the plain versions
    b, n, d, h = ATTN_BLOCK_OP
    x, g, be, wqkv, bqkv, wp, bp = operands(b, n, d)
    dy = randn((b, n, d))
    params = [p.float().requires_grad_() for p in (g, be, wqkv, bqkv, wp, bp)]
    xl = x.detach().requires_grad_()
    reset_launches()
    y = attention.fused_attention_block(xl, *params, h)
    got = (y, *torch.autograd.grad(y, [xl, *params], dy))
    torch.cuda.synchronize()
    launches = {k: c for k, c in all_launches().items() if c}
    if launches != {"attn_block_fwd": 1, "attn_block_bwd": 1}:
        raise RuntimeError(f"fused_attention_block at ViT-B launched {launches}")
    scale = (d // h) ** -0.5
    want = (attention._attn_block_fwd_reference(x, g, be, wqkv, bqkv, wp, bp, h, scale, 1e-6),
            *attention._attn_block_bwd_reference(x, dy, g, be, wqkv, bqkv, wp, h, scale, 1e-6))
    got = tuple(a.detach() for a in got)
    check_mlp("attn_block op", f"B={b} N={n} D={d} H={h} through autograd", got[:2], want[:2])
    for i, (label, a, w) in enumerate(zip(("dgamma", "dbeta", "dWqkv", "dbqkv", "dWproj",
                                           "dbproj"), got[2:], want[2:])):
        # the op rounds the weights' gradients to their bf16 on the way to the
        # fp32 parameters, as the reference's vjp does; LayerNorm's stay fp32
        bound = MLP_GRAD_REL if i < 2 else ROUNDED_GRAD_REL
        w = w if i < 2 else w.bfloat16().float()
        rel = (a.float() - w.float()).abs().max().item() / max(w.float().abs().max().item(), 1e-30)
        print(f"[attn_block op] B={b} N={n} D={d} H={h} {label} {tuple(a.shape)}: "
              f"{rel:.3e} of the largest element (bound {bound})")
        if not bool(torch.isfinite(a).all()) or rel > bound:
            raise RuntimeError(f"fused_attention_block at ViT-B disagrees in {label}")
    print(f"[attn_block op] B={b} N={n} D={d} H={h}: launches {launches}, values and gradients "
          "against the plain versions")

    # a width no kernel is built for: refused by name before any launch
    b, n, d, h = ATTN_BLOCK_REFUSED
    x, g, be, wqkv, bqkv, wp, bp = operands(b, n, d)
    before = dict(attention.LAUNCHES)
    try:
        attention.fused_attention_block(x, g, be, wqkv, bqkv, wp, bp, h)
    except NotImplementedError as e:
        print(f"[attn_block_fwd] B={b} N={n} D={d} H={h}: refused before any launch: {e}")
    else:
        raise RuntimeError("the sub-block op took operands of a width its kernels lack")
    if attention.LAUNCHES != before:
        raise RuntimeError("a refused call counted a launch")
    return res


def flax_vit_tree(cfg, seed: int) -> dict:
    """Seeded random ViT parameters in the JAX package's flax layout.

    Body kernels are LeCun-normal, so activations keep unit scale through
    the depth and attention is far from uniform (the package's own std-0.02
    init would leave every score near 0). The head keeps the package's init,
    std 0.02, as a freshly built classifier has it."""
    rng = np.random.default_rng(seed)
    d, p, c = cfg.embed_dim, cfg.patch_size, cfg.in_chans
    hidden = int(d * cfg.mlp_ratio)

    def normal(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def dense(fan_in, fan_out, std=None):
        return {"kernel": normal((fan_in, fan_out), std or fan_in ** -0.5),
                "bias": normal((fan_out,), 0.02)}

    def ln():
        return {"scale": 1.0 + normal((d,), 0.1), "bias": normal((d,), 0.02)}

    params = {
        "patch_embed": {"proj": dense(p * p * c, d)},
        "cls_token": normal((1, 1, d), 0.02),
        "pos_embed": normal((1, cfg.num_patches + 1, d), 0.02),
        "norm": ln(),
        "head": dense(d, cfg.num_classes, std=0.02),
    }
    for i in range(cfg.depth):
        params[f"blocks_{i}"] = {
            "norm1": ln(), "norm2": ln(),
            "attn": {"qkv": dense(d, 3 * d), "proj": dense(d, d)},
            "mlp": {"fc1": dense(d, hidden), "fc2": dense(hidden, d)},
        }
    return {"params": params}


def make_chunks(seed: int, valid=VALID, tiles_per_iter=TILES_PER_ITER,
                tile=TILE) -> list[InferChunk]:
    """One padded chunk of ``tiles_per_iter`` uint8 tiles per slide, the
    first ``valid[s]`` of them real."""
    rng = np.random.default_rng(seed)
    chunks = []
    for s, k in enumerate(valid):
        images = rng.integers(0, 256, (tiles_per_iter, tile, tile, 3), dtype=np.uint8)
        chunks.append(InferChunk(
            images=images, mask=np.arange(tiles_per_iter) < k,
            label=np.array([s % 2]), slide_index=s, slide_name=f"slide_{s}.svs",
            patient_barcode=f"patient_{s}", slide_dataset="synthetic",
            initial_num_tiles=k, is_last_batch=True,
            locations=[(tile * (j // 32), tile * (j % 32)) for j in range(k)]))
    return chunks


def timed_extract(chunks, model, params, out_dir, dev):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agg = extract_features(chunks, model, params, str(out_dir), dev, dispatch_ahead=4)
    return agg, time.perf_counter() - t0


def phase_slice(smi: str, name=MODEL, tile=TILE, tiles_per_iter=TILES_PER_ITER, valid=VALID,
                kernels=("mha_qkv_fwd",), tag="slice", model_kw=None, other_kw=None,
                other="plain attention") -> dict:
    """The serving slice → launches per kernel; ``kernels`` are those that
    every layer of every chunk's forward must launch once, and no other may
    be launched. The model built with ``model_kw`` is held against the one
    built with ``other_kw`` (by default: every attention call on the plain
    version), called ``other`` in the lines printed."""
    dev = torch.device("cuda")
    model = create_model(name, num_classes=2, img_size=tile, **(model_kw or {}))
    plain = create_model(name, num_classes=2, img_size=tile,
                         **({"use_kernel_attention": False} if other_kw is None else other_kw))
    cfg = model.config
    params = params_from_flax(flax_vit_tree(cfg, SEED))
    t0 = time.perf_counter()
    chunks = make_chunks(SEED, valid, tiles_per_iter, tile)
    n_valid, n_slides = sum(valid), len(valid)
    out_dir = OUT / tag
    print(f"[{tag}] {name} img {tile} ({cfg.num_patches + 1} tokens) depth {cfg.depth} dim "
          f"{cfg.embed_dim} {cfg.dtype}; {n_slides} slides x {tiles_per_iter} tiles, {n_valid} "
          f"valid; chunks made in {time.perf_counter() - t0:.1f} s")
    for m in (model, plain):  # warm-up: cuBLAS handles, allocator, kernel load
        extract_features(chunks[:1], m, params, str(out_dir / "warmup"), dev)
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    agg, t_kernel = timed_extract(chunks, model, params, out_dir / "kernel", dev)
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    expected = {**dict.fromkeys(launches, 0),
                **dict.fromkeys(kernels, cfg.depth * len(chunks))}
    print(f"[{tag}] launches {launches} (expected {', '.join(kernels)}: depth {cfg.depth} x "
          f"{len(chunks)} forwards each, no other kernel)")
    if launches != expected:
        raise RuntimeError("the serving path did not run its kernels once per layer")

    feats = np.concatenate([r.features for r in agg.results])
    probs = np.concatenate([r.tile_probs for r in agg.results])
    if feats.shape != (n_valid, cfg.embed_dim) or not np.isfinite(feats).all():
        raise RuntimeError(f"features: shape {feats.shape}, finite {np.isfinite(feats).all()}")
    if not (np.isfinite(probs).all() and probs.min() >= 0.0 and probs.max() <= 1.0):
        raise RuntimeError("tile probabilities outside [0, 1]")
    written = sorted(os.listdir(out_dir / "kernel" / "features"))
    want = sorted([f"slide_{s}_features.pt" for s in range(n_slides)] + ["inference.data"])
    if written != want:
        raise RuntimeError(f"feature files: {written}")

    agg_plain, t_plain = timed_extract(chunks, plain, params, out_dir / "plain", dev)
    _, t_plain_2 = timed_extract(chunks, plain, params, out_dir / "plain", dev)
    _, t_kernel_2 = timed_extract(chunks, model, params, out_dir / "kernel_2", dev)
    SERVING_TILES_S[tag] = (n_valid / t_kernel, n_valid / t_kernel_2)
    feats_p = np.concatenate([r.features for r in agg_plain.results])
    probs_p = np.concatenate([r.tile_probs for r in agg_plain.results])
    cos = (feats * feats_p).sum(1) / (
        np.linalg.norm(feats, axis=1) * np.linalg.norm(feats_p, axis=1))
    dprob = float(np.abs(probs - probs_p).max())
    print(f"[{tag}] kernel path vs {other}: min per-tile feature cosine "
          f"{cos.min():.6f} (>= {FEAT_COSINE_MIN}), max probs diff {dprob:.3e} "
          f"(<= {PROBS_MAX_DIFF}); slide AUC {agg.slide_auc():.4f} / "
          f"{agg_plain.slide_auc():.4f}")
    if cos.min() < FEAT_COSINE_MIN or dprob > PROBS_MAX_DIFF:
        raise RuntimeError(f"the kernel path and {other} disagree")
    print(f"[{tag}] extract_features wall time (normalize + forward + fetch + "
          f"aggregation + files), {n_valid} valid tiles, run order kernel path, {other}, "
          f"{other}, kernel path: kernel path {t_kernel:.4f} / {t_kernel_2:.4f} s = "
          f"{n_valid / t_kernel:.1f} / {n_valid / t_kernel_2:.1f} tiles/s; {other} "
          f"{t_plain:.4f} / {t_plain_2:.4f} s = {n_valid / t_plain:.1f} / "
          f"{n_valid / t_plain_2:.1f} tiles/s; peak device memory (kernel run) "
          f"{peak / 2**30:.2f} GiB; on {smi}")
    return launches


def train_bundle(vit_overrides=None, argv=TRAIN_ARGV):
    args = parse_args(argv)
    return ssl_step_bundle(args, STEPS_PER_EPOCH, TRAIN_BATCH, torch.device("cuda"),
                           vit_overrides=vit_overrides)


def train_batch() -> dict:
    rng = np.random.default_rng(SEED)
    return {"images": torch.from_numpy(
        rng.integers(0, 256, (TRAIN_BATCH, TILE, TILE, 3), dtype=np.uint8)).cuda()}


def run_steps(bundle, batch, n_steps: int):
    """→ per step: loss, gradient norm, launches, milliseconds (CUDA events)."""
    rows = []
    for _ in range(n_steps):
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, metrics = bundle.raw_step(bundle.state, batch, bundle.generator)
        end.record()
        end.synchronize()
        rows.append({"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
                     "launches": all_launches(), "ms": start.elapsed_time(end)})
    return rows


def check_losses(tag, rows, plain_rows, other="plain attention"):
    for i, (a, b) in enumerate(zip(rows, plain_rows)):
        print(f"[train] {tag} step {i}: loss kernel path {a['loss']:.6f}, {other} "
              f"{b['loss']:.6f} (|diff| <= {LOSS_MAX_DIFF})")
        if not abs(a["loss"] - b["loss"]) <= LOSS_MAX_DIFF:
            raise RuntimeError(f"{tag}: the kernel path and {other} disagree at step {i}")


# kernel-name fragments → kind, first match wins
PROFILE_KINDS = [
    ("attention kernels (hand-written)", ("mha_qkv", "flash_fwd_kernel", "flash_bwd_d")),
    ("fused MLP kernels (hand-written)", ("mlp_fwd_kernel", "mlp_bwd_d", "mlp_row_kernel",
                                          "mlp_dw_kernel")),
    ("dense-layer kernels (hand-written)", ("dense_bwd_d", "row_gemm_fwd", "dense_row_kernel",
                                            "dense_dw_kernel")),
    ("fixed-order sums of partial gradients (hand-written)", ("sum_partials",)),
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "cutlass", "cublas", "gemv")),
    ("LayerNorm, forward and backward", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("GELU, forward and backward", ("Gelu", "gelu")),
    ("softmax and log-softmax", ("softmax", "Softmax")),
    ("foreach kernels (AdamW, EMA, clip)", ("multi_tensor",)),
    ("copies and casts", ("copy", "Copy", "Memcpy", "memcpy", "Memset")),
    ("reductions (sums, means, norms)", ("reduce", "Reduce")),
    ("random numbers", ("distribution", "philox")),
    ("gather, index, cat", ("gather", "index", "Cat", "cat_")),
]


# (tag, vit_overrides, argv, ms per step): steps to profile once every time
# has been taken. A process that has run torch.profiler once launches kernels
# more slowly from then on, so no timed phase may come after a profile.
PROFILES = []


def phase_profiles(smi: str) -> None:
    batch = train_batch()
    for tag, overrides, argv, ms in PROFILES:
        bundle = train_bundle(overrides, argv)
        run_steps(bundle, batch, WARMUP_STEPS)
        profile_step(tag, bundle, batch, ms, smi)
        del bundle
        torch.cuda.empty_cache()
    profile_sup_loop(smi)


def union_ms(intervals, lo: float, hi: float) -> float:
    """Milliseconds of [lo, hi] (microseconds) covered by the sorted
    ``(start, end)`` intervals."""
    covered, reach = 0.0, lo
    for a, b in intervals:
        a, b = max(a, reach), min(b, hi)
        if b > a:
            covered += b - a
            reach = b
    return covered / 1e3


def profile_sup_loop(smi: str) -> None:
    """[profile] train_sup: ``cli.train.main`` (supervised) over the cohort
    as [train_sup] runs it, under torch.profiler from the first step on,
    each step marked: between consecutive step starts within an epoch (the
    run's first step left out), the time the device ran a kernel or copy,
    from the kernels' own trace events, beside [train_sup]'s unprofiled loop
    period and stream time. The profiler slows the host's launches, so the
    idle share it shows is an upper bound of the loop's without it. Deletes
    the cohort."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    marker, real = "train_sup_step", cli_train.make_train_step
    prof, calls = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]), []

    def marked_step(*a, **kw):
        step = real(*a, **kw)

        def marked(state, batch, generator=None):
            if not calls:
                prof.start()
            calls.append(None)
            with record_function(marker):
                return step(state, batch, generator)

        return marked

    argv = SUP_ARGV + ["--epochs", str(SUP_EPOCHS), "--max-steps-per-epoch", str(SUP_STEPS),
                       "--output", str(SUP_RUNS / "profile")]
    cli_train.make_train_step = marked_step
    try:
        cli_train.main(argv)
    finally:
        cli_train.make_train_step = real
        if calls:
            torch.cuda.synchronize()
            prof.stop()
    events = prof.events()
    starts = sorted(e.time_range.start for e in events
                    if e.name == marker and e.device_type == DeviceType.CPU)
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CUDA and e.name != marker)
    if len(starts) != SUP_EPOCHS * SUP_STEPS or not device:
        raise RuntimeError(f"[profile] train_sup: {len(starts)} marked steps, {len(device)} "
                           f"device events")
    windows = [w for e in range(SUP_EPOCHS)
               for w in zip(starts[e * SUP_STEPS:(e + 1) * SUP_STEPS],
                            starts[e * SUP_STEPS + 1:(e + 1) * SUP_STEPS])][1:]
    busy = [union_ms(device, a, b) for a, b in windows]
    spans = [(b - a) / 1e3 for a, b in windows]
    share = sum(busy) / sum(spans)
    print(f"[profile] train_sup: the supervised loop under torch.profiler, {len(windows)} "
          f"periods between step starts within an epoch, after the first step: "
          f"{', '.join(f'{x:.2f}' for x in spans)} ms, the device busy (kernels and copies) "
          f"{', '.join(f'{x:.2f}' for x in busy)} ms of them = {100 * share:.1f}% (idle "
          f"{100 * (1 - share):.1f}%, an upper bound of the idle share without the profiler); "
          f"busy {statistics.median(busy):.2f} ms a step against [train_sup]'s unprofiled loop "
          f"period {STEP_MS['train_sup_loop']:.2f} ms and stream time "
          f"{STEP_MS['train_sup_stream']:.2f} ms (medians); on {smi}")
    shutil.rmtree(SUP_RUNS, ignore_errors=True)
    shutil.rmtree(WSI_ROOT, ignore_errors=True)
    torch.cuda.empty_cache()


def profile_step(tag: str, bundle, batch, step_ms: float, smi: str) -> dict:
    """Two steps under torch.profiler, the second reported (the first pays
    for the profiler's start): device time by kernel kind, from the kernels'
    own trace events. → ms by kind (empty if the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            bundle.raw_step(bundle.state, batch, bundle.generator)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        print("[profile] torch.profiler recorded no device time")
        return {}
    totals, counts = {}, {}
    for evt in kernels:
        kind = next((k for k, pats in PROFILE_KINDS if any(p in evt.key for p in pats)),
                    "other elementwise (mul, add, where, clamp, ...)")
        totals[kind] = totals.get(kind, 0.0) + evt.self_device_time_total / 1e3
        counts[kind] = counts.get(kind, 0) + evt.count
    device_ms = sum(totals.values())
    print(f"[profile] {tag}: one step under torch.profiler ({wall_ms:.1f} ms of wall with the "
          f"profiler on): kernel time {device_ms:.1f} ms in {sum(counts.values())} kernels and "
          f"copies = {100 * min(device_ms / step_ms, 1):.0f}% of the {step_ms:.1f} ms a step "
          f"takes without the profiler, the rest being device idle time; on {smi}")
    for kind, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {kind}: {ms:.2f} ms ({100 * ms / device_ms:.1f}%), "
              f"{counts[kind]} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   top: {e.self_device_time_total / 1e3:.2f} ms x{e.count} {e.key[:100]}")
    return totals


def phase_train(smi: str) -> dict:
    """The DINO step on the tuned path, against plain attention, and on the
    recomputing-backward path; → launches per kernel over the kernel-path runs."""
    batch = train_batch()
    total = dict.fromkeys(all_launches(), 0)

    def count(rows):
        for r in rows:
            for name, n in r["launches"].items():
                total[name] += n

    # -- tuned path: saved probabilities --
    bundle = train_bundle()
    cfg = bundle.model.backbone.config
    depth = cfg.depth
    n_views = bundle.dcfg.n_global + bundle.dcfg.n_local
    print(f"[train] {TRAIN_ARGV[2]} depth {depth} dim {cfg.embed_dim} head "
          f"{bundle.dcfg.out_dim} {cfg.dtype} ln {cfg.ln_dtype} drop_path {cfg.drop_path_rate} "
          f"save_probs {cfg.attn_save_probs}; batch {TRAIN_BATCH} tiles of {TILE} px = "
          f"{TRAIN_BATCH * n_views} views per step; peak lr "
          f"{bundle.ocfg.resolved_lr(TRAIN_BATCH):.3e}")
    name = "backbone.blocks.0.attn.qkv.weight"
    teacher_before = bundle.state.teacher.state_dict()[name].clone()
    torch.cuda.reset_peak_memory_stats()
    rows = run_steps(bundle, batch, 1)
    student, teacher = bundle.model.state_dict()[name], bundle.state.teacher.state_dict()[name]
    momentum = bundle.dcfg.ema_base  # the cosine schedule's value at step 0
    want = momentum * teacher_before + (1.0 - momentum) * student
    ema_err = (teacher - want).abs().max().item()
    moved = (teacher - teacher_before).abs().max().item()
    apart = (teacher - student).abs().max().item()
    center = bundle.state.center.abs().max().item()
    print(f"[train] after step 0: teacher moved {moved:.3e}, differs from student by "
          f"{apart:.3e}, from the EMA of the two by {ema_err:.3e} (<= 1e-6); centre max-abs "
          f"{center:.3e}")
    if not (moved > 0 and apart > 0 and ema_err <= 1e-6 and center > 0):
        raise RuntimeError("teacher EMA or centre update is wrong")
    rows += run_steps(bundle, batch, WARMUP_STEPS - 1 + TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated()
    count(rows)
    none = dict.fromkeys(all_launches(), 0)
    want_launches = {**none, "mha_qkv_fwd": depth, "mha_qkv_fwd_saved": 2 * depth,
                     "mha_qkv_bwd_saved": 2 * depth}
    for i, r in enumerate(rows):
        print(f"[train] step {i}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.4f} "
              f"{r['ms']:.2f} ms launches {r['launches']}")
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise RuntimeError(f"step {i}: loss or gradient norm is not finite")
        if r["launches"] != want_launches:
            raise RuntimeError(f"step {i}: launches {r['launches']}, expected {want_launches}")
    if len({r["loss"] for r in rows}) < 2:
        raise RuntimeError("the loss is constant")
    ms = statistics.median(r["ms"] for r in rows[WARMUP_STEPS:])
    views = TRAIN_BATCH * n_views
    print(f"[train] tuned path: median of {TIMED_STEPS} steps after {WARMUP_STEPS} warm-up "
          f"{ms:.2f} ms per step = {views / ms * 1e3:.1f} views/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; on {smi}")
    crop_ms = cuda_median_ms(lambda: bundle.multicrop(bundle.generator, batch["images"]),
                             reps=5, warmup=1)
    print(f"[train] multi-crop alone (8 views of {TRAIN_BATCH} tiles): {crop_ms:.2f} ms; on {smi}")
    PROFILES.append(("the tuned step", None, TRAIN_ARGV, ms))
    STEP_MS["tuned"] = ms
    del bundle
    torch.cuda.empty_cache()

    # -- the same seeds with every attention call on the plain versions --
    plain = train_bundle({"use_kernel_attention": False})
    plain_rows = run_steps(plain, batch, 2)
    if any(sum(r["launches"].values()) for r in plain_rows):
        raise RuntimeError("the plain-attention path launched a kernel")
    check_losses("tuned", rows, plain_rows)
    ms_plain = plain_rows[1]["ms"]
    print(f"[train] plain attention: step 1 took {ms_plain:.2f} ms = "
          f"{views / ms_plain * 1e3:.1f} views/s; on {smi}")
    del plain
    torch.cuda.empty_cache()

    # -- depth 4 without saved probabilities: the recomputing backward --
    over = {"attn_save_probs": False, "depth": 4}
    recompute = train_bundle(over)
    rc_rows = run_steps(recompute, batch, 2)
    count(rc_rows)
    # teacher + the student's two forwards; two backwards
    want_rc = {**none, "mha_qkv_fwd": 4 + 2 * 4, "mha_qkv_bwd": 2 * 4}
    for i, r in enumerate(rc_rows):
        print(f"[train] depth 4, attn_save_probs off, step {i}: loss {r['loss']:.6f} "
              f"{r['ms']:.2f} ms launches {r['launches']}")
        if r["launches"] != want_rc:
            raise RuntimeError(f"recompute step {i}: launches {r['launches']}, expected {want_rc}")
    del recompute
    torch.cuda.empty_cache()
    rc_plain = train_bundle({**over, "use_kernel_attention": False})
    check_losses("depth 4, attn_save_probs off", rc_rows, run_steps(rc_plain, batch, 2))
    del rc_plain
    torch.cuda.empty_cache()

    # -- the recomputing path at full depth, for its time beside the tuned path's --
    full = train_bundle({"attn_save_probs": False})
    full_rows = run_steps(full, batch, WARMUP_STEPS + TIMED_STEPS)
    count(full_rows)
    ms_full = statistics.median(r["ms"] for r in full_rows[WARMUP_STEPS:])
    print(f"[train] attn_save_probs off at depth {depth}: median of {TIMED_STEPS} steps after "
          f"{WARMUP_STEPS} warm-up {ms_full:.2f} ms per step = {views / ms_full * 1e3:.1f} "
          f"views/s (tuned path above: {ms:.2f} ms); on {smi}")
    return total


def filtered_scanlines(img: np.ndarray, prev=None, first_row_none: bool = False) -> tuple:
    """uint8 RGB rows (H, W, 3) → (the PNG scanlines: each a filter-type byte
    and the filtered row, the filter type of each). Each scanline takes the
    filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) whose residuals, read as
    signed bytes, have the least absolute sum: libpng's default choice.
    ``prev`` is the row above the first (None: the image's first row);
    ``first_row_none`` leaves the first scanline unfiltered."""
    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int16)
    above = np.zeros((1, w * c), np.int16) if prev is None else \
        prev.reshape(1, w * c).astype(np.int16)
    up = np.vstack([above, cur[:-1]])
    left = np.hstack([np.zeros((h, c), np.int16), cur[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int16), up[:, :-c]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(cur), left, up, (left + up) // 2, paeth])
    residuals = ((cur[None] - preds) & 0xFF).astype(np.uint8)       # (5, h, w * c)
    kinds = np.abs(residuals.view(np.int8).astype(np.int16)).sum(-1).argmin(0)
    if first_row_none:
        kinds[0] = 0
    filtered = residuals[kinds, np.arange(h)]
    return np.hstack([kinds[:, None].astype(np.uint8), filtered]).tobytes(), kinds


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def png_header(h: int, w: int) -> bytes:
    return b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))


def png_bytes(img: np.ndarray, first_row_none: bool = False) -> tuple[bytes, np.ndarray]:
    """uint8 RGB (H, W, 3) → (a PNG file's bytes, the filter type of each
    scanline), filtered as ``filtered_scanlines`` chooses."""
    raw, kinds = filtered_scanlines(img, first_row_none=first_row_none)
    data = (png_header(*img.shape[:2]) + png_chunk(b"IDAT", zlib.compress(raw, 6))
            + png_chunk(b"IEND", b""))
    return data, kinds


def smooth_field(rng, n: int, cells: int) -> np.ndarray:
    """(n, n) bilinear interpolation of a (cells + 1)² grid of N(0, 1)."""
    f = rng.standard_normal((cells + 1, cells + 1))
    x = np.linspace(0, cells, n)
    i = np.minimum(x.astype(np.int64), cells - 1)
    t = x - i
    rows = f[i] * (1 - t)[:, None] + f[i + 1] * t[:, None]
    return rows[:, i] * (1 - t)[None] + rows[:, i + 1] * t[None]


def ssl_tile(rng, mean) -> np.ndarray:
    """A stained-tissue-like uint8 tile: smooth blobs of tissue in the class's
    colour, its stain varying smoothly, on a near-white background, with
    scanner noise."""
    tissue = smooth_field(rng, SSL_TILE, 4) + 0.3 > 0
    stain = 30.0 * smooth_field(rng, SSL_TILE, 16)[..., None]
    img = np.where(tissue[..., None], np.asarray(mean, np.float64) + stain, 242.0)
    return np.clip(img + rng.normal(0.0, 4.0, img.shape), 0, 255).astype(np.uint8)


def write_ssl_folder() -> dict:
    """The trainer's seeded folder: per class SSL_PER_CLASS tiles of
    ``ssl_tile`` in the class's colour, each scanline filtered as libpng
    chooses (every eighth file's first scanline unfiltered, so that all five
    filter types appear). → {path: source pixels} of a sample."""
    rng = np.random.default_rng(SEED)
    sample, counts = {}, np.zeros(5, np.int64)
    t0 = time.perf_counter()
    for c in range(SSL_CLASSES):
        cdir = SSL_DIR / f"class{c}"
        cdir.mkdir(parents=True, exist_ok=True)
        for k in range(SSL_PER_CLASS):
            img = ssl_tile(rng, SSL_MEANS[c])
            data, kinds = png_bytes(img, first_row_none=k % 8 == 0)
            counts += np.bincount(kinds, minlength=5)
            path = cdir / f"{k:04d}.png"
            path.write_bytes(data)
            if k % 8 == 0 or k < 3:
                sample[str(path)] = img
    share = ", ".join(f"{name} {100 * n / counts.sum():.1f}%" for name, n in
                      zip(("None", "Sub", "Up", "Average", "Paeth"), counts))
    print(f"[train_ssl] wrote {SSL_CLASSES} x {SSL_PER_CLASS} PNG tiles of {SSL_TILE} px to "
          f"{SSL_DIR} in {time.perf_counter() - t0:.2f} s; scanline filters {share}")
    if not counts.all():
        raise RuntimeError(f"[train_ssl] a filter type is missing from the folder: {share}")
    return sample


def ssl_run(out: Path, argv: list) -> dict:
    """``cli.train.main(argv)`` on the card, writing under ``out``, recording
    per step its launches, entry time and the loop's wait on the Prefetcher
    so far. → state, rows, total launches, peak memory, wall seconds, output
    dir."""
    rows, feeds = [], []
    real_bundle, real_prefetcher = cli_train.ssl_step_bundle, prefetch.Prefetcher

    def waited() -> float:
        return sum(f.wait_s for f in feeds)

    def bundle_with_recording(*a, **kw):
        bundle = real_bundle(*a, **kw)
        step = bundle.raw_step

        def recorded(state, batch, generator):
            before = all_launches()
            t = time.perf_counter()
            state, metrics = step(state, batch, generator)
            rows.append({"t": t, "wait": waited(), "loss": metrics["loss"],
                         "launches": {k: v - before[k] for k, v in all_launches().items()}})
            return state, metrics

        bundle.raw_step = recorded
        return bundle

    class RecordedPrefetcher(real_prefetcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            feeds.append(self)

    cli_train.ssl_step_bundle, prefetch.Prefetcher = bundle_with_recording, RecordedPrefetcher
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state = cli_train.main(argv + ["--output", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = all_launches()
    finally:
        cli_train.ssl_step_bundle, prefetch.Prefetcher = real_bundle, real_prefetcher
    for r in rows:
        r["loss"] = r["loss"].item()
    return {"state": state, "rows": rows, "total": total, "wall": wall, "out": out,
            "peak": torch.cuda.max_memory_allocated()}


def check_ssl_run(tag: str, run: dict, k1a_per_step: int, depth: int) -> None:
    rows, n_steps = run["rows"], SSL_EPOCHS * SSL_STEPS
    if len(rows) != n_steps:
        raise RuntimeError(f"[train_ssl] {tag}: {len(rows)} steps, expected {n_steps}")
    none = dict.fromkeys(all_launches(), 0)
    want = {**none, "mha_qkv_fwd": depth, "mha_qkv_fwd_saved": k1a_per_step,
            "mha_qkv_bwd_saved": 2 * depth}
    for i, r in enumerate(rows):
        print(f"[train_ssl] {tag} step {i}: loss {r['loss']:.6f} launches {r['launches']}")
        if not np.isfinite(r["loss"]):
            raise RuntimeError(f"[train_ssl] {tag} step {i}: the loss is not finite")
        if r["launches"] != want:
            raise RuntimeError(f"[train_ssl] {tag} step {i}: launches {r['launches']}, "
                               f"expected {want}")
    n_images = SSL_CLASSES * SSL_PER_CLASS
    probe_batches = -(-n_images // TRAIN_BATCH)
    probe = {k: v - sum(r["launches"][k] for r in rows) for k, v in run["total"].items()}
    want_probe = {**none, "mha_qkv_fwd": depth * probe_batches * SSL_EPOCHS}
    print(f"[train_ssl] {tag}: the probe's launches over {SSL_EPOCHS} probes of "
          f"{probe_batches} batches: {probe}")
    if probe != want_probe:
        raise RuntimeError(f"[train_ssl] {tag}: probe launches {probe}, expected {want_probe}")
    exp = [d for d in run["out"].iterdir() if d.name.startswith("Exp_")]
    if len(exp) != 1:
        raise RuntimeError(f"[train_ssl] {tag}: {len(exp)} experiment directories")
    steps = sorted(int(d.name) for d in (exp[0] / "checkpoints").iterdir())
    if steps != [SSL_STEPS * (e + 1) for e in range(SSL_EPOCHS)]:
        raise RuntimeError(f"[train_ssl] {tag}: checkpoints at steps {steps}")
    with open(exp[0] / "summary.csv") as f:
        summary = list(csv.DictReader(f))
    accs = [float(r["eval_knn_acc"]) for r in summary]
    print(f"[train_ssl] {tag}: checkpoints at steps {steps}; summary.csv {summary}")
    if len(summary) != SSL_EPOCHS or not all(0.0 <= a <= 1.0 for a in accs):
        raise RuntimeError(f"[train_ssl] {tag}: summary.csv holds {summary}")
    for name in ("log.txt", "run_data.jsonl"):
        if not (run["out"] / name).is_file():
            raise RuntimeError(f"[train_ssl] {tag}: no {name}")


def loop_timing(run: dict, epochs: int = SSL_EPOCHS, steps: int = SSL_STEPS) -> tuple:
    """→ (ms between the starts of consecutive steps within each epoch, the
    share of them spent waiting on the Prefetcher): steps - 1 gaps an epoch,
    a spot reading here (train_loop_ab.py's ``loop`` takes the median over
    two epochs of 10 steps)."""
    gaps, waits = [], []
    for e in range(epochs):
        rows = run["rows"][e * steps:(e + 1) * steps]
        gaps += [b["t"] - a["t"] for a, b in zip(rows, rows[1:])]
        waits += [b["wait"] - a["wait"] for a, b in zip(rows, rows[1:])]
    return [g * 1e3 for g in gaps], sum(waits) / sum(gaps)


def phase_train_ssl(smi: str) -> dict:
    """``python -m tpuwsi_torch.cli.train --ssl --data-dir <folder>`` on the
    card, as is and with --grad-checkpointing; → launches per kernel."""
    sample = write_ssl_folder()
    for path, img in sample.items():
        if not np.array_equal(decode_png(path), img):
            raise RuntimeError(f"[train_ssl] {path} does not decode to the pixels written")
    print(f"[train_ssl] {len(sample)} sampled files (every filter type) decode to the pixels "
          f"written")
    depth = 12
    runs = {}
    for tag, extra, k1a in (("default", [], 2 * depth),
                            ("grad_checkpointing", ["--grad-checkpointing"], 4 * depth)):
        run = ssl_run(SSL_RUNS / tag, SSL_ARGV + ["--data-dir", str(SSL_DIR)] + extra)
        check_ssl_run(tag, run, k1a, depth)
        gaps, wait = loop_timing(run)
        print(f"[train_ssl] {tag}: main() took {run['wall']:.2f} s for {len(run['rows'])} steps, "
              f"{SSL_EPOCHS} probes and checkpoints; the loop "
              f"{', '.join(f'{g:.2f}' for g in gaps)} ms per step (spot readings: the gaps "
              f"between the starts of an epoch's steps, each ending in a read of its loss), "
              f"{100 * wait:.1f}% of it waiting on the Prefetcher, the first step "
              f"{run['rows'][0]['wait']:.2f} s; the bare step of [train] {STEP_MS['tuned']:.2f} "
              f"ms; peak device memory {run['peak'] / 2**30:.2f} GiB; on {smi}")
        runs[tag] = run

    # the final state against a restore of the last checkpoint into a fresh bundle
    run = runs["default"]
    exp = next(d for d in run["out"].iterdir() if d.name.startswith("Exp_"))
    fresh = ssl_step_bundle(parse_args(SSL_ARGV + ["--data-dir", str(SSL_DIR)]), SSL_STEPS,
                            TRAIN_BATCH, torch.device("cuda"))
    mgr = CheckpointManager(str(exp / "checkpoints"), metric_name="loss", mode="min")
    mgr.restore(mgr.latest_step(), target=fresh.state)
    mgr.close()
    want, got = run["state"].state_dict(), fresh.state.state_dict()
    n_tensors = 0

    def same(a, b, where):
        nonlocal n_tensors
        if isinstance(a, dict):
            if a.keys() != b.keys():
                raise RuntimeError(f"[train_ssl] restore: keys differ at {where}")
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b, strict=True)):
                same(x, y, f"{where}/{i}")
        elif isinstance(a, torch.Tensor):
            n_tensors += 1
            if not (a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b.to(a.device))):
                raise RuntimeError(f"[train_ssl] restore: {where} differs")
        elif a != b:
            raise RuntimeError(f"[train_ssl] restore: {where} is {b}, expected {a}")

    same(want, got, "state")
    print(f"[train_ssl] a restore of step {run['state'].step} into a fresh bundle equals the "
          f"final state in all {n_tensors} tensors (the generator's state among them)")
    del fresh, want, got

    a, b = runs["default"]["rows"], runs["grad_checkpointing"]["rows"]
    diff = max(abs(x["loss"] - y["loss"]) for x, y in zip(a, b))
    print(f"[train_ssl] --grad-checkpointing against the default run, same seeds: largest loss "
          f"difference {diff:.3e} (<= {LOSS_MAX_DIFF})")
    if not diff <= LOSS_MAX_DIFF:
        raise RuntimeError("[train_ssl] the recomputing run's losses disagree")
    total = {k: sum(r["total"][k] for r in runs.values()) for k in all_launches()}
    for r in runs.values():
        del r["state"]
    shutil.rmtree(SSL_RUNS, ignore_errors=True)  # ~2.6 GB of checkpoints
    torch.cuda.empty_cache()
    return total


# -- the WSI paths: a cohort of PNG slides, -ef and WSI-mode --ssl ---------------------

def smooth_rows(grid: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Rows ``ys`` × columns ``xs`` of the bilinear interpolation of ``grid``
    (``smooth_field`` a band at a time)."""
    cells = grid.shape[0] - 1
    i = np.minimum(ys.astype(np.int64), cells - 1)
    t = ys - i
    rows = grid[i] * (1 - t)[:, None] + grid[i + 1] * t[:, None]
    j = np.minimum(xs.astype(np.int64), cells - 1)
    u = xs - j
    return rows[:, j] * (1 - u)[None] + rows[:, j + 1] * u[None]


def wsi_slide_bands(index: int):
    """Slide ``index`` of the cohort, WSI_BAND rows at a time: ``ssl_tile``'s
    tissue-like picture at slide scale (blobs of tissue ~WSI_SIZE /
    WSI_TISSUE_CELLS px across, the stain varying every ~16 px, scanner
    noise), in the colour of ``SSL_MEANS[index % 2]``, with the tissue
    share of its fold."""
    rng = np.random.default_rng([SEED, index])
    n = WSI_SIZE
    tissue_grid = rng.standard_normal((WSI_TISSUE_CELLS + 1,) * 2)
    stain_grid = rng.standard_normal((n // 16 + 1,) * 2)
    xt, xs = np.linspace(0, WSI_TISSUE_CELLS, n), np.linspace(0, n // 16, n)
    mean = np.asarray(SSL_MEANS[index % 2], np.float32)
    offset = WSI_TISSUE_OFFSET[WSI_FOLDS[index]]
    for r0 in range(0, n, WSI_BAND):
        rows = slice(r0, r0 + WSI_BAND)
        tissue = smooth_rows(tissue_grid, xt[rows], xt) + offset > 0
        stain = (30.0 * smooth_rows(stain_grid, xs[rows], xs)).astype(np.float32)[..., None]
        img = np.where(tissue[..., None], mean + stain, np.float32(242.0))
        img += 4.0 * rng.standard_normal(img.shape, dtype=np.float32)
        yield np.clip(img, 0, 255).astype(np.uint8)


def write_wsi_slide(index: int) -> dict:
    """Slide ``index`` as a PNG (each scanline filtered as libpng chooses,
    deflated at zlib level 1 into one IDAT chunk) with its tissue grids for
    --mag 20 and 10, from the port's ``build_tissue_grid``. Decodes the file
    back through the port's decoder. → {grid sizes by mag, filter counts,
    decodes back, bytes}."""
    from tpuwsi_torch.io import grids as t_grids
    from tpuwsi_torch.io.slide_readers import ImageSlideReader

    t0 = time.perf_counter()
    name = f"slide_{index:02d}.png"
    img = np.empty((WSI_SIZE, WSI_SIZE, 3), np.uint8)
    comp, parts, counts, prev = zlib.compressobj(1), [], np.zeros(5, np.int64), None
    for b, band in enumerate(wsi_slide_bands(index)):
        img[b * WSI_BAND:(b + 1) * WSI_BAND] = band
        raw, kinds = filtered_scanlines(band, prev)
        counts += np.bincount(kinds, minlength=5)
        parts.append(comp.compress(raw))
        prev = band[-1]
    parts.append(comp.flush())
    path = WSI_COHORT / name
    data = png_header(WSI_SIZE, WSI_SIZE) + png_chunk(b"IDAT", b"".join(parts)) + \
        png_chunk(b"IEND", b"")
    path.write_bytes(data)
    same = bool(np.array_equal(decode_png(str(path)), img))
    reader = ImageSlideReader(img)
    sizes = {}
    for mag in WSI_MAGS:
        grid = t_grids.build_tissue_grid(reader, WSI_TILE * WSI_OBJECTIVE // mag,
                                         preview_downsample=16)
        t_grids.save_grid_pickle(t_grids.grid_file_path(str(WSI_COHORT), name, mag, WSI_TILE),
                                 grid)
        sizes[mag] = len(grid)
    return {"name": name, "grids": sizes, "counts": counts, "same": same, "bytes": len(data),
            "seconds": time.perf_counter() - t0}


def phase_wsi_cohort(smi: str) -> None:
    """[wsi_cohort]: the TCGA-layout cohort under WSI_ROOT, written with the
    port's writers, a process a slide (threads held each other up on the
    interpreter lock between numpy's calls), then the C crop-and-resize held
    against ``resize_bicubic``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from tpuwsi_torch.io.grids import grid_data_columns
    from tpuwsi_torch.io.image import crop_resize, resize_bicubic
    from tpuwsi_torch.utils.minixlsx import write_xlsx

    shutil.rmtree(WSI_ROOT, ignore_errors=True)
    WSI_COHORT.mkdir(parents=True)
    t0 = time.perf_counter()
    # spawned, not forked: this process holds a CUDA context and torch's thread pools
    with ProcessPoolExecutor(len(WSI_FOLDS),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        slides = list(pool.map(write_wsi_slide, range(len(WSI_FOLDS))))
    counts = sum(s["counts"] for s in slides)
    share = ", ".join(f"{name} {100 * n / counts.sum():.1f}%" for name, n in
                      zip(("None", "Sub", "Up", "Average", "Paeth"), counts))
    files = [s["name"] for s in slides]
    cells = (WSI_SIZE * WSI_MAGS[0] // (WSI_TILE * WSI_OBJECTIVE)) ** 2
    for mag in WSI_MAGS:
        total, legit = grid_data_columns(WSI_TILE, mag)
        per_side = WSI_SIZE * mag // (WSI_TILE * WSI_OBJECTIVE)
        write_xlsx(str(WSI_COHORT / f"Grids_{mag}" / "Grid_data.xlsx"), {
            "file": files, total: [per_side ** 2] * len(files),
            legit: [s["grids"][mag] for s in slides]})
    write_xlsx(str(WSI_COHORT / "slides_data_TCGA.xlsx"), {
        "file": files, "id": ["TCGA"] * len(files),
        "patient barcode": [f"TCGA-{i:02d}" for i in range(len(files))],
        "ER status": ["Positive", "Negative"] * (len(files) // 2),
        "PR status": ["Negative", "Positive"] * (len(files) // 2),
        "test fold idx": WSI_FOLDS, "Manipulated Objective Power": [WSI_OBJECTIVE] * len(files),
        "DX": [True] * len(files)})
    print(f"[wsi_cohort] wrote {len(files)} PNG slides of {WSI_SIZE} x {WSI_SIZE} px "
          f"(objective {WSI_OBJECTIVE}; test folds {WSI_FOLDS}) to {WSI_COHORT} in "
          f"{time.perf_counter() - t0:.1f} s in {len(WSI_FOLDS)} processes on "
          f"{os.cpu_count()} cores "
          f"({statistics.median(s['seconds'] for s in slides):.1f} s a slide, "
          f"{sum(s['bytes'] for s in slides) / 2**20:.0f} MiB); scanline filters {share}; "
          f"tissue tiles at --mag 20 (of {cells}) / 10 (of {cells // 4}): "
          + ", ".join(f"{s['grids'][20]}/{s['grids'][10]}" for s in slides))
    if not all(s["same"] for s in slides):
        raise RuntimeError("[wsi_cohort] a slide does not decode to the pixels written")
    for s, fold in zip(slides, WSI_FOLDS):
        need = (WSI_EF_TILES, 20) if fold == 1 else (WSI_SSL_TILES, 10)
        if s["grids"][need[1]] < need[0]:
            raise RuntimeError(f"[wsi_cohort] {s['name']}: {s['grids'][need[1]]} tissue tiles "
                               f"at --mag {need[1]}, fewer than the {need[0]} its path takes")

    # the C crop-and-resize against resize_bicubic on the first slide
    arr = decode_png(str(WSI_COHORT / files[0]))
    rng = np.random.default_rng(SEED)
    checked = 0
    for region, out_size in ((512, 256), (256, 256), (300, 256), (1024, 512), (389, 256)):
        tops = rng.integers(-region // 2, WSI_SIZE - region // 2, 12)
        lefts = rng.integers(-region // 2, WSI_SIZE - region // 2, 12)
        boxes = []
        for top, left in zip(tops, lefts):  # read_region's bounds: the slide's edge in zeros
            r0, c0 = max(int(top), 0), max(int(left), 0)
            boxes.append((r0, c0, min(int(top) + region, WSI_SIZE) - r0,
                          min(int(left) + region, WSI_SIZE) - c0, region))
        got = crop_resize([arr] * len(boxes), np.asarray(boxes, np.int32), out_size, threads=4)
        for (r0, c0, rows, cols, _), tile in zip(boxes, got):
            src = np.zeros((region, region, 3), np.uint8)
            src[:rows, :cols] = arr[r0:r0 + rows, c0:c0 + cols]
            if not np.array_equal(tile, resize_bicubic(src, out_size)):
                raise RuntimeError(f"[wsi_cohort] crop_resize differs from resize_bicubic at "
                                   f"{(r0, c0, rows, cols)}, {region} -> {out_size}")
            checked += 1
    boxes = np.asarray([(int(r), int(c), 512, 512, 512) for r, c in
                        rng.integers(0, WSI_SIZE - 512, (TRAIN_BATCH, 2))], np.int32)
    ms = {}
    for threads in (1, 4, 4, 1):
        t = time.perf_counter()
        crop_resize([arr] * len(boxes), boxes, 256, threads=threads)
        ms.setdefault(threads, []).append((time.perf_counter() - t) * 1e3)
    print(f"[wsi_cohort] crop_resize equals resize_bicubic byte for byte on {checked} tiles "
          f"(512, 256, 300, 389 -> 256 and 1024 -> 512, across the slide's edges); "
          f"{TRAIN_BATCH} tiles 512 -> 256 (runs 1, 4, 4, 1 threads): "
          f"{ms[1][0]:.2f} / {ms[1][1]:.2f} ms on 1 thread, {ms[4][0]:.2f} / {ms[4][1]:.2f} ms "
          f"on 4 = {ms[1][1] / TRAIN_BATCH:.3f} ms a tile on one thread (host CPU, beside {smi})")


def wsi_ef_run(mag: int, open_ahead=None, argv=WSI_EF_ARGV, tag="ef") -> dict:
    """``main(argv + -ef --mag mag)`` on the card, recording the walker, the
    Prefetcher, each chunk's host copy time and a CUDA event before its copy
    and after its forward; ``open_ahead`` overrides the walker's."""
    from tpuwsi_torch.infer import slide_walker

    rec = {"walkers": [], "feeds": [], "spans": [], "pin_s": 0.0, "first": None}
    real = (slide_walker.SlideWalker, prefetch.Prefetcher, cli_train.eval_stream)

    class RecordedWalker(real[0]):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if open_ahead is not None:
                self.open_ahead = open_ahead
            rec["walkers"].append(self)

    class RecordedPrefetcher(real[1]):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec["feeds"].append(self)

    def recorded_stream(chunks, images_of, single_call, depth=2):
        def timed_images_of(chunk):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            t = time.perf_counter()
            images = images_of(chunk)
            rec["pin_s"] += time.perf_counter() - t
            if rec["first"] is None:
                rec["first"] = (chunk.images.copy(), int(chunk.mask.sum()), chunk.slide_name)
            rec["spans"].append([start, None])
            return images

        def timed_call(images):
            out = single_call(images)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec["spans"][-1][1] = end
            return out

        return real[2](chunks, timed_images_of, timed_call, depth)

    out = WSI_RUNS / f"{tag}{mag}_{open_ahead}"
    slide_walker.SlideWalker, prefetch.Prefetcher, cli_train.eval_stream = (
        RecordedWalker, RecordedPrefetcher, recorded_stream)
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        agg = cli_train.main(argv + ["--mag", str(mag), "--output", str(out)])
        torch.cuda.synchronize()
        rec["wall"] = time.perf_counter() - t0
        rec["launches"] = all_launches()
    finally:
        slide_walker.SlideWalker, prefetch.Prefetcher, cli_train.eval_stream = real
    rec["agg"], rec["out"] = agg, out
    rec["busy_ms"] = sum(a.elapsed_time(b) for a, b in rec["spans"])
    return rec


def check_wsi_ef(mag: int, rec: dict, smi: str, argv=WSI_EF_ARGV, tag="wsi_ef",
                 slides=WSI_FOLDS.count(1)) -> dict:
    """The run's launches (K2 12 a chunk, nothing else), feature files and
    features, its first chunk through the kernel and through plain attention
    (the dataset's normalization bank), and its timing. → launches."""
    agg, walker, feed = rec["agg"], rec["walkers"][0], rec["feeds"][0]
    n_slides, n_chunks = len(walker.table), len(rec["spans"])
    n_tiles = sum(len(r.tile_locations) for r in agg.results)
    want = {**dict.fromkeys(rec["launches"], 0), "mha_qkv_fwd": 12 * n_chunks}
    print(f"[{tag}] --mag {mag}: {n_slides} slides, {n_tiles} tiles in {n_chunks} chunks "
          f"(the walker's count {len(walker)}); launches {rec['launches']}")
    if n_chunks != len(walker) or n_slides != slides:
        raise RuntimeError(f"[{tag}] {n_chunks} chunks of {n_slides} slides")
    if rec["launches"] != want:
        raise RuntimeError(f"[{tag}] launches {rec['launches']}, expected {want}")
    exp = next(d for d in rec["out"].iterdir() if d.name.startswith("Exp_"))
    written = sorted(os.listdir(exp / "features"))
    if written != sorted([f"{Path(n).stem}_features.pt" for n in walker.table.file_names]
                         + ["inference.data"]):
        raise RuntimeError(f"[{tag}] feature files: {written}")
    feats = np.concatenate([r.features for r in agg.results])
    if feats.shape != (n_tiles, 384) or not np.isfinite(feats).all():
        raise RuntimeError(f"[{tag}] features: {feats.shape}, finite {np.isfinite(feats).all()}")

    # the first chunk again, through the same weights with and without the kernel
    dev = torch.device("cuda")
    args = parse_args(argv + ["--mag", str(mag)])
    model, params = cli_train.feature_model(args)
    plain = create_model(args.model, num_classes=2, img_size=WSI_TILE,
                         use_kernel_attention=False)
    norm = make_recipe("none", train=False, tile_size=WSI_TILE,
                       norm_type=cli_train.norm_bank(args))
    images, k, name = rec["first"]
    outs = []
    for m in (model, plain):
        m.load_state_dict(params)
        m = m.to(dev).eval()
        with torch.inference_mode():
            f = m.forward_features(norm(torch.from_numpy(images[:k]).to(dev)))
            outs.append((f.cpu().numpy(), torch.softmax(m.head(f), -1).cpu().numpy()))
    (fk, pk), (fp, pp) = outs
    main_feats = next(r.features for r in agg.results if r.slide_name == name)[:k]
    cos = lambda a, b: ((a * b).sum(1) / (np.linalg.norm(a, axis=1)  # noqa: E731
                                          * np.linalg.norm(b, axis=1))).min()
    dprob = float(np.abs(pk - pp).max())
    print(f"[{tag}] --mag {mag}, first chunk ({k} tiles of {name}; the "
          f"{cli_train.norm_bank(args)} bank): kernel against plain attention min per-tile feature cosine {cos(fk, fp):.6f} (>= "
          f"{FEAT_COSINE_MIN}), max probs diff {dprob:.3e} (<= {PROBS_MAX_DIFF}); main()'s "
          f"saved features against the kernel model's {cos(main_feats, fk):.6f}")
    if cos(fk, fp) < FEAT_COSINE_MIN or dprob > PROBS_MAX_DIFF or \
            cos(main_feats, fk) < FEAT_COSINE_MIN:
        raise RuntimeError(f"[{tag}] the kernel path, plain attention and main() disagree")

    walk_s = walker.seconds["open"] + walker.seconds["walk"]
    idle = 1.0 - rec["busy_ms"] / (rec["wall"] * 1e3)
    rec["tiles_s"], rec["idle"] = n_tiles / rec["wall"], idle
    print(f"[{tag}] --mag {mag}: main() {rec['wall']:.2f} s = {n_tiles / rec['wall']:.1f} "
          f"tiles/s; the walk alone (decode + draws + C cuts, summed over its threads) "
          f"{walk_s:.2f} s = {n_tiles / walk_s:.1f} tiles/s; [slice] on resident chunks "
          f"{SERVING_TILES_S['slice'][0]:.1f} / {SERVING_TILES_S['slice'][1]:.1f} tiles/s. Host "
          f"seconds a slide: opening it {walker.seconds['open'] / n_slides:.3f} (on "
          f"{walker.open_ahead} threads ahead), walk {walker.seconds['walk'] / n_slides:.3f}, "
          f"pinned copy {rec['pin_s'] / n_slides:.3f}; waiting on the Prefetcher "
          f"{feed.wait_s:.2f} s ({100 * feed.wait_s / rec['wall']:.1f}% of main()); the card "
          f"busy {rec['busy_ms']:.1f} ms (H2D + forward, CUDA events), idle "
          f"{100 * idle:.1f}% of main(); on {smi}")
    return rec["launches"]


def first_slides(table, n: int):
    """The first ``n`` slides of a ``SlideTable``."""
    per_slide = ("file_names", "path_names", "cohort_ids", "tissue_tiles", "targets",
                 "magnifications", "patient_barcodes")
    return dataclasses.replace(table, **{f: getattr(table, f)[:n] for f in per_slide})


def phase_wsi_ef(smi: str) -> dict:
    """[wsi_ef]: ``python -m tpuwsi_torch.cli.train -ef`` over the cohort's
    test fold on the card, at --mag 20 (crops) and 10 (512² regions resized
    to 256²); → launches per kernel."""
    total = dict.fromkeys(all_launches(), 0)
    for mag in WSI_MAGS:
        rec = wsi_ef_run(mag)
        counts = check_wsi_ef(mag, rec, smi)
        total = {k: total[k] + counts[k] for k in total}
        if mag == 20:  # for [wsi_formats]: the same slides as TIFFs give the same features
            WSI_EF_PNG.update(tiles_s=rec["tiles_s"], features={
                Path(r.slide_name).stem: (r.tile_locations, r.features)
                for r in rec["agg"].results})
            # [mil]'s held-out bags
            MIL_ROOT.mkdir(parents=True, exist_ok=True)
            exp = next(d for d in rec["out"].iterdir() if d.name.startswith("Exp_"))
            shutil.copy(exp / "features" / "inference.data", MIL_ROOT / "fold1.data")
    # the walker opening each slide in turn, as the JAX package's does, over
    # the first WSI_TURN_SLIDES of the fold (a rate per tile; half the run's time)
    real_table = cli_train.infer_slide_table
    cli_train.infer_slide_table = lambda args: first_slides(real_table(args), WSI_TURN_SLIDES)
    try:
        turn = wsi_ef_run(WSI_MAGS[-1], open_ahead=0)
    finally:
        cli_train.infer_slide_table = real_table
    n_tiles = sum(len(r.tile_locations) for r in turn["agg"].results)
    ahead_tiles = sum(len(r.tile_locations) for r in rec["agg"].results)
    print(f"[wsi_ef] --mag {WSI_MAGS[-1]} with each slide decoded in turn (open_ahead 0), "
          f"the first {len(turn['agg'].results)} slides: main() {turn['wall']:.2f} s = "
          f"{n_tiles / turn['wall']:.1f} tiles/s against {ahead_tiles / rec['wall']:.1f} over "
          f"all {len(rec['agg'].results)} with {rec['walkers'][0].open_ahead} slides decoding "
          f"ahead; waiting on the Prefetcher {turn['feeds'][0].wait_s:.2f} s; on {smi}")
    shutil.rmtree(WSI_RUNS, ignore_errors=True)
    return total


def tiff_pages(path: Path):
    """A little-endian classic TIFF's bytes and its directories (tag → list of
    values; other types than BYTE, SHORT and LONG as bytes): enough to take the
    committed fixture apart."""
    data = path.read_bytes()
    if data[:4] != b"II*\x00":
        raise RuntimeError(f"[wsi_formats] {path}: not a little-endian classic TIFF")
    size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
    fmt = {1: "B", 3: "H", 4: "I"}
    pages, at = [], struct.unpack_from("<I", data, 4)[0]
    while at:
        n, tags = struct.unpack_from("<H", data, at)[0], {}
        for i in range(n):
            tag, typ, count, value = struct.unpack_from("<HHI4s", data, at + 2 + 12 * i)
            nbytes = size[typ] * count
            off = struct.unpack("<I", value)[0]
            raw = value[:nbytes] if nbytes <= 4 else data[off:off + nbytes]
            tags[tag] = list(struct.unpack(f"<{count}{fmt[typ]}", raw)) if typ in fmt else raw
        pages.append(tags)
        at = struct.unpack_from("<I", data, at + 2 + 12 * n)[0]
    return data, pages


def write_tiled_tiff(path: Path, levels, compression: int, photometric: int,
                     tables: bytes = b"", predictor: int = 1) -> None:
    """A classic little-endian TIFF, one tiled directory a level (those after
    the first marked reduced): ``levels`` = [(width, height, tile payloads in
    row-major order)], WSI_TILE² tiles, RGB (photometric 2) or YCbCr 4:2:0
    JPEG (6) with ``tables`` as JPEGTables, ``predictor`` 2 for horizontal
    differencing."""
    out = bytearray(b"II*\x00\x00\x00\x00\x00")
    link = 4  # where the next directory's offset goes

    def block(raw: bytes) -> int:
        at = len(out)
        out.extend(raw + b"\x00" * (len(raw) & 1))
        return at

    for i, (w, h, payloads) in enumerate(levels):
        offsets = [block(p) for p in payloads]
        entries = [(254, 4, [1 if i else 0]), (256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
                   (259, 3, [compression]), (262, 3, [photometric]), (277, 3, [3]),
                   (284, 3, [1]), (317, 3, [predictor]), (322, 4, [WSI_TILE]),
                   (323, 4, [WSI_TILE]), (324, 4, offsets), (325, 4, [len(p) for p in payloads])]
        if tables:
            entries.append((347, 7, tables))
        if photometric == 6:
            entries.append((530, 3, [2, 2]))
        packed = []
        for tag, typ, values in entries:
            raw = values if typ == 7 else struct.pack(f"<{len(values)}{'H' if typ == 3 else 'I'}",
                                                      *values)
            value = raw.ljust(4, b"\x00") if len(raw) <= 4 else struct.pack("<I", block(raw))
            packed.append(struct.pack("<HHI", tag, typ, len(values)) + value)
        at = block(struct.pack("<H", len(packed)) + b"".join(packed) + b"\x00" * 4)
        struct.pack_into("<I", out, link, at)
        link = at + 2 + 12 * len(packed)
    path.write_bytes(bytes(out))


def deflate_tiff(png: Path, tif: Path) -> None:
    """[wsi_cohort]'s PNG slide as a Deflate-tiled TIFF with the horizontal
    predictor: level 0 its pixels, level 1 every other pixel of them (zlib
    level 1, the tiles on 4 threads: zlib lets go of the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    img = decode_png(str(png))
    levels = []
    for level in (img, img[::2, ::2]):
        h, w = level.shape[:2]
        rows = level.reshape(h, w * 3)
        diff = rows.copy()
        diff[:, 3:] -= rows[:, :-3]  # each sample less the one before it (mod 256)
        diff = diff.reshape(h, w, 3)
        diff[:, ::WSI_TILE] = level[:, ::WSI_TILE]  # a tile's rows start afresh
        corners = [(y, x) for y in range(0, h, WSI_TILE) for x in range(0, w, WSI_TILE)]
        with ThreadPoolExecutor(4) as pool:
            tiles = list(pool.map(lambda yx: zlib.compress(
                diff[yx[0]:yx[0] + WSI_TILE, yx[1]:yx[1] + WSI_TILE].tobytes(), 1), corners))
        levels.append((w, h, tiles))
    write_tiled_tiff(tif, levels, compression=8, photometric=2, predictor=2)


def jpeg_svs(index: int, pool, tables: bytes, path: Path) -> None:
    """Slide ``index`` of (b): WSI_SIZE² at level 0, with levels 1 and 2, each
    tile a payload of the fixture's level of the same downsample."""
    levels = []
    for ds, payloads in zip((1, 2, 4), pool):
        side = WSI_SIZE // ds // WSI_TILE
        levels.append((WSI_SIZE // ds, WSI_SIZE // ds,
                       [payloads[(5 * r + 3 * c + index) % len(payloads)]
                        for r in range(side) for c in range(side)]))
    write_tiled_tiff(path, levels, compression=7, photometric=6, tables=tables)


def mirax_payloads(slide_dir: Path) -> list:
    """The tile payloads of each zoom level of a MIRAX slide whose Index.dat
    gives each level one page in Data0000.dat (the committed fixture), in
    the page's order."""
    ini = (slide_dir / "Slidedat.ini").read_text()
    slide_id = re.search(r"SLIDE_ID = (\S+)", ini).group(1)
    levels = int(re.search(r"HIER_0_COUNT = (\d+)", ini).group(1))
    idx, data = (slide_dir / "Index.dat").read_bytes(), (slide_dir / "Data0000.dat").read_bytes()
    root = struct.unpack_from("<i", idx, 5 + len(slide_id))[0]
    pools = []
    for z in range(levels):
        page = struct.unpack_from("<i", idx, root + 4 * z)[0]
        entries = [struct.unpack_from("<iiii", idx, page + 8 + 16 * i)
                   for i in range(struct.unpack_from("<i", idx, page)[0])]
        pools.append([data[off:off + length] for _, off, length, _ in entries])
    return pools


def mirax_tiles(index: int, pools) -> tuple:
    """Slide ``index`` of the MIRAX cohort: MIRAX_CAMS² cameras of 2 x 2
    tiles of MIRAX_TILE px, spaced by 2 * MIRAX_TILE - MIRAX_OVERLAP and each
    moved by up to 4 px either way, as a scanner's stitching places them. →
    (the cameras' level-0 origins row by row, each zoom level's tiles as
    (image number, level-0 x, y, payload)): level z one tile a 2^z x 2^z
    block of the grid of tiles at its top-left tile's origin, a payload of
    the fixture's level min(z, 1)."""
    rng = np.random.default_rng(SEED + index)
    step, side = 2 * MIRAX_TILE - MIRAX_OVERLAP, 2 * MIRAX_CAMS
    jitter = rng.integers(-4, 5, (MIRAX_CAMS, MIRAX_CAMS, 2))
    cams = [[(cx * step + int(jitter[cy, cx, 0]), cy * step + int(jitter[cy, cx, 1]))
             for cx in range(MIRAX_CAMS)] for cy in range(MIRAX_CAMS)]
    levels = []
    for z in range(MIRAX_LEVELS):
        pool, block = pools[min(z, len(pools) - 1)], 1 << z
        levels.append([(gy * side + gx, cams[gy // 2][gx // 2][0] + gx % 2 * MIRAX_TILE,
                        cams[gy // 2][gx // 2][1] + gy % 2 * MIRAX_TILE,
                        pool[(5 * gy + 3 * gx + index) % len(pool)])
                       for gy in range(0, side, block) for gx in range(0, side, block)])
    return cams, levels


def write_mirax_slide(index: int, pools, path: Path) -> None:
    """Slide ``index`` (``mirax_tiles``) as a MIRAX slide: the stub ``path``
    and beside it a directory of Slidedat.ini, Index.dat (each level's
    entries in chained pages of 1,024) and two data files: level 0's tiles
    in Data0000.dat, the zoomed levels' and the cameras' positions
    (zlib-compressed StitchingIntensityLayer) in Data0001.dat."""
    cams, levels = mirax_tiles(index, pools)
    slide_id = f"SMOKE-{index:08d}"
    data, records = [bytearray(), bytearray()], []
    for z, tiles in enumerate(levels):
        f = min(z, 1)
        records.append([])
        for image, _, _, payload in tiles:
            records[-1].append((image, len(data[f]), len(payload), f))
            data[f] += payload
    pos = zlib.compress(b"".join(struct.pack("<Bii", 1, x, y) for row in cams for x, y in row))
    pos_at = len(data[1])
    data[1] += pos
    idx = bytearray(b"01.02" + slide_id.encode())
    roots = len(idx)
    idx += bytes(8)
    hier = len(idx)
    idx += bytes(4 * len(records))
    nonhier = len(idx)
    idx += bytes(4)
    for z, entries in enumerate(records):
        link = hier + 4 * z
        for at in range(0, len(entries), 1024):
            page = entries[at:at + 1024]
            struct.pack_into("<i", idx, link, len(idx))
            link = len(idx) + 4
            idx += struct.pack("<ii", len(page), 0)
            idx += b"".join(struct.pack("<iiii", *e) for e in page)
    struct.pack_into("<i", idx, nonhier, len(idx))
    idx += struct.pack("<iiiiii", 1, 0, 0, pos_at, len(pos), 1)
    struct.pack_into("<ii", idx, roots, hier, nonhier)
    ini = ["[GENERAL]", "SLIDE_VERSION = 2.2", f"SLIDE_ID = {slide_id}",
           f"IMAGENUMBER_X = {MIRAX_CAMS}", f"IMAGENUMBER_Y = {MIRAX_CAMS}",
           "CameraImageDivisionsPerSide = 2", f"OBJECTIVE_MAGNIFICATION = {WSI_OBJECTIVE}",
           "[HIERARCHICAL]", "HIER_COUNT = 1", "NONHIER_COUNT = 1", "INDEXFILE = Index.dat",
           "HIER_0_NAME = Slide zoom level", f"HIER_0_COUNT = {MIRAX_LEVELS}"]
    for z in range(MIRAX_LEVELS):
        ini += [f"HIER_0_VAL_{z} = ZoomLevel_{z}",
                f"HIER_0_VAL_{z}_SECTION = LAYER_0_LEVEL_{z}_SECTION"]
    ini += ["NONHIER_0_NAME = StitchingIntensityLayer", "NONHIER_0_COUNT = 1",
            "NONHIER_0_VAL_0 = StitchingIntensityLevel"]
    for z in range(MIRAX_LEVELS):
        ini += [f"[LAYER_0_LEVEL_{z}_SECTION]", f"DIGITIZER_WIDTH = {MIRAX_TILE}",
                f"DIGITIZER_HEIGHT = {MIRAX_TILE}", f"OVERLAP_X = {float(MIRAX_OVERLAP)}",
                f"OVERLAP_Y = {float(MIRAX_OVERLAP)}", "IMAGE_FORMAT = JPEG"]
    ini += ["[DATAFILE]", "FILE_COUNT = 2", "FILE_0 = Data0000.dat", "FILE_1 = Data0001.dat"]
    d = path.with_suffix("")
    d.mkdir()
    (d / "Slidedat.ini").write_text("\n".join(ini) + "\n")
    (d / "Index.dat").write_bytes(bytes(idx))
    for i, blob in enumerate(data):
        (d / f"Data{i:04d}.dat").write_bytes(bytes(blob))
    path.write_text("MIRAX stub\n")


def mirax_stitch(tiles, level: int, origin, box, dims) -> np.ndarray:
    """A region of zoom level ``level`` painted from its tiles as MIRAX
    defines it, apart from the C reader: each tile decoded and placed at
    (its origin - ``origin``, level 0's top-left) / 2^level, later over
    earlier in the order of (y, x), cut to the level's ``dims``; zeros
    elsewhere. ``box`` = (x0, y0, w, h) in the level's pixels."""
    from tpuwsi_torch.io.image import decode_jpeg

    x0, y0, w, h = box
    out = np.zeros((h, w, 3), np.uint8)
    for _, px, py, payload in sorted(tiles, key=lambda t: (t[2], t[1])):
        tx, ty = (px - origin[0]) >> level, (py - origin[1]) >> level
        ax0, ay0 = max(tx, x0), max(ty, y0)
        ax1 = min(tx + MIRAX_TILE, x0 + w, dims[0])
        ay1 = min(ty + MIRAX_TILE, y0 + h, dims[1])
        if ax0 < ax1 and ay0 < ay1:
            rgb = decode_jpeg("tile", payload)
            out[ay0 - y0:ay1 - y0, ax0 - x0:ax1 - x0] = rgb[ay0 - ty:ay1 - ty, ax0 - tx:ax1 - tx]
    return out


def write_formats_cohort(root: Path, dataset: str, files, write, folds, grids=None) -> list:
    """A cohort of ``files`` under ``root``: each written by ``write(i, path)``
    on threads, its grids for WSI_MAGS from the port's ``build_tissue_grid``
    over the port's reader (or ``grids(i, name, mag)``), and its tables.
    → tissue tiles by slide at each magnification."""
    from concurrent.futures import ThreadPoolExecutor

    from tpuwsi_torch.io import grids as t_grids
    from tpuwsi_torch.io.cohorts import get_datasets_dir_dict
    from tpuwsi_torch.io.slide_readers import open_slide
    from tpuwsi_torch.utils.minixlsx import write_xlsx

    cohort = Path(get_datasets_dir_dict(dataset, data_root=str(root))[dataset])
    cohort.mkdir(parents=True)

    def one(i: int) -> dict:
        write(i, cohort / files[i])
        reader = open_slide(str(cohort / files[i]))
        sizes = {}
        for mag in WSI_MAGS:
            grid = grids(i, files[i], mag) if grids else t_grids.build_tissue_grid(
                reader, WSI_TILE * WSI_OBJECTIVE // mag, preview_downsample=16)
            t_grids.save_grid_pickle(t_grids.grid_file_path(str(cohort), files[i], mag,
                                                            WSI_TILE), grid)
            sizes[mag] = len(grid)
        reader.close()
        return sizes

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        sizes = list(pool.map(one, range(len(files))))
    for mag in WSI_MAGS:
        total, legit = t_grids.grid_data_columns(WSI_TILE, mag)
        write_xlsx(str(cohort / f"Grids_{mag}" / "Grid_data.xlsx"), {
            "file": files, total: [s[mag] for s in sizes], legit: [s[mag] for s in sizes]})
    write_xlsx(str(cohort / f"slides_data_{dataset}.xlsx"), {
        "file": files, "id": [dataset] * len(files),
        "patient barcode": [f"{dataset}-{i:02d}" for i in range(len(files))],
        "ER status": ["Positive", "Negative"] * (len(files) // 2),
        "PR status": ["Negative", "Positive"] * (len(files) // 2),
        "test fold idx": folds, "Manipulated Objective Power": [WSI_OBJECTIVE] * len(files),
        "DX": [True] * len(files)})
    return sizes


def formats_ef_argv(dataset: str, root: Path) -> list:
    return ["-ef", "--dataset", dataset, "--data-root", str(root), "--model", MODEL,
            "--tile-size", str(WSI_TILE), "-nt", str(WSI_EF_TILES), "-tpi", str(WSI_EF_TILES)]


def phase_wsi_formats(smi: str) -> dict:
    """[wsi_formats]: the committed fixtures' digests through the port's C
    readers built here; the host's JPEG tile decode; ``main -ef`` over
    Deflate TIFFs of [wsi_cohort]'s slides (the PNG run's features bit for
    bit), over JPEG SVS slides, MIRAX slides and a TMA cohort; supervised
    ``main`` over the SVS slides at --mag 10. → launches per kernel."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from tpuwsi_torch.io import grids as t_grids
    from tpuwsi_torch.io.image import decode_jpeg
    from tpuwsi_torch.io.ingest import CTileReader, read_regions
    from tpuwsi_torch.io.levels import get_optimal_slide_level
    from tpuwsi_torch.io.slide_readers import check_readable, open_slide
    from tpuwsi_torch.io.wsi import tma_core

    shutil.rmtree(FORMATS_ROOT, ignore_errors=True)
    total = dict.fromkeys(all_launches(), 0)
    phase_t0 = time.perf_counter()

    # the committed fixtures, read by the port's C as this machine's compiler built it
    digests = json.loads((FIXTURES / "digests.json").read_text())
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa: E731
    checked = 0
    for name, want in digests.items():
        reader = open_slide(str(FIXTURES / name))
        dims = getattr(reader, "_level_dims", [reader.dimensions])
        got = [sha(reader.read_region((0, 0), level, d)) for level, d in enumerate(dims)]
        extra = {k: sha(tma_core(str(FIXTURES / name), int(k.rsplit("_", 1)[1])))
                 for k in want if k.startswith("tma_core_")}
        if got != want["sha256"] or any(extra[k] != want[k] for k in extra):
            raise RuntimeError(f"[wsi_formats] {name}: digests {got} {extra}, committed {want}")
        checked += len(got) + len(extra)
    print(f"[wsi_formats] the committed fixtures ({', '.join(digests)}) read by the port's C "
          f"readers give the JAX package's / PIL's bytes: {checked} SHA-256 digests of whole "
          f"levels and the TMA core's resize")

    # (b): JPEG SVS slides from the fixture's payloads; the host's tile decode on them
    data, pages = tiff_pages(FIXTURES / "tissue_ycbcr420.svs")
    pool = [[data[o:o + n] for o, n in zip(p[324], p[325])] for p in pages]
    tables = pages[0][347]
    root_b = FORMATS_ROOT / "svs"
    files_b = [f"svs_{i:02d}.svs" for i in range(len(WSI_FOLDS))]
    t0 = time.perf_counter()
    sizes_b = write_formats_cohort(root_b, "TCGA", files_b,
                                   lambda i, path: jpeg_svs(i, pool, tables, path), WSI_FOLDS)
    write_b_s = time.perf_counter() - t0
    standalone = pool[0][0][:2] + tables[2:-2] + pool[0][0][2:]  # SOI, the tables, the tile
    decode_jpeg("tile", standalone)
    t = time.perf_counter()
    for _ in range(FORMATS_DECODES):
        decode_jpeg("tile", standalone)
    decode_ms = (time.perf_counter() - t) * 1e3 / FORMATS_DECODES
    cohort_b = root_b / "Breast" / "TCGA"
    t = time.perf_counter()
    for name in files_b:  # the CLI's check before any file is written
        check_readable(str(cohort_b / name))
    check_ms = (time.perf_counter() - t) * 1e3 / len(files_b)
    side = WSI_SIZE // WSI_TILE
    region_ms = {}
    for threads, name in ((1, files_b[0]), (4, files_b[1])):  # tiles not decoded before
        reader = CTileReader(str(cohort_b / name))
        requests = [(reader, c * WSI_TILE, r * WSI_TILE, 0, WSI_TILE, WSI_TILE)
                    for r in range(side) for c in range(side)]
        t = time.perf_counter()
        _, failed = read_regions(requests, threads)
        region_ms[threads] = (time.perf_counter() - t) * 1e3 / len(requests)
        if failed:
            raise RuntimeError(f"[wsi_formats] {name}: {failed[:3]}")
        reader.close()
    print(f"[wsi_formats] (b) {len(files_b)} JPEG SVS slides of {WSI_SIZE}² (YCbCr 4:2:0 "
          f"tiles of {WSI_TILE}², JPEGTables, levels 1 and 2) from the fixture's "
          f"{sum(map(len, pool))} tile payloads in {write_b_s:.2f} s with their grids; tissue "
          f"tiles at --mag 20/10: {', '.join(f'{s[20]}/{s[10]}' for s in sizes_b)}. Host JPEG "
          f"decode of one {WSI_TILE}² tile (YCbCr 4:2:0, q80): {decode_ms:.3f} ms (decode_jpeg "
          f"on 1 thread, the mean of {FORMATS_DECODES}); through read_regions ({side ** 2} tiles "
          f"of a slide not read before, pread + decode + copy; the file in the page cache, "
          f"written just before): {region_ms[1]:.3f} ms a tile on 1 thread, {region_ms[4]:.3f} "
          f"ms on 4 (--workers' default); check_readable (the CLI's start-up check, the "
          f"TIFF's directories alone) {check_ms:.3f} ms a slide; host CPU, beside {smi}")

    # (a): the test fold's PNG slides as Deflate-tiled TIFFs, the PNG run's grids
    root_a = FORMATS_ROOT / "tif"
    pngs = [f"slide_{i:02d}" for i, f in enumerate(WSI_FOLDS) if f == 1][:FORMATS_TIFFS]
    t0 = time.perf_counter()
    write_formats_cohort(
        root_a, "TCGA", [f"{p}.tif" for p in pngs],
        lambda i, path: deflate_tiff(WSI_COHORT / f"{pngs[i]}.png", path), [1] * len(pngs),
        grids=lambda i, name, mag: t_grids.load_grid_pickle(t_grids.grid_file_path(
            str(WSI_COHORT), f"{pngs[i]}.png", mag, WSI_TILE)))
    mib = sum(f.stat().st_size for f in (root_a / "Breast" / "TCGA").glob("*.tif")) / 2**20
    print(f"[wsi_formats] (a) {len(pngs)} of [wsi_cohort]'s PNG slides as Deflate-tiled "
          f"pyramidal TIFFs with the predictor ({mib:.0f} MiB) in "
          f"{time.perf_counter() - t0:.2f} s")
    runs = {}
    for key, root, dataset, slides in (("a", root_a, "TCGA", len(pngs)),
                                       ("b", root_b, "TCGA", WSI_FOLDS.count(1))):
        argv = formats_ef_argv(dataset, root)
        runs[key] = rec = wsi_ef_run(20, argv=argv, tag=f"formats_{key}")
        counts = check_wsi_ef(20, rec, smi, argv=argv, tag=f"wsi_formats] [{key}", slides=slides)
        total = {k: total[k] + counts[k] for k in total}
    same = [Path(r.slide_name).stem for r in runs["a"]["agg"].results
            if (r.tile_locations, r.features.tobytes()) == (
                WSI_EF_PNG["features"][Path(r.slide_name).stem][0],
                WSI_EF_PNG["features"][Path(r.slide_name).stem][1].tobytes())]
    print(f"[wsi_formats] (a) -ef --mag 20 over the Deflate TIFFs against [wsi_ef]'s over the "
          f"same slides as PNG: the same locations and features bit for bit on {len(same)} of "
          f"{len(pngs)} slides")
    if len(same) != len(pngs):
        raise RuntimeError("[wsi_formats] the TIFF cohort's features differ from the PNG's")

    # (c): MIRAX slides at slide scale from the fixture's camera payloads, then a
    # TMA cohort of copies of the JPEG core
    pools = mirax_payloads(FIXTURES / "mirax" / "slide")
    root_m = FORMATS_ROOT / "mirax"
    files_m = [f"mirax_{i}.mrxs" for i in range(MIRAX_SLIDES)]
    t0 = time.perf_counter()
    sizes_m = write_formats_cohort(root_m, "TCGA", files_m,
                                   lambda i, path: write_mirax_slide(i, pools, path),
                                   [1] * MIRAX_SLIDES)
    write_m_s = time.perf_counter() - t0
    cohort_m, held = root_m / "Breast" / "TCGA", 0
    for i, name in enumerate(files_m):  # a region across cameras at levels 0 and 1
        reader = CTileReader(str(cohort_m / name))
        _, levels = mirax_tiles(i, pools)
        origin = (min(t[1] for t in levels[0]), min(t[2] for t in levels[0]))
        for level in (0, 1):
            box = (1000 + 37 * i, 900 + 53 * i, 512, 512)
            got = reader.read_region((box[0] << level, box[1] << level), level, box[2:])
            if not np.array_equal(got, mirax_stitch(levels[level], level, origin, box,
                                                    reader._level_dims[level])):
                raise RuntimeError(f"[wsi_formats] {name}: level {level} at {box} differs "
                                   "from the stitch of its tiles")
            held += 1
        dims = reader._level_dims
        reader.close()
    print(f"[wsi_formats] (c) {MIRAX_SLIDES} MIRAX slides of {dims[0][0]} x {dims[0][1]} "
          f"(levels {dims[1:]}; {MIRAX_CAMS}² cameras of 2 x 2 JPEG tiles of {MIRAX_TILE}², "
          f"overlapping by {MIRAX_OVERLAP} px at jittered positions in a zlib "
          f"StitchingIntensityLayer, two data files, chained index pages) from the fixture's "
          f"{sum(map(len, pools))} payloads in {write_m_s:.2f} s with their grids; tissue tiles "
          f"at --mag 20/10: {', '.join(f'{s[20]}/{s[10]}' for s in sizes_m)}; {held} regions "
          f"of 512² at levels 0 and 1 equal a numpy stitch of their tiles")
    for mag in WSI_MAGS:
        argv = formats_ef_argv("TCGA", root_m)
        runs[f"mirax{mag}"] = rec = wsi_ef_run(mag, argv=argv, tag="formats_mirax")
        counts = check_wsi_ef(mag, rec, smi, argv=argv, tag="wsi_formats] [mirax",
                              slides=MIRAX_SLIDES)
        total = {k: total[k] + counts[k] for k in total}
    root = FORMATS_ROOT / "tma"
    files = [f"tma_{i}.jpg" for i in range(FORMATS_COPIES)]
    write_formats_cohort(root, "TMA_HE_02_008", files,
                         lambda i, path: shutil.copyfile(FIXTURES / "core.jpg", path),
                         [1] * FORMATS_COPIES)
    argv = formats_ef_argv("TMA_HE_02_008", root)
    runs["tma"] = rec = wsi_ef_run(20, argv=argv, tag="formats_tma")
    counts = check_wsi_ef(20, rec, smi, argv=argv, tag="wsi_formats] [tma",
                          slides=FORMATS_COPIES)
    total = {k: total[k] + counts[k] for k in total}

    # supervised training over (b) at --mag 10: level 1 of each slide
    reader = CTileReader(str(cohort_b / files_b[-1]))
    level = get_optimal_slide_level(reader.level_downsamples, WSI_OBJECTIVE, 10, WSI_TILE)
    reader.close()
    argv = ["--dataset", "TCGA", "--data-root", str(root_b), "--model",
            "vit_small_patch16_224_dino", "--tile-size", str(WSI_TILE), "--mag", "10", "-b",
            str(SUP_BATCH), "--transform_type", "pcbnfrsc", "--opt", "sgd", "--lr-base", "0.1",
            "--smoothing", "0.1", "--model-ema", "--n_patches_train", str(FORMATS_SUP_TILES),
            "--n_patches_test", str(SUP_TEST_TILES), "-tpi", str(SUP_TEST_TILES), "-tf", "1",
            "--eval_rate", "1", "--seed", str(SEED), "--epochs", "1", "--max-steps-per-epoch",
            str(FORMATS_SUP_STEPS)]
    run = sup_run(FORMATS_ROOT / "sup", argv)
    want = {**dict.fromkeys(all_launches(), 0), "mha_qkv_fwd_saved": 12,
            "mha_qkv_bwd_saved": 12}
    losses = [r["loss"] for r in run["rows"]]
    print(f"[wsi_formats] supervised main() over (b) at --mag 10 (level {level[0]}, "
          f"{level[1]}² regions): {len(losses)} steps of {SUP_BATCH}, losses {losses}, "
          f"launches a step {[r['launches'] for r in run['rows']]}; main() {run['wall']:.2f} s")
    if level[0] != 1 or len(losses) != FORMATS_SUP_STEPS or not np.isfinite(losses).all() \
            or any(r["launches"] != want for r in run["rows"]):
        raise RuntimeError("[wsi_formats] supervised training over the JPEG SVS slides")
    total = {k: total[k] + run["total"][k] for k in total}
    del run
    print(f"[wsi_formats] -ef --mag 20 tiles/s: PNG {WSI_EF_PNG['tiles_s']:.1f} ([wsi_ef], "
          f"{WSI_FOLDS.count(1)} slides), JPEG SVS {runs['b']['tiles_s']:.1f} (as many), "
          f"MIRAX {runs['mirax20']['tiles_s']:.1f} ({MIRAX_SLIDES} slides; "
          f"{runs['mirax10']['tiles_s']:.1f} at --mag 10), Deflate TIFF "
          f"{runs['a']['tiles_s']:.1f} ({FORMATS_TIFFS} slides), TMA "
          f"{runs['tma']['tiles_s']:.1f} ({FORMATS_COPIES} cores); the card idle "
          + ", ".join(f"{k} {100 * r['idle']:.1f}%" for k, r in runs.items())
          + f" of main(); the phase took {time.perf_counter() - phase_t0:.1f} s; on {smi}")
    shutil.rmtree(FORMATS_ROOT, ignore_errors=True)
    shutil.rmtree(WSI_RUNS, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


def write_mil_set(path: Path, n: int, seed: int, like=None, shift=0.3):
    """``n`` slides of 100 to MIL_TILES tiles x MIL_DIM fp32 features, NaN past
    each slide's tiles, as -ef's 8-tuple pickle: class-1 slides (every other
    one) shifted by ``shift`` in their first 32 dimensions. ``like``: another
    set's (names, tile locations, tile counts), for its is_Tumor twin. → this
    set's."""
    import pickle

    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, 1, MIL_TILES, MIL_DIM), dtype=np.float32)
    labels = np.arange(n) % 2
    feats[labels == 1, :, :, :32] += shift
    if like is None:
        like = ([f"slide_{seed}_{i:04d}.svs" for i in range(n)],
                rng.integers(0, 40000, (n, MIL_TILES, 2)).astype(np.float32),
                rng.integers(100, MIL_TILES + 1, n))
    names, locations, counts = like
    for i, c in enumerate(counts):
        feats[i, :, c:] = np.nan
    scores = np.full((n, MIL_TILES), np.nan, np.float32)
    with open(path, "wb") as f:
        pickle.dump((labels, labels, labels.astype(float), scores, names, feats, 0, locations),
                    f, protocol=pickle.HIGHEST_PROTOCOL)
    return like


def mil_run(argv: list, device: str) -> dict:
    """``cli.mil_train.main(argv)`` on ``device``, recording the steps' CUDA
    events on the card and the training loop's wall time. → model, state,
    final metrics, steps, wall and busy ms, the launches, the xlsx's cells."""
    from tpuwsi_torch.cli import mil_train
    from tpuwsi_torch.mil import train as mil_train_mod
    from tpuwsi_torch.utils.minixlsx import read_xlsx

    rec = {"events": [], "loop_s": 0.0}
    real = (mil_train_mod.make_mil_train_step, mil_train_mod.train_mil_head)

    def recording_step(*a, **kw):
        step = real[0](*a, **kw)
        if device == "cpu":
            return step

        def recorded(state, batch):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = step(state, batch)
            end.record()
            rec["events"].append((start, end))
            return out

        return recorded

    def timed_head(*a, **kw):
        t0 = time.perf_counter()
        out = real[1](*a, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        rec["loop_s"] = time.perf_counter() - t0
        return out

    out = Path(argv[argv.index("--output") + 1])
    mil_train_mod.make_mil_train_step, mil_train_mod.train_mil_head = recording_step, timed_head
    try:
        reset_launches()
        t0 = time.perf_counter()
        model, state, final = mil_train.main(argv, device=torch.device(device))
        rec["wall"] = time.perf_counter() - t0
        rec["launches"] = all_launches()
    finally:
        mil_train_mod.make_mil_train_step, mil_train_mod.train_mil_head = real
    rec["busy_ms"] = sum(a.elapsed_time(b) for a, b in rec["events"])
    rec.update(model=model, state=state, final=final, steps=state.step,
               cells=read_xlsx(str(out / "slide_scores.xlsx")),
               bias=float(model.att_w.bias.detach()))
    return rec


def check_mil_against_cpu(tag: str, card: dict, cpu: dict, n_eval: int) -> None:
    """The card's final metrics and slide_scores.xlsx against the CPU run's
    (MIL_CELL_TOL and its reasons)."""
    fc, fp = card["final"], cpu["final"]
    worst = {}
    for name in cpu["cells"]:
        shift = (card["bias"], cpu["bias"]) if name.startswith("attn_before") else (0.0, 0.0)
        for g, w in zip(card["cells"][name], cpu["cells"][name]):
            if isinstance(w, str):
                if g != w:
                    raise RuntimeError(f"[mil] {tag}: {name} {g!r} against {w!r}")
            elif isinstance(w, float) and not math.isnan(w):
                group = name.rsplit("_", 1)[0] if name[-1].isdigit() else name
                worst[group] = max(worst.get(group, 0.0), abs((g - shift[0]) - (w - shift[1])))
    pos = sum(1 for t in cpu["cells"]["target"] if t == 1)
    auc_tol = 1.0 / max(pos * (n_eval - pos), 1)
    print(f"[mil] {tag}: the card's run against the CPU's from the same weights and bag "
          f"draws: eval_auc {fc.get('eval_auc')} / {fp.get('eval_auc')} (within {auc_tol:.2e}), "
          f"eval_acc {fc['eval_acc']} / {fp['eval_acc']} (within {1 / n_eval:.3f}); "
          f"slide_scores.xlsx's largest differences by column group "
          f"{ {k: f'{v:.2e}' for k, v in worst.items()} } (<= {MIL_CELL_TOL}; attn_before less "
          f"each run's att_w.bias, {card['bias']:.3e} / {cpu['bias']:.3e})")
    if not fc["eval_n_slides"] == fp["eval_n_slides"] == n_eval or card["steps"] != cpu["steps"] \
            or abs(fc.get("eval_auc", 0.5) - fp.get("eval_auc", 0.5)) > auc_tol \
            or abs(fc["eval_acc"] - fp["eval_acc"]) > 1 / n_eval + 1e-12 \
            or max(worst.values()) > MIL_CELL_TOL:
        raise RuntimeError(f"[mil] {tag}: the card and the CPU disagree")


def print_mil_timing(tag: str, rec: dict, epochs: int, smi: str) -> None:
    idle = 1.0 - rec["busy_ms"] / (rec["loop_s"] * 1e3)
    print(f"[mil] {tag}: {rec['steps']} steps over {epochs} epochs in "
          f"{rec['loop_s']:.2f} s = {rec['loop_s'] * 1e3 / epochs:.1f} ms per epoch (each "
          f"epoch's evaluation included), main() {rec['wall']:.2f} s; the steps' device time "
          f"{rec['busy_ms']:.1f} ms (CUDA events around each step), so the card idles "
          f"{100 * idle:.1f}% of the loop; on {smi}")


def phase_mil(smi: str) -> dict:
    """[mil]: ``python -m tpuwsi_torch.cli.mil_train`` on the card, over (a)
    the port's own -ef features (fold 2's slides train, [wsi_ef]'s fold 1
    evaluates), (b) a cohort-scale set written from SEED, both held against
    the same runs on the CPU, and (c) the paired Receptor+is_Tumor mode at
    768 through the registry. → launches (K2 of (a)'s -ef, 12 a chunk; the
    MIL head runs no kernel)."""
    none = dict.fromkeys(all_launches(), 0)
    MIL_ROOT.mkdir(parents=True, exist_ok=True)
    # (a) -ef over fold 2 (the training bags), then the head
    reset_launches()
    agg = cli_train.main(WSI_EF_ARGV + ["--mag", "20", "-tf", "2", "--output",
                                        str(MIL_ROOT / "ef")])
    ef = all_launches()
    n_tiles = sum(len(r.tile_locations) for r in agg.results)
    chunks = sum(-(-len(r.tile_locations) // WSI_EF_TILES) for r in agg.results)
    exp = next(d for d in (MIL_ROOT / "ef").iterdir() if d.name.startswith("Exp_"))
    train_data = exp / "features" / "inference.data"
    print(f"[mil] -ef over fold 2: {len(agg.results)} slides, {n_tiles} tiles in {chunks} "
          f"chunks, launches {ef}")
    if ef != {**none, "mha_qkv_fwd": 12 * chunks} or len(agg.results) != 4:
        raise RuntimeError(f"[mil] -ef launched {ef}")
    argv = MIL_ARGV + ["--features", str(train_data), "--test-features",
                       str(MIL_ROOT / "fold1.data"), "--epochs", str(MIL_EPOCHS)]
    runs = {d: mil_run(argv + ["--output", str(MIL_ROOT / f"ef_{d}")], d)
            for d in ("cuda", "cpu")}
    if runs["cuda"]["launches"] != none:
        raise RuntimeError(f"[mil] the MIL head launched {runs['cuda']['launches']}")
    print(f"[mil] over -ef's features (4 fold-2 slides train, [wsi_ef]'s 8 fold-1 slides "
          f"evaluate, 384 wide): final {runs['cuda']['final']}")
    check_mil_against_cpu("-ef features", runs["cuda"], runs["cpu"], 8)
    print_mil_timing("-ef features", runs["cuda"], MIL_EPOCHS, smi)

    # (b) a cohort: MIL_SLIDES training and MIL_TEST_SLIDES held-out slides
    t0 = time.perf_counter()
    write_mil_set(MIL_ROOT / "train.data", MIL_SLIDES, SEED)
    write_mil_set(MIL_ROOT / "test.data", MIL_TEST_SLIDES, SEED + 1)
    size = sum((MIL_ROOT / f).stat().st_size for f in ("train.data", "test.data"))
    print(f"[mil] wrote {MIL_SLIDES} + {MIL_TEST_SLIDES} slides of 100-{MIL_TILES} tiles x "
          f"{MIL_DIM} fp32 as -ef's pickle ({size / 2**20:.0f} MiB) in "
          f"{time.perf_counter() - t0:.1f} s")
    argv = MIL_ARGV + ["--features", str(MIL_ROOT / "train.data"), "--test-features",
                       str(MIL_ROOT / "test.data"), "--epochs", str(MIL_EPOCHS)]
    runs = {d: mil_run(argv + ["--output", str(MIL_ROOT / f"cohort_{d}")], d)
            for d in ("cuda", "cpu")}
    final = runs["cuda"]["final"]
    print(f"[mil] cohort: final {final}")
    if runs["cuda"]["launches"] != none or not 0.5 < final.get("eval_auc", 0.0) <= 1.0:
        raise RuntimeError(f"[mil] cohort: launches {runs['cuda']['launches']}, final {final}")
    check_mil_against_cpu("cohort", runs["cuda"], runs["cpu"], MIL_TEST_SLIDES)
    print_mil_timing("cohort", runs["cuda"], MIL_EPOCHS, smi)
    print_mil_timing("cohort on the CPU", {**runs["cpu"], "busy_ms": 0.0}, MIL_EPOCHS,
                     f"{os.cpu_count()} host cores")

    # (c) the paired Receptor+is_Tumor mode through the registry, 384 + 384
    registry = {}
    for split, n, seed in (("train", MIL_PAIRED_SLIDES, SEED + 2),
                           ("test", MIL_PAIRED_TEST, SEED + 3)):
        like = write_mil_set(MIL_ROOT / f"receptor_{split}.data", n, seed)
        write_mil_set(MIL_ROOT / f"tumor_{split}.data", n, seed + 10, like, shift=0.0)
        registry[split] = (str(MIL_ROOT / f"receptor_{split}.data"),
                           str(MIL_ROOT / f"tumor_{split}.data"))
    (MIL_ROOT / "registry.json").write_text(json.dumps({"CAT": {"ER": {"1": {
        "TrainSet Location": {k: v[0] for k, v in registry.items()},
        "is_Tumor": {"TrainSet Location": {k: v[1] for k, v in registry.items()}}}}}}))
    os.environ["TPUWSI_FEATURE_REGISTRY"] = str(MIL_ROOT / "registry.json")
    try:
        paired = mil_run(MIL_ARGV + ["--dataset", "CAT", "-tar", "ER", "-tf", "1",
                                     "--paired-is-tumor", "--epochs", "5", "--output",
                                     str(MIL_ROOT / "paired")], "cuda")
    finally:
        del os.environ["TPUWSI_FEATURE_REGISTRY"]
    from tpuwsi_torch.mil.features import load_inference_file

    weight = paired["model"].classifier.weight.detach().cpu().numpy()
    feats = load_inference_file(registry["test"][0])[5]
    nan = np.isnan(feats[0, 0, :, 0])
    n0 = int(nan.argmax()) if nan.any() else MIL_TILES
    want = feats[0, 0, :n0] @ (weight[1] - weight[0])[:MIL_DIM]
    got = np.asarray([paired["cells"][f"tile_score_{j}"][0] for j in range(n0)])
    err = float(np.abs(got - want).max())
    print(f"[mil] paired Receptor+is_Tumor ({MIL_PAIRED_SLIDES} + {MIL_PAIRED_TEST} slides, "
          f"{2 * MIL_DIM} wide; the classifier {tuple(weight.shape)}): final {paired['final']}; "
          f"the first slide's {n0} tile scores against the receptor half's readout: max "
          f"difference {err:.2e}")
    if weight.shape != (2, 2 * MIL_DIM) or err > 1e-4 or paired["launches"] != none:
        raise RuntimeError("[mil] paired: the head, the tile scores or the launches")
    print_mil_timing("paired", paired, 5, smi)
    shutil.rmtree(MIL_ROOT, ignore_errors=True)
    return ef


def phase_wsi_ssl(smi: str) -> dict:
    """[wsi_ssl]: ``python -m tpuwsi_torch.cli.train --ssl`` over the cohort's
    training fold on the card (WSITileSampler at --mag 10): [train_ssl]'s
    recipe with the slide table in place of the folder; → launches."""
    run = ssl_run(WSI_RUNS / "ssl", WSI_SSL_ARGV)
    rows, depth = run["rows"], 12
    n_steps = WSI_FOLDS.count(2) * WSI_SSL_TILES // TRAIN_BATCH
    want = {**dict.fromkeys(all_launches(), 0), "mha_qkv_fwd": depth,
            "mha_qkv_fwd_saved": 2 * depth, "mha_qkv_bwd_saved": 2 * depth}
    for i, r in enumerate(rows):
        print(f"[wsi_ssl] step {i}: loss {r['loss']:.6f} launches {r['launches']}")
        if not np.isfinite(r["loss"]) or r["launches"] != want:
            raise RuntimeError(f"[wsi_ssl] step {i}: loss {r['loss']}, launches "
                               f"{r['launches']}, expected {want}")
    if len(rows) != n_steps:
        raise RuntimeError(f"[wsi_ssl] {len(rows)} steps, expected {n_steps}")
    exp = next(d for d in run["out"].iterdir() if d.name.startswith("Exp_"))
    steps = sorted(int(d.name) for d in (exp / "checkpoints").iterdir())
    if steps != [n_steps]:
        raise RuntimeError(f"[wsi_ssl] checkpoints at steps {steps}")
    gaps, wait = loop_timing(run, 1, n_steps)
    held = WSI_FOLDS.count(2) * WSI_SIZE ** 2 * 3
    print(f"[wsi_ssl] {n_steps} steps of {TRAIN_BATCH} tiles (4 slides x {WSI_SSL_TILES} at "
          f"--mag 10: 512² regions resized to 256², the random shift on), a checkpoint at step "
          f"{steps[0]}; main() took {run['wall']:.2f} s; the loop "
          f"{', '.join(f'{g:.2f}' for g in gaps)} ms per step (median "
          f"{statistics.median(gaps):.2f}), {100 * wait:.1f}% of it waiting on the Prefetcher, "
          f"the first step {rows[0]['wait']:.2f} s (decoding the four slides); the bare step of "
          f"[train] {STEP_MS['tuned']:.2f} ms; peak device memory {run['peak'] / 2**30:.2f} GiB; "
          f"the sampler holds {held / 2**20:.0f} MiB of decoded slides; on {smi}")
    total = run["total"]
    del run["state"]
    shutil.rmtree(WSI_RUNS, ignore_errors=True)  # ~0.66 GB of checkpoint
    torch.cuda.empty_cache()
    return total


def sup_run(out: Path, argv: list, plain: bool = False) -> dict:
    """``cli.train.main(argv)`` (supervised) on the card, writing under
    ``out``, recording per step its launches, entry time, CUDA events around
    it, its loss and the loop's wait on the Prefetcher so far; ``plain``
    builds the model with plain attention and replays the EMA copy's update
    in float64 beside the step (untimed). → state, rows, total launches,
    peak memory, wall seconds, output dir, the initial weights, the replayed
    EMA copy and its rounding bound."""
    rows, feeds, init, ema_ref, ema_bound = [], [], [], [], []
    real = (cli_train.make_train_step, cli_train.supervised_model, prefetch.Prefetcher)

    def waited() -> float:
        return sum(f.wait_s for f in feeds)

    def recording_step(*a, **kw):
        step = real[0](*a, **kw)
        # the device reckons the update with fp32 constants
        decay = float(torch.tensor(kw["ema_decay"], dtype=torch.float32))
        rest = float(torch.tensor(1.0 - kw["ema_decay"], dtype=torch.float32))

        def recorded(state, batch, generator=None):
            if not init:
                init.extend(p.detach().clone() for p in state.model.parameters())
                if plain:
                    ema_ref.extend(e.detach().double() for e in state.ema.parameters())
                    ema_bound.extend(torch.zeros_like(r) for r in ema_ref)
            before = all_launches()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            start.record()
            state, metrics = step(state, batch, generator)
            end.record()
            rows.append({"t": t, "wait": waited(), "loss": metrics["loss"], "events": (start, end),
                         "launches": {k: v - before[k] for k, v in all_launches().items()}})
            if plain:
                with torch.no_grad():
                    for r, b, p in zip(ema_ref, ema_bound, state.model.parameters()):
                        p = p.detach().double()
                        b.add_(r.abs()).add_(p.abs(), alpha=rest)
                        r.mul_(decay).add_(p, alpha=rest)
            return state, metrics

        return recorded

    def plain_model(args, num_classes, on_cuda):
        m = real[1](args, num_classes, on_cuda)
        return type(m)(dataclasses.replace(m.config, use_kernel_attention=False)).eval()

    class RecordedPrefetcher(real[2]):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            feeds.append(self)

    cli_train.make_train_step, prefetch.Prefetcher = recording_step, RecordedPrefetcher
    if plain:
        cli_train.supervised_model = plain_model
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state = cli_train.main(argv + ["--output", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = all_launches()
    finally:
        cli_train.make_train_step, cli_train.supervised_model, prefetch.Prefetcher = real
    for r in rows:
        r["loss"] = r["loss"].item()
        r["ms"] = r["events"][0].elapsed_time(r["events"][1])
        del r["events"]
    return {"state": state, "rows": rows, "total": total, "wall": wall, "out": out,
            "peak": torch.cuda.max_memory_allocated(), "init": init, "ema_ref": ema_ref,
            "ema_bound": ema_bound}


def global_norm(tensors) -> float:
    return math.sqrt(sum(float(t.double().square().sum()) for t in tensors))


def relative_distance(a, b, start) -> tuple:
    """→ (|a - b|, |a - start|, their ratio) over sequences of tensors, in
    float64."""
    d = global_norm(x.double() - y.double() for x, y in zip(a, b))
    moved = global_norm(x.double() - y.double() for x, y in zip(a, start))
    return d, moved, d / moved


def max_over_bound(got, want, bound) -> float:
    """The largest |got - want| / (fp32's epsilon x bound) over sequences
    of tensors, in float64; inf where the bound is 0 and the two differ."""
    eps, worst = torch.finfo(torch.float32).eps, 0.0
    for g, w, b in zip(got, want, bound):
        gap = (g.double() - w).abs()
        ratio = torch.where(b > 0, gap / (eps * b).clamp_min(1e-300),
                            torch.where(gap > 0, torch.inf, 0.0))
        worst = max(worst, float(ratio.max()))
    return worst


def phase_train_sup(smi: str) -> dict:
    """[train_sup]: ``python -m tpuwsi_torch.cli.train`` (supervised, WSI
    mode) over the cohort on the card: the recipe of
    scripts/train-supervised.sh at full width, K1a and K1b at 257 tokens;
    then the same run with plain attention; → launches."""
    depth, n_steps = 12, SUP_EPOCHS * SUP_STEPS
    argv = SUP_ARGV + ["--epochs", str(SUP_EPOCHS), "--max-steps-per-epoch", str(SUP_STEPS)]
    run = sup_run(SUP_RUNS / "kernel", argv)
    rows, none = run["rows"], dict.fromkeys(all_launches(), 0)
    want = {**none, "mha_qkv_fwd_saved": depth, "mha_qkv_bwd_saved": depth}
    for i, r in enumerate(rows):
        print(f"[train_sup] step {i}: loss {r['loss']:.6f}, device {r['ms']:.2f} ms, "
              f"launches {r['launches']}")
        if not np.isfinite(r["loss"]) or r["launches"] != want:
            raise RuntimeError(f"[train_sup] step {i}: loss {r['loss']}, launches "
                               f"{r['launches']}, expected {want}")
    if len(rows) != n_steps:
        raise RuntimeError(f"[train_sup] {len(rows)} steps, expected {n_steps}")
    evals = {k: v - sum(r["launches"][k] for r in rows) for k, v in run["total"].items()}
    chunks = evals["mha_qkv_fwd"] // depth
    if evals != {**none, "mha_qkv_fwd": depth * chunks} or chunks < SUP_EPOCHS:
        raise RuntimeError(f"[train_sup] the slide evaluations launched {evals}")
    exp = next(d for d in run["out"].iterdir() if d.name.startswith("Exp_"))
    steps = sorted(int(d.name) for d in (exp / "checkpoints").iterdir() if d.name.isdigit())
    with open(exp / "summary.csv") as f:
        summary = list(csv.DictReader(f))
    print(f"[train_sup] the slide evaluations: {evals} ({chunks} chunks of "
          f"{SUP_TEST_TILES} tiles over {SUP_EPOCHS} evaluations); checkpoints at steps {steps}; "
          f"summary.csv {summary}")
    if steps != [SUP_STEPS * (e + 1) for e in range(SUP_EPOCHS)] or len(summary) != SUP_EPOCHS \
            or not all(0.0 <= float(r["eval_auc"]) <= 1.0 for r in summary) \
            or not all(np.isfinite(float(r["train_loss"])) for r in summary):
        raise RuntimeError("[train_sup] checkpoints or summary.csv")

    # the same run with plain attention: every loss, the final weights and
    # EMA copies against each other, the EMA copy against its replay
    plain = sup_run(SUP_RUNS / "plain", argv, plain=True)
    if plain["total"] != none or len(plain["rows"]) != n_steps:
        raise RuntimeError(f"[train_sup] plain attention: {len(plain['rows'])} steps, launches "
                           f"{plain['total']}")
    diff = max(abs(a["loss"] - b["loss"]) for a, b in zip(rows, plain["rows"]))
    print(f"[train_sup] the {n_steps} losses against the same run with plain attention: "
          f"{[r['loss'] for r in plain['rows']]}; largest difference {diff:.3e} "
          f"(<= {SUP_LOSS_MAX_DIFF})")
    k_state, p_state = run["state"], plain["state"]
    for a, b in zip(run["init"], plain["init"]):
        if not torch.equal(a, b):
            raise RuntimeError("[train_sup] the two runs started from different weights")
    param_gap = relative_distance(list(k_state.model.parameters()),
                                  list(p_state.model.parameters()), run["init"])
    ema_gap = relative_distance(list(k_state.ema.parameters()), list(p_state.ema.parameters()),
                                run["init"])
    ema_rounding = max_over_bound(p_state.ema.parameters(), plain["ema_ref"],
                                  plain["ema_bound"])
    print(f"[train_sup] final weights: norm {global_norm(k_state.model.parameters()):.6f} "
          f"(kernel) / {global_norm(p_state.model.parameters()):.6f} (plain), moved "
          f"{param_gap[1]:.6e} from the initial ones, {param_gap[0]:.6e} apart = "
          f"{param_gap[2]:.3e} of the move (<= {SUP_PARAM_MAX_REL}); EMA copies: norm "
          f"{global_norm(k_state.ema.parameters()):.6f} / "
          f"{global_norm(p_state.ema.parameters()):.6f}, moved {ema_gap[1]:.6e}, "
          f"{ema_gap[0]:.6e} apart = {ema_gap[2]:.3e} (<= {SUP_PARAM_MAX_REL}); the plain run's "
          f"EMA copy against its float64 replay: at most {ema_rounding:.3f} of fp32's rounding "
          f"bound (<= {SUP_EMA_MAX_ROUNDING})")
    if not (diff <= SUP_LOSS_MAX_DIFF and param_gap[2] <= SUP_PARAM_MAX_REL
            and ema_gap[2] <= SUP_PARAM_MAX_REL and ema_rounding <= SUP_EMA_MAX_ROUNDING):
        raise RuntimeError("[train_sup] the kernel and plain-attention runs disagree, or the "
                           "EMA copy its replay")

    # the recipe alone on a batch as the step gets it
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tiles = torch.randint(0, 256, (SUP_BATCH, WSI_TILE, WSI_TILE, 3), generator=gen,
                          device="cuda", dtype=torch.uint8)
    recipe = make_recipe("pcbnfrsc", train=True)
    recipe_ms = cuda_median_ms(lambda: recipe(tiles, gen), reps=10)
    gaps, wait = loop_timing(run, SUP_EPOCHS, SUP_STEPS)
    device_ms = [r["ms"] for r in rows[1:]]
    med = statistics.median(device_ms)
    STEP_MS["train_sup_loop"], STEP_MS["train_sup_stream"] = statistics.median(gaps), med
    print(f"[train_sup] {n_steps} steps of {SUP_BATCH} tiles (4 slides x {WSI_SSL_TILES} at "
          f"--mag 10, ViT-S/16 at 257 tokens, pcbnfrsc, Nesterov SGD, EMA), evaluations of "
          f"8 slides x {SUP_TEST_TILES} tiles after each of {SUP_EPOCHS} epochs; main() took "
          f"{run['wall']:.2f} s. The step's stream time (CUDA events around it) "
          f"{', '.join(f'{m:.2f}' for m in device_ms)} ms after the first (median {med:.2f} = "
          f"{SUP_BATCH / med * 1e3:.1f} tiles/s); the loop "
          f"{', '.join(f'{g:.2f}' for g in gaps)} ms per step (gaps between step starts; median "
          f"{statistics.median(gaps):.2f} = {SUP_BATCH / statistics.median(gaps) * 1e3:.1f} "
          f"tiles/s), {100 * wait:.1f}% of it waiting on the Prefetcher, the first step "
          f"{rows[0]['wait']:.2f} s; the pcbnfrsc recipe alone on {SUP_BATCH} uint8 tiles "
          f"{recipe_ms:.2f} ms; peak device memory {run['peak'] / 2**30:.2f} GiB; on {smi}")
    total = {k: run["total"][k] + plain["total"][k] for k in run["total"]}
    del run["state"], plain["state"], k_state, p_state, tiles
    # ~1 GB of checkpoints; the cohort stays for phase_profiles
    shutil.rmtree(SUP_RUNS, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


def write_survival_cohort() -> None:
    """[wsi_cohort]'s slides as the ABCTB cohort under SURV_ROOT: links to its
    PNG files and Grids_10, and a slides_data_ABCTB.xlsx with the four
    survival columns."""
    from tpuwsi_torch.io.cohorts import get_datasets_dir_dict
    from tpuwsi_torch.utils.minixlsx import read_xlsx, write_xlsx

    cohort = Path(get_datasets_dir_dict("ABCTB", data_root=str(SURV_ROOT))["ABCTB"])
    shutil.rmtree(SURV_ROOT, ignore_errors=True)
    cohort.mkdir(parents=True)
    slides = read_xlsx(str(WSI_COHORT / "slides_data_TCGA.xlsx"))
    for name in slides["file"]:
        (cohort / name).symlink_to(WSI_COHORT / name)
    (cohort / "Grids_10").symlink_to(WSI_COHORT / "Grids_10", target_is_directory=True)
    n = len(slides["file"])
    write_xlsx(str(cohort / "slides_data_ABCTB.xlsx"), {
        "file": slides["file"], "id": ["ABCTB"] * n,
        "patient barcode": slides["patient barcode"], **SURVIVAL_CELLS,
        "test fold idx": slides["test fold idx"],
        "Manipulated Objective Power": slides["Manipulated Objective Power"]})


def survival_run(out: Path, argv: list, plain: bool = False) -> dict:
    """``cli.train.main(argv)`` (-tar Survival_*) on the card, writing under
    ``out``, recording per step its launches, entry time, CUDA events around
    it, its metrics, its 5-year labels and the model's output in the step;
    ``plain`` builds the model with plain attention. → state, rows, total
    launches, peak memory, wall seconds, output dir and the initial weights."""
    from tpuwsi_torch.train import survival as t_survival

    rows, init, outputs = [], [], []
    real = (t_survival.make_survival_train_step, cli_train.supervised_model)

    def recording_step(*a, **kw):
        step = real[0](*a, **kw)

        def recorded(state, batch, generator=None):
            if not init:
                init.extend(p.detach().clone() for p in state.model.parameters())
            before = all_launches()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            start.record()
            state, metrics = step(state, batch, generator)
            end.record()
            rows.append({"t": t, "metrics": metrics, "events": (start, end),
                         "labels": batch["binary_targets"], "out": outputs.pop(),
                         "launches": {k: v - before[k] for k, v in all_launches().items()}})
            return state, metrics

        return recorded

    def recorded_model(args, num_classes, on_cuda):
        m = real[1](args, num_classes, on_cuda)
        if plain:
            m = type(m)(dataclasses.replace(m.config, use_kernel_attention=False)).eval()
        # the step's output (the evaluation runs without gradients)
        m.register_forward_hook(
            lambda mod, inp, o: outputs.append(o.detach()) if torch.is_grad_enabled() else None)
        return m

    t_survival.make_survival_train_step = recording_step
    cli_train.supervised_model = recorded_model
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state = cli_train.main(argv + ["--output", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = all_launches()
    finally:
        t_survival.make_survival_train_step, cli_train.supervised_model = real
    for r in rows:
        r["metrics"] = {k: v.item() for k, v in r["metrics"].items()}
        r["loss"] = r["metrics"]["loss"]
        r["ms"] = r["events"][0].elapsed_time(r["events"][1])
        r["labels"], r["out"] = r["labels"].cpu().numpy(), r["out"].float().cpu().numpy()
        del r["events"]
    return {"state": state, "rows": rows, "total": total, "wall": wall, "out": out,
            "peak": torch.cuda.max_memory_allocated(), "init": init}


def check_survival_run(tag: str, run: dict, epochs: int, steps: int, metric: str) -> dict:
    """Launches per step (K1a = K1b = 12 at 257 tokens, nothing else), the
    evaluations' (K2 only, 12 a chunk of the 7 slides), finite losses, the
    checkpoints and summary.csv. → the evaluations' launches."""
    depth, rows = 12, run["rows"]
    none = dict.fromkeys(all_launches(), 0)
    want = {**none, "mha_qkv_fwd_saved": depth, "mha_qkv_bwd_saved": depth}
    for i, r in enumerate(rows):
        print(f"[train_survival] {tag} step {i}: {r['metrics']}, device {r['ms']:.2f} ms, "
              f"launches {r['launches']}")
        if not np.isfinite(r["loss"]) or r["launches"] != want:
            raise RuntimeError(f"[train_survival] {tag} step {i}: loss {r['loss']}, launches "
                               f"{r['launches']}, expected {want}")
    if len(rows) != epochs * steps:
        raise RuntimeError(f"[train_survival] {tag}: {len(rows)} steps")
    evals = {k: v - sum(r["launches"][k] for r in rows) for k, v in run["total"].items()}
    if evals != {**none, "mha_qkv_fwd": depth * SURV_EVAL_SLIDES * epochs}:
        raise RuntimeError(f"[train_survival] {tag}: the slide evaluations launched {evals}, "
                           f"expected K2 = {depth} x {SURV_EVAL_SLIDES} chunks x {epochs}")
    exp = next(d for d in run["out"].iterdir() if d.name.startswith("Exp_"))
    steps_saved = sorted(int(d.name) for d in (exp / "checkpoints").iterdir()
                         if d.name.isdigit())
    with open(exp / "summary.csv") as f:
        summary = list(csv.DictReader(f))
    print(f"[train_survival] {tag}: the slide evaluations {evals}; checkpoints at steps "
          f"{steps_saved}; summary.csv {summary}")
    if steps_saved != [steps * (e + 1) for e in range(epochs)] or len(summary) != epochs \
            or not all(0.0 <= float(r["eval_c_index"]) <= 1.0 for r in summary) \
            or not all(np.isfinite(float(r["train_loss"])) and f"train_{metric}" in r
                       for r in summary):
        raise RuntimeError(f"[train_survival] {tag}: checkpoints or summary.csv")
    return evals


def phase_train_survival(smi: str) -> dict:
    """[train_survival]: ``python -m tpuwsi_torch.cli.train -tar
    Survival_Time`` over the cohort on the card at full width (ViT-S/16 at
    257 tokens, -b 256), K1a and K1b 12 a step and K2 in the slide
    evaluations; the same with plain attention, held to [train_sup]'s
    bounds; then one epoch of -tar Survival_Binary, its masked loss and AUC
    held against the host's from the step's own logits; → launches."""
    from tpuwsi_torch.infer.aggregate import roc_auc

    write_survival_cohort()
    argv = SURV_ARGV + ["--epochs", str(SURV_EPOCHS), "--max-steps-per-epoch", str(SURV_STEPS)]
    cox = argv + ["-tar", "Survival_Time"]
    run = survival_run(SURV_RUNS / "kernel", cox)
    total = check_survival_run("Cox", run, SURV_EPOCHS, SURV_STEPS, "c_index")
    total = {k: sum(r["launches"][k] for r in run["rows"]) + total[k] for k in total}
    plain = survival_run(SURV_RUNS / "plain", cox, plain=True)
    if any(plain["total"].values()) or len(plain["rows"]) != len(run["rows"]):
        raise RuntimeError(f"[train_survival] plain attention: {len(plain['rows'])} steps, "
                           f"launches {plain['total']}")
    for a, b in zip(run["init"], plain["init"]):
        if not torch.equal(a, b):
            raise RuntimeError("[train_survival] the two runs started from different weights")
    diff = max(abs(a["loss"] - b["loss"]) for a, b in zip(run["rows"], plain["rows"]))
    gap = relative_distance(list(run["state"].model.parameters()),
                            list(plain["state"].model.parameters()), run["init"])
    device_ms = [r["ms"] for r in run["rows"][1:]]
    gaps = [(b["t"] - a["t"]) * 1e3 for e in range(SURV_EPOCHS)
            for a, b in zip(run["rows"][e * SURV_STEPS:(e + 1) * SURV_STEPS],
                            run["rows"][e * SURV_STEPS + 1:(e + 1) * SURV_STEPS])]
    print(f"[train_survival] Cox: {len(run['rows'])} steps of {SUP_BATCH} tiles (4 slides x "
          f"{WSI_SSL_TILES} at --mag 10, ViT-S/16 at 257 tokens, pcbnfrsc, Nesterov SGD), "
          f"evaluations of {SURV_EVAL_SLIDES} slides x {SUP_TEST_TILES} tiles after each of "
          f"{SURV_EPOCHS} epochs; main() took {run['wall']:.2f} s; the step's stream time "
          f"{', '.join(f'{m:.2f}' for m in device_ms)} ms after the first (median "
          f"{statistics.median(device_ms):.2f}); the loop "
          f"{', '.join(f'{g:.2f}' for g in gaps)} ms per step (gaps between step starts); "
          f"peak device memory {run['peak'] / 2**30:.2f} GiB. Against plain attention: losses "
          f"{[r['loss'] for r in plain['rows']]}, largest difference {diff:.3e} (<= "
          f"{SUP_LOSS_MAX_DIFF}); final weights {gap[0]:.6e} apart, moved {gap[1]:.6e} = "
          f"{gap[2]:.3e} of the move (<= {SUP_PARAM_MAX_REL}); on {smi}")
    if not (diff <= SUP_LOSS_MAX_DIFF and gap[2] <= SUP_PARAM_MAX_REL):
        raise RuntimeError("[train_survival] the kernel and plain-attention runs disagree")
    STEP_MS["train_survival_stream"] = statistics.median(device_ms)
    del run["state"], plain["state"]

    binary = survival_run(SURV_RUNS / "binary", SURV_ARGV + [
        "--epochs", "1", "--max-steps-per-epoch", str(SURV_STEPS), "-tar", "Survival_Binary"])
    evals = check_survival_run("binary", binary, 1, SURV_STEPS, "auc")
    unknown = 0
    for i, r in enumerate(binary["rows"]):
        labels, logits = r["labels"], r["out"].astype(np.float64)
        mask = labels >= 0
        logits = logits - logits.max(-1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        loss = -logp[np.arange(len(labels)), np.maximum(labels, 0)][mask].sum() / max(mask.sum(), 1)
        probs = np.exp(logp[:, 1])
        auc = roc_auc(probs[mask], labels[mask])
        unknown += int((~mask).sum())
        print(f"[train_survival] binary step {i}: {int((~mask).sum())} of {len(labels)} tiles "
              f"of unknown status; the step's loss {r['loss']:.6f} against the host's masked "
              f"CE {loss:.6f} from its logits, AUC {r['metrics']['auc']:.6f} against "
              f"{auc:.6f}")
        if abs(r["loss"] - loss) > SURV_BINARY_LOSS_REL * abs(loss) \
                or abs(r["metrics"]["auc"] - auc) > 1e-6:
            raise RuntimeError("[train_survival] binary: the masked loss or AUC is off")
    if unknown == 0:
        raise RuntimeError("[train_survival] binary: no tile of unknown status in the batches")
    print(f"[train_survival] binary: main() {binary['wall']:.2f} s; on {smi}")
    total = {k: total[k] + sum(r["launches"][k] for r in binary["rows"]) + evals[k]
             for k in total}
    del binary["state"]
    shutil.rmtree(SURV_RUNS, ignore_errors=True)
    torch.cuda.empty_cache()
    return {k: total[k] + plain["total"][k] for k in total}


def summed_launches(rows) -> dict:
    return {name: sum(r["launches"][name] for r in rows) for name in all_launches()}


def phase_train_route(tag: str, flag: str, per_step: dict, smi: str) -> dict:
    """The DINO step with ViTConfig flag ``flag`` on, full width and depth,
    for 2 + 6 steps, against the default route from the same seeds: launches
    per step (``per_step`` beside the tuned step's attention kernels, every
    other kernel 0), the first two losses, and the time and peak memory of
    both in the order route, default, default, route. → launches per kernel
    over the route's first run."""
    batch = train_batch()
    none = dict.fromkeys(all_launches(), 0)

    def timed_run(overrides):
        bundle = train_bundle(overrides)
        torch.cuda.reset_peak_memory_stats()
        rows = run_steps(bundle, batch, WARMUP_STEPS + TIMED_STEPS)
        return bundle, rows, torch.cuda.max_memory_allocated()

    def median_ms(rows):
        return statistics.median(r["ms"] for r in rows[-TIMED_STEPS:])

    bundle, rows, peak = timed_run({flag: True})
    depth = bundle.model.backbone.config.depth
    views = TRAIN_BATCH * (bundle.dcfg.n_global + bundle.dcfg.n_local)
    attn = {"mha_qkv_fwd": depth, "mha_qkv_fwd_saved": 2 * depth, "mha_qkv_bwd_saved": 2 * depth}
    want = {**none, **attn, **{name: n(depth) for name, n in per_step.items()}}
    for i, r in enumerate(rows):
        print(f"[{tag}] step {i}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.4f} "
              f"{r['ms']:.2f} ms launches {r['launches']}")
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise RuntimeError(f"{flag} step {i}: loss or gradient norm is not finite")
        if r["launches"] != want:
            raise RuntimeError(f"{flag} step {i}: launches {r['launches']}, expected {want}")
    del bundle  # the peak of the default route is taken with this one gone
    torch.cuda.empty_cache()
    default, d_rows, d_peak = timed_run(None)
    if any(r["launches"] != {**none, **attn} for r in d_rows):
        raise RuntimeError("the default route launched a kernel of another route")
    check_losses(flag, rows, d_rows[:2], other="default route")
    # once more in the other order: route, default, default, route
    d_rows_2 = run_steps(default, batch, TIMED_STEPS)
    del default
    torch.cuda.empty_cache()
    rows_2 = timed_run({flag: True})[1]
    ms = min(median_ms(rows), median_ms(rows_2))
    print(f"[{tag}] medians of {TIMED_STEPS} steps after {WARMUP_STEPS} warm-up, in the "
          f"order {flag}, default, default, {flag}: {flag} {median_ms(rows):.2f} / "
          f"{median_ms(rows_2):.2f} ms per step = {views / median_ms(rows) * 1e3:.1f} / "
          f"{views / median_ms(rows_2) * 1e3:.1f} views/s, peak device memory "
          f"{peak / 2**30:.2f} GiB; default route {median_ms(d_rows):.2f} / "
          f"{median_ms(d_rows_2):.2f} ms per step = {views / median_ms(d_rows) * 1e3:.1f} / "
          f"{views / median_ms(d_rows_2) * 1e3:.1f} views/s, peak {d_peak / 2**30:.2f} GiB; "
          f"on {smi}")
    PROFILES.append((f"the step with {flag}", {flag: True}, TRAIN_ARGV, ms))
    return summed_launches(rows)


def phase_train_fused_mlp(smi: str) -> tuple[dict, dict]:
    """The DINO step with the fused-MLP route against the default route; then
    the hybrid route (``mlp_pallas_bwd``) at depth 4. → launches per kernel
    of the two paths.

    With ``use_fused_mlp`` the teacher's 12 blocks and the student's block 0
    (stochastic-depth rate 0) run the sub-block op, the student's blocks 1-11
    the MLP op; the student makes two passes (global and local views)."""
    fused = phase_train_route("train_fused_mlp", "use_fused_mlp", {
        "mlp_block_fwd": lambda depth: depth + 2, "mlp_block_bwd": lambda depth: 2,
        "mlp_fwd": lambda depth: 2 * (depth - 1), "mlp_bwd": lambda depth: 2 * (depth - 1)}, smi)
    batch = train_batch()
    none = dict.fromkeys(all_launches(), 0)

    # -- the hybrid route at depth 4: ordinary forward, kernel backward --
    over = {"mlp_pallas_bwd": True, "depth": 4}
    hybrid = train_bundle(over)
    h_rows = run_steps(hybrid, batch, 2)
    del hybrid
    torch.cuda.empty_cache()
    want_h = {**none, "mha_qkv_fwd": 4, "mha_qkv_fwd_saved": 8, "mha_qkv_bwd_saved": 8,
              "mlp_bwd": 2 * 4}
    for i, r in enumerate(h_rows):
        print(f"[train_fused_mlp] depth 4, mlp_pallas_bwd, step {i}: loss {r['loss']:.6f} "
              f"{r['ms']:.2f} ms launches {r['launches']}")
        if r["launches"] != want_h:
            raise RuntimeError(f"hybrid step {i}: launches {r['launches']}, expected {want_h}")
    h_default = train_bundle({"depth": 4})
    check_losses("depth 4, mlp_pallas_bwd", h_rows, run_steps(h_default, batch, 2),
                 other="default route")
    del h_default
    torch.cuda.empty_cache()
    return fused, summed_launches(h_rows)


def phase_train_dense(smi: str) -> dict:
    """The DINO step with the hybrid dense layers against the default route:
    the qkv and proj layers of the student's 12 blocks take the fused backward
    in both of its passes (global and local views), 48 launches per step; the
    teacher runs no backward and the forward is a library GEMM in both routes."""
    return phase_train_route("train_dense", "dense_pallas_bwd",
                             {"dense_bwd": lambda depth: 4 * depth}, smi)


def phase_ln_gemm_path(smi: str) -> dict:
    """The attention sub-block three ways, with block 0's weights of the
    seeded full-width model in the tuned configuration: as ONE op
    (``fused_attention_block``: K8), composed from the row-tiled ops
    (``fused_gemm_residual(x, mha_from_qkv(fused_ln_gemm(x, ...)), ...)``: K9
    around the attention kernels), and the same block's ``x + attn(norm1(x))``
    from the model's own modules, which the other two are held against:
    forward and backward at the step's global and local views, forward at one
    serving chunk and at a batch of 8 tiles. → launches per kernel."""
    base = create_model(MODEL, num_classes=2, img_size=TILE).config
    cfg = dataclasses.replace(base, **tuned_vit_kwargs(True))
    model = VisionTransformer(cfg)
    model.load_state_dict(params_from_flax(flax_vit_tree(cfg, SEED)))
    blk = model.cuda().blocks[0]
    norm1, attn = blk.norm1, blk.attn
    params = [norm1.weight, norm1.bias, attn.qkv.weight, attn.qkv.bias, attn.proj.weight,
              attn.proj.bias]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype)

    def one_op(x, training):
        return attention_half_as_one_op(blk, x)

    def composed(x, training):
        qkv = mlp.fused_ln_gemm(x, norm1.weight, norm1.bias, attn.qkv.weight.t(), attn.qkv.bias,
                                eps=norm1.eps)
        out = attention.mha_from_qkv(qkv, attn.num_heads, training=training,
                                     save_probs=cfg.attn_save_probs)
        return mlp.fused_gemm_residual(x, out, attn.proj.weight.t(), attn.proj.bias)

    def unfused(x, training):
        return unfused_attention_half(blk, x, training)

    zero = dict.fromkeys(all_launches(), 0)
    total = dict(zero)
    arms = {  # arm → (function, launches forward and backward, launches forward in eval)
        "one op (K8)": (one_op, {"attn_block_fwd": 1, "attn_block_bwd": 1},
                        {"attn_block_fwd": 1}),
        "composed (K9)": (composed, {"ln_gemm_fwd": 1, "gemm_res_fwd": 1, "ln_gemm_bwd": 1,
                                     "gemm_res_bwd": 1, "mha_qkv_fwd_saved": 1,
                                     "mha_qkv_bwd_saved": 1},
                          {"ln_gemm_fwd": 1, "gemm_res_fwd": 1, "mha_qkv_fwd": 1}),
    }
    order = "one op, composed, unfused, unfused, composed, one op"

    def counted(tag, fn, want):
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = all_launches()
        print(f"[ln_gemm_path] {tag}: launches {launches}")
        if launches != {**zero, **want}:
            raise RuntimeError(f"{tag}: launches {launches}, expected {want} and no other")
        for name, count in launches.items():
            total[name] += count
        return out

    def timed(fn_of):
        k1, c1, u1 = (cuda_median_ms(fn_of(f), reps=10) for f in (one_op, composed, unfused))
        u2, c2, k2 = (cuda_median_ms(fn_of(f), reps=10) for f in (unfused, composed, one_op))
        return (f"one op {k1:.4f} / {k2:.4f} ms, composed {c1:.4f} / {c2:.4f} ms, the model's "
                f"norm1 + attention + residual sum {u1:.4f} / {u2:.4f} ms")

    # -- forward and backward at the student's global and local views --
    labels = ("y", "dx", "dgamma", "dbeta", "dW_qkv", "db_qkv", "dW_proj", "db_proj")
    for b, n, d in (TRAIN_SHAPES[0][:3], TRAIN_SHAPES[1][:3]):
        x, dy = randn((b, n, d)).requires_grad_(), randn((b, n, d))

        def both_ways(fn):
            return lambda: torch.autograd.grad(fn(x, True), [x, *params], dy)

        y_ref = unfused(x, True)
        ref = (y_ref, *torch.autograd.grad(y_ref, [x, *params], dy))
        for arm, (fn, want, _) in arms.items():
            def run(fn=fn):
                y = fn(x, True)
                return (y, *torch.autograd.grad(y, [x, *params], dy))

            got = counted(f"{arm} ({b}, {n}, {d}) forward and backward", run, want)
            for label, a, r in zip(labels, got, ref):
                mx = (a.float() - r.float()).abs().max().item()
                ok = bool(torch.isfinite(a.float()).all()) and a.shape == r.shape
                if a.dtype == torch.bfloat16:
                    bound, shown, unit = MLP_MAX_ABS, mx, "max_abs"
                else:  # dgamma, dbeta are fp32 sums; the others were rounded to bf16 on all routes
                    bound = MLP_GRAD_REL if label in ("dgamma", "dbeta") else ROUNDED_GRAD_REL
                    shown, unit = mx / max(r.abs().max().item(), 1e-30), "of the largest element"
                print(f"[ln_gemm_path] {arm} ({b}, {n}, {d}) {label} {tuple(a.shape)} {a.dtype}: "
                      f"vs the model's own modules {shown:.3e} {unit} (bound {bound})")
                if not ok or shown > bound:
                    raise RuntimeError(f"{arm} and the model's modules disagree in {label}")
            del got
        print(f"[ln_gemm_path] ({b}, {n}, {d}) forward and backward, medians of 10 in the order "
              f"{order}: {timed(both_ways)}; on {smi}")
        del x, dy, y_ref, ref

    # -- forward at one serving chunk and at a batch of 8 tiles --
    for b, n, d in (K2_SHAPES[0][:3], (SMALL_BATCH, *K2_SHAPES[0][1:3])):
        x = randn((b, n, d))
        with torch.no_grad():
            y_ref = unfused(x, False)
            for arm, (fn, _, want) in arms.items():
                y = counted(f"{arm} ({b}, {n}, {d}) forward", lambda fn=fn: fn(x, False), want)
                mx = (y.float() - y_ref.float()).abs().max().item()
                print(f"[ln_gemm_path] {arm} ({b}, {n}, {d}) forward: vs the model's own modules "
                      f"max_abs {mx:.3e} (bound {MLP_MAX_ABS})")
                if not mx <= MLP_MAX_ABS:
                    raise RuntimeError(f"{arm} and the model's modules disagree in eval")
            line = timed(lambda fn: (lambda: fn(x, False)))
        print(f"[ln_gemm_path] ({b}, {n}, {d}) forward, medians of 10 in the order {order}: "
              f"{line}; on {smi}")
        del x, y_ref, y
    return total


def walk_with_attn_block(model, images):
    """``forward_features`` (tpuwsi_torch/models/vit.py) with every block's
    attention half as one ``fused_attention_block`` call; patch embedding, MLP
    half, final norm are the model's own modules. Eval only."""
    cfg = model.config
    x, (gh, gw) = model.patch_embed(images)
    cls = model.cls_token.expand(x.shape[0], -1, -1).to(cfg.dtype)
    x = torch.cat([cls, x], dim=1)
    x = x + interpolate_pos_encoding(model.pos_embed, gh * gw, gh, gw).to(cfg.dtype)
    for blk in model.blocks:
        x = attention_half_as_one_op(blk, x)
        x = x + blk.mlp(blk.norm2(x).to(cfg.dtype))
    return model.norm(x)[:, 0].float()


def phase_attn_block_serving(smi: str) -> dict:
    """Small-batch serving through a full-depth ViT-S/16 at 256 px (257
    tokens, tuned configuration, seeded weights) whose every block takes its
    attention half as one ``fused_attention_block`` launch: batches of 8
    tiles, the use the reference keeps the op for, and one 500-tile chunk;
    then a full-depth ViT-B/16 at 256 px the same way at batch 8. Each held
    against ``model.forward_features`` on the same tiles and timed beside it.
    → launches per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    zero = dict.fromkeys(all_launches(), 0)
    total = dict(zero)
    for name, runs in ((MODEL, ((SMALL_BATCH, 3, 20), (TILES_PER_ITER, 1, 5))),
                       (ATTN_BLOCK_MODELS[768], ((SMALL_BATCH, 2, 20),))):
        base = create_model(name, num_classes=2, img_size=TILE).config
        cfg = dataclasses.replace(base, **tuned_vit_kwargs(True))
        model = VisionTransformer(cfg)
        model.load_state_dict(params_from_flax(flax_vit_tree(cfg, SEED)))
        model = model.cuda().eval()
        print(f"[attn_block_serving] {name} img {TILE} ({cfg.num_patches + 1} tokens) depth "
              f"{cfg.depth} dim {cfg.embed_dim} heads {cfg.num_heads} {cfg.dtype}; normalised "
              "tiles ~ N(0, 1)")
        with torch.inference_mode():
            for batch, n_batches, reps in runs:
                tiles = [torch.randn((batch, TILE, TILE, 3), generator=gen, device="cuda")
                         for _ in range(n_batches)]
                for i, images in enumerate(tiles):
                    reset_launches()
                    feats = walk_with_attn_block(model, images)
                    torch.cuda.synchronize()
                    launches = all_launches()
                    if launches != {**zero, "attn_block_fwd": cfg.depth}:
                        raise RuntimeError(f"the walk's forward: launches {launches}, expected "
                                           f"attn_block_fwd = {cfg.depth} and no other kernel")
                    for kname, count in launches.items():
                        total[kname] += count
                    want = model.forward_features(images)
                    cos = torch.nn.functional.cosine_similarity(feats, want, dim=1).min().item()
                    ok = feats.shape == (batch, cfg.embed_dim) and bool(torch.isfinite(feats).all())
                    print(f"[attn_block_serving] {name} batch {batch}, forward {i}: launches "
                          f"attn_block_fwd = {launches['attn_block_fwd']}, no other kernel; min "
                          f"per-tile feature cosine against forward_features {cos:.6f} "
                          f"(>= {FEAT_COSINE_MIN})")
                    if not ok or not cos >= FEAT_COSINE_MIN:
                        raise RuntimeError("the walk and forward_features disagree")
                images = tiles[0]
                k1 = cuda_median_ms(lambda: walk_with_attn_block(model, images), reps=reps)
                m1 = cuda_median_ms(lambda: model.forward_features(images), reps=reps)
                m2 = cuda_median_ms(lambda: model.forward_features(images), reps=reps)
                k2 = cuda_median_ms(lambda: walk_with_attn_block(model, images), reps=reps)

                def rate(ms):
                    return batch / ms * 1e3

                print(f"[attn_block_serving] {name} batch {batch}, forward alone (normalised "
                      f"tiles on the card to features), medians of {reps} in the order walk, "
                      f"model, model, walk: walk with the one-op attention half {k1:.4f} / "
                      f"{k2:.4f} ms = {rate(k1):.1f} / {rate(k2):.1f} tiles/s; "
                      f"model.forward_features {m1:.4f} / {m2:.4f} ms = {rate(m1):.1f} / "
                      f"{rate(m2):.1f} tiles/s; on {smi}")
                del tiles, images
        del model
        torch.cuda.empty_cache()
    return total


def phase_train_448(smi: str) -> dict:
    """The same DINO step with 448-px global views: 192 sequences of 785
    tokens through the flash family (the teacher without statistics, the
    student with, then dQ and dK/dV), 576 local sequences of 37 tokens
    through the saving pair as before; → launches per kernel."""
    batch = train_batch()
    bundle = train_bundle(argv=TRAIN_ARGV_448)
    cfg = bundle.model.backbone.config
    depth = cfg.depth
    views = TRAIN_BATCH * (bundle.dcfg.n_global + bundle.dcfg.n_local)
    print(f"[train448] {TRAIN_ARGV_448[2]} img {cfg.img_size} ({cfg.num_patches + 1} tokens a "
          f"global view) depth {depth} dim {cfg.embed_dim} head {bundle.dcfg.out_dim} "
          f"{cfg.dtype}; batch {TRAIN_BATCH} tiles of {TILE} px = {views} views per step")
    torch.cuda.reset_peak_memory_stats()
    rows = run_steps(bundle, batch, WARMUP_STEPS + TIMED_STEPS_448)
    peak = torch.cuda.max_memory_allocated()
    total = dict.fromkeys(all_launches(), 0)
    want = {**total, "mha_qkv_fwd_saved": depth, "mha_qkv_bwd_saved": depth, "flash_fwd": depth,
            "flash_fwd_stats": depth, "flash_bwd_dq": depth, "flash_bwd_dkv": depth}
    for i, r in enumerate(rows):
        print(f"[train448] step {i}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.4f} "
              f"{r['ms']:.2f} ms launches {r['launches']}")
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise RuntimeError(f"448 px step {i}: loss or gradient norm is not finite")
        if r["launches"] != want:
            raise RuntimeError(f"448 px step {i}: launches {r['launches']}, expected {want}")
        for name, n in r["launches"].items():
            total[name] += n
    if len({r["loss"] for r in rows}) < 2:
        raise RuntimeError("the loss is constant")
    ms = statistics.median(r["ms"] for r in rows[WARMUP_STEPS:])
    print(f"[train448] median of {TIMED_STEPS_448} steps after {WARMUP_STEPS} warm-up "
          f"{ms:.2f} ms per step = {views / ms * 1e3:.1f} views/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; on {smi}")
    crop_ms = cuda_median_ms(lambda: bundle.multicrop(bundle.generator, batch["images"]),
                             reps=5, warmup=1)
    print(f"[train448] multi-crop alone: {crop_ms:.2f} ms; on {smi}")
    PROFILES.append(("the step with 448-px globals", None, TRAIN_ARGV_448, ms))
    del bundle
    torch.cuda.empty_cache()

    plain = train_bundle({"use_kernel_attention": False}, argv=TRAIN_ARGV_448)
    torch.cuda.reset_peak_memory_stats()
    plain_rows = run_steps(plain, batch, 2)
    if any(sum(r["launches"].values()) for r in plain_rows):
        raise RuntimeError("the plain-attention path launched a kernel")
    check_losses("448 px", rows, plain_rows)
    ms_plain = plain_rows[1]["ms"]
    print(f"[train448] plain attention: step 1 took {ms_plain:.2f} ms = "
          f"{views / ms_plain * 1e3:.1f} views/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {smi}")
    del plain
    torch.cuda.empty_cache()
    return total


PHASE_S = {}  # wall seconds of each phase, in order


def timed(phase: str, fn, *a, **kw):
    """``fn(*a, **kw)``, its wall time kept under ``phase`` in PHASE_S."""
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    PHASE_S[phase] = time.perf_counter() - t0
    return out


def main() -> None:
    t0 = time.perf_counter()
    torch.manual_seed(SEED)
    shutil.rmtree(OUT, ignore_errors=True)
    smi = phase_device()
    timed("build", phase_build)
    kernels = {"mha_qkv_fwd": timed("k2", phase_k2, smi),
               **timed("train_kernels", phase_train_kernels, smi),
               **timed("flash_kernels", phase_flash_kernels, smi),
               **timed("mlp_kernels", phase_mlp_kernels, smi),
               **timed("dense_kernels", phase_dense_kernels, smi),
               **timed("attn_block_kernels", phase_attn_block_kernels, smi)}
    paths = {"serving": timed("slice", phase_slice, smi),
             "training": timed("train", phase_train, smi)}
    paths["train_ssl"] = timed("train_ssl", phase_train_ssl, smi)
    timed("wsi_cohort", phase_wsi_cohort, smi)
    paths["wsi_ef"] = timed("wsi_ef", phase_wsi_ef, smi)
    paths["wsi_formats"] = timed("wsi_formats", phase_wsi_formats, smi)
    paths["mil"] = timed("mil", phase_mil, smi)
    paths["wsi_ssl"] = timed("wsi_ssl", phase_wsi_ssl, smi)
    paths["train_sup"] = timed("train_sup", phase_train_sup, smi)
    paths["train_survival"] = timed("train_survival", phase_train_survival, smi)
    paths["serving_fused_mlp"] = timed(
        "slice_fused_mlp", phase_slice, smi, kernels=("mha_qkv_fwd", "mlp_block_fwd"),
        tag="slice_fused_mlp", model_kw={"use_fused_mlp": True}, other_kw={},
        other="default route")
    paths["training_fused_mlp"], paths["training_mlp_pallas_bwd"] = timed(
        "train_fused_mlp", phase_train_fused_mlp, smi)
    paths["training_dense"] = timed("train_dense", phase_train_dense, smi)
    paths["ln_gemm_path"] = timed("ln_gemm_path", phase_ln_gemm_path, smi)
    paths["serving_attn_block"] = timed("attn_block_serving", phase_attn_block_serving, smi)
    paths["serving_448"] = timed("slice448", phase_slice, smi, MODEL_448, TILE_448,
                                 TILES_PER_ITER_448, VALID_448, kernels=("flash_fwd",),
                                 tag="slice448")
    paths["training_448"] = timed("train448", phase_train_448, smi)
    timed("profiles", phase_profiles, smi)
    print(f"[time] wall seconds by phase: {json.dumps({k: round(v, 1) for k, v in PHASE_S.items()})}"
          f"; {time.perf_counter() - t0:.1f} s in all")
    meta = {
        "mha_qkv_fwd": ("mha_qkv_fwd.cu", "tpuwsi/ops/attention.py:633"),
        "mha_qkv_fwd_saved": ("mha_qkv_fwd.cu", "tpuwsi/ops/attention.py:852"),
        "mha_qkv_bwd_saved": ("mha_qkv_bwd.cu", "tpuwsi/ops/attention.py:935"),
        "mha_qkv_bwd": ("mha_qkv_bwd.cu", "tpuwsi/ops/attention.py:732"),
        "flash_fwd": ("flash_fwd.cu", "tpuwsi/ops/attention.py:80"),
        "flash_fwd_stats": ("flash_fwd.cu", "tpuwsi/ops/attention.py:148"),
        "flash_bwd_dq": ("flash_bwd.cu", "tpuwsi/ops/attention.py:261"),
        "flash_bwd_dkv": ("flash_bwd.cu", "tpuwsi/ops/attention.py:303"),
        "mlp_fwd": ("mlp_sm90.cu", "tpuwsi/ops/mlp.py:83"),
        "mlp_bwd": ("mlp_sm90.cu", "tpuwsi/ops/mlp.py:100"),
        "mlp_block_fwd": ("mlp_sm90.cu", "tpuwsi/ops/mlp.py:485"),
        "mlp_block_bwd": ("mlp_sm90.cu", "tpuwsi/ops/mlp.py:508"),
        "dense_bwd": ("dense_sm90.cu", "tpuwsi/ops/dense.py:51"),
        "ln_gemm_fwd": ("ln_gemm_sm90.cu", "tpuwsi/ops/mlp.py:832"),
        "ln_gemm_bwd": ("ln_gemm_sm90.cu", "tpuwsi/ops/mlp.py:850"),
        "gemm_res_fwd": ("dense_sm90.cu", "tpuwsi/ops/mlp.py:1079"),
        "gemm_res_bwd": ("dense_sm90.cu", "tpuwsi/ops/mlp.py:1092"),
        "attn_block_fwd": ("attn_block.cu", "tpuwsi/ops/attention.py:1467"),
        "attn_block_bwd": ("attn_block.cu", "tpuwsi/ops/attention.py:1490"),
    }
    # the fused-MLP kernels at D = 768 (ViT-B) keep the row-tiled sources, as
    # do K7, K9d, K9a and K9b at input width 768 and K9c at output width 768
    at_768 = {"mlp_fwd": "mlp_fwd.cu", "mlp_bwd": "mlp_bwd.cu", "mlp_block_fwd": "mlp_fwd.cu",
              "mlp_block_bwd": "mlp_bwd.cu", "dense_bwd": "dense.cu", "gemm_res_fwd": "dense.cu",
              "gemm_res_bwd": "dense.cu", "ln_gemm_fwd": "dense.cu", "ln_gemm_bwd": "dense.cu"}
    lines = []
    for name, (source, replaces) in meta.items():
        by_path = {path: counts[name] for path, counts in paths.items()}
        if sum(by_path.values()) < 1:
            raise RuntimeError(f"{name} was launched on no main path")
        lines.append({"name": name, "route": "cuda",
                      "source": f"tpuwsi_torch/ops/csrc/{source}", "replaces": replaces,
                      **({"source_d768": f"tpuwsi_torch/ops/csrc/{at_768[name]}"}
                         if name in at_768 else {}),
                      "launches": sum(by_path.values()), "launches_by_path": by_path,
                      **kernels[name]})
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
