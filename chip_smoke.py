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
     at 37-257 tokens and at every branch edge of the forward kernel from 1
     to 511 tokens, the four tiled flash kernels at 512-1,024 tokens,
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
     kind. They come last: once the profiler has run, the process launches
     kernels more slowly.
The line before the last but one is a JSON summary of the kernels, then the
card's name and power limit once more, and the last line
{"ok": true, "device": {...}}. Any failure raises: the script then exits
non-zero without that line. Without a CUDA device it fails at once.
Outputs go to build/chip_smoke/.
"""

from __future__ import annotations

import csv
import dataclasses
import json
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
# the DINO step at 96 tiles: 2 global views of 197 tokens, 6 local of 37
TRAIN_SHAPES = [
    (192, 197, 384, 6, 0),   # student and teacher, global views (timed)
    (576, 37, 384, 6, 0),    # student, local views as the step launches them (timed)
    (192, 111, 384, 6, 37),  # the same sequences packed three to a row
    (32, 197, 768, 12, 0),   # ViT-B/16
    *FWD_EDGES,
]
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
# step times of the bare step, by tag, for the phases that read them beside theirs
STEP_MS = {}


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
            timed.append({"shape": [b, n, d, h], **t})
            print(f"[mha_qkv_fwd] ({b}, {n}, {d}, {h}), medians of 20 in the order kernel, "
                  f"library, library, kernel: kernel {t['ms_runs']} ms, library (SDPA) "
                  f"{t['library_ms_runs']} ms, plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms by {t['bound_by']}; on {smi}")
        del qkv, out, ref
    main = {k: v for k, v in timed[0].items() if k != "shape"}  # the serving shape
    return {"max_abs_err": max_err, **main, "timed": timed}


def phase_train_kernels(smi: str) -> dict:
    """K1a, K1b and K3 against their plain versions at the DINO step's shapes
    and at the backward's branch edges (``BWD_EDGES``); the backward from
    saved probabilities is fed the p that the saving forward produced, and
    each backward launched twice must repeat its bits, at the edges also
    through autograd (which runs it on a thread of its own). Times at the
    student-global shape, K1a, K1b and K3 also at the local views as the step
    launches them (single calls and back to back), and of the local views
    packed."""
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
            if shape in TRAIN_SHAPES[:2]:
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


def png_bytes(img: np.ndarray, first_row_none: bool = False) -> tuple[bytes, np.ndarray]:
    """uint8 RGB (H, W, 3) → (a PNG file's bytes, the filter type of each
    scanline). Each scanline takes the filter (0 None, 1 Sub, 2 Up, 3
    Average, 4 Paeth) whose residuals, read as signed bytes, have the least
    absolute sum: libpng's default choice. ``first_row_none`` leaves the
    first scanline unfiltered."""
    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), cur[:-1]])
    left = np.hstack([np.zeros((h, c), np.int16), cur[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int16), up[:, :-c]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(cur), left, up, (left + up) // 2, paeth])
    residuals = ((cur[None] - preds) & 0xFF).astype(np.uint8)       # (5, h, w * c)
    kinds = np.abs(residuals.view(np.int8).astype(np.int32)).sum(-1).argmin(0)
    if first_row_none:
        kinds[0] = 0
    filtered = residuals[kinds, np.arange(h)]
    raw = np.hstack([kinds[:, None].astype(np.uint8), filtered]).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
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


def ssl_run(tag: str, extra: list) -> dict:
    """``cli.train.main`` over the folder on the card, recording per step its
    launches, entry time and the loop's wait on the Prefetcher so far. →
    state, rows, total launches, peak memory, wall seconds, output dir."""
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

    out = SSL_RUNS / tag
    cli_train.ssl_step_bundle, prefetch.Prefetcher = bundle_with_recording, RecordedPrefetcher
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state = cli_train.main(SSL_ARGV + ["--data-dir", str(SSL_DIR), "--output", str(out)]
                               + extra)
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


def loop_timing(run: dict) -> tuple:
    """→ (ms between the starts of consecutive steps within each epoch, the
    share of them spent waiting on the Prefetcher): SSL_STEPS - 1 gaps an
    epoch, a spot reading here (train_loop_ab.py's ``loop`` takes the median
    over two epochs of 10 steps)."""
    gaps, waits = [], []
    for e in range(SSL_EPOCHS):
        rows = run["rows"][e * SSL_STEPS:(e + 1) * SSL_STEPS]
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
        run = ssl_run(tag, extra)
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


def main() -> None:
    torch.manual_seed(SEED)
    shutil.rmtree(OUT, ignore_errors=True)
    smi = phase_device()
    phase_build()
    kernels = {"mha_qkv_fwd": phase_k2(smi), **phase_train_kernels(smi),
               **phase_flash_kernels(smi), **phase_mlp_kernels(smi),
               **phase_dense_kernels(smi), **phase_attn_block_kernels(smi)}
    paths = {"serving": phase_slice(smi), "training": phase_train(smi)}
    paths["train_ssl"] = phase_train_ssl(smi)
    paths["serving_fused_mlp"] = phase_slice(
        smi, kernels=("mha_qkv_fwd", "mlp_block_fwd"), tag="slice_fused_mlp",
        model_kw={"use_fused_mlp": True}, other_kw={}, other="default route")
    paths["training_fused_mlp"], paths["training_mlp_pallas_bwd"] = phase_train_fused_mlp(smi)
    paths["training_dense"] = phase_train_dense(smi)
    paths["ln_gemm_path"] = phase_ln_gemm_path(smi)
    paths["serving_attn_block"] = phase_attn_block_serving(smi)
    paths["serving_448"] = phase_slice(smi, MODEL_448, TILE_448, TILES_PER_ITER_448, VALID_448,
                                       kernels=("flash_fwd",), tag="slice448")
    paths["training_448"] = phase_train_448(smi)
    phase_profiles(smi)
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
