#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card's name and power limit (nvidia-smi);
  2. build the Hopper kernels from tpuwsi_torch/ops/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it, plus median times (CUDA events);
  4. the slice: full-width ViT-S/16 at 256 px (seeded random weights in the
     JAX package's layout, through params_from_flax) runs 8 slides x 500
     uint8 tiles through extract_features; the kernel's launch count, the
     outputs and the files are checked, and the same model with plain
     attention must agree.
The line before the last is a JSON summary of the kernels, the last line
{"ok": true, "device": {...}}. Any failure raises: the script then exits
non-zero without that line. Without a CUDA device it fails at once.
Outputs go to build/chip_smoke/.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from tpuwsi_torch.cli.train import extract_features
from tpuwsi_torch.core.device import require_cuda
from tpuwsi_torch.infer.slide_walker import InferChunk
from tpuwsi_torch.models.convert import params_from_flax
from tpuwsi_torch.models.registry import create_model
from tpuwsi_torch.ops import _build, attention

SEED = 0
OUT = Path(__file__).resolve().parent / "build" / "chip_smoke"

# (B, N, D, H, block_len): bf16 qkv ~ N(0, 1)
K2_SHAPES = [
    (500, 257, 384, 6, 0),   # serving: ViT-S/16 at 256 px, -tpi 500
    (64, 197, 384, 6, 0),    # ViT-S/16 at 224 px
    (64, 257, 768, 12, 0),   # ViT-B/16 at 256 px
    (64, 111, 384, 6, 37),   # packed: three 37-token sequences per row
]
# bf16 rounding of q*scale and of p, fp32 accumulation
K2_MAX_ABS, K2_MEAN_ABS = 2e-2, 2e-3

MODEL, TILE, TILES_PER_ITER, N_SLIDES = "vit_small_patch16_224", 256, 500, 8
VALID = [500, 500, 500, 437, 500, 500, 500, 311]  # two slides end in a padded chunk
FEAT_COSINE_MIN, PROBS_MAX_DIFF = 0.999, 1e-2


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
    for line in log.read_text().splitlines() if log.exists() else ():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")


def phase_k2(smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err, timing = 0.0, {}
    for b, n, d, h, block_len in K2_SHAPES:
        qkv = torch.randn((b, n, 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
        out = attention.mha_from_qkv(qkv, h, block_len=block_len)
        ref = attention._mha_reference(qkv, h, (d // h) ** -0.5, block_len)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        mx, mean = diff.max().item(), diff.mean().item()
        finite = bool(torch.isfinite(out.float()).all())
        print(f"[k2] B={b} N={n} D={d} H={h} block_len={block_len}: "
              f"max_abs={mx:.3e} mean_abs={mean:.3e} (bounds {K2_MAX_ABS}, {K2_MEAN_ABS})")
        if not finite or mx > K2_MAX_ABS or mean > K2_MEAN_ABS:
            raise RuntimeError(f"mha_qkv_fwd disagrees with its plain version at {(b, n, d, h)}")
        max_err = max(max_err, mx)
        if not timing:  # the serving shape comes first
            timing["plain_ms"] = cuda_median_ms(
                lambda: attention._mha_reference(qkv, h, (d // h) ** -0.5, block_len))
            timing["ms"] = cuda_median_ms(
                lambda: attention.mha_from_qkv(qkv, h, block_len=block_len))
            timing["plain_ms_2"] = cuda_median_ms(
                lambda: attention._mha_reference(qkv, h, (d // h) ** -0.5, block_len))
            print(f"[k2] serving shape median of 20: kernel {timing['ms']:.4f} ms, "
                  f"plain {timing['plain_ms']:.4f} / {timing['plain_ms_2']:.4f} ms "
                  f"(plain, kernel, plain) on {smi}")
        del qkv, out, ref, diff
    return {"max_abs_err": max_err, "ms": timing["ms"], "plain_ms": timing["plain_ms"]}


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


def make_chunks(seed: int) -> list[InferChunk]:
    rng = np.random.default_rng(seed)
    chunks = []
    for s, k in enumerate(VALID):
        images = rng.integers(0, 256, (TILES_PER_ITER, TILE, TILE, 3), dtype=np.uint8)
        chunks.append(InferChunk(
            images=images, mask=np.arange(TILES_PER_ITER) < k,
            label=np.array([s % 2]), slide_index=s, slide_name=f"slide_{s}.svs",
            patient_barcode=f"patient_{s}", slide_dataset="synthetic",
            initial_num_tiles=k, is_last_batch=True,
            locations=[(TILE * (j // 32), TILE * (j % 32)) for j in range(k)]))
    return chunks


def timed_extract(chunks, model, params, out_dir, dev):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agg = extract_features(chunks, model, params, str(out_dir), dev, dispatch_ahead=4)
    return agg, time.perf_counter() - t0


def phase_slice(smi: str) -> int:
    dev = torch.device("cuda")
    model = create_model(MODEL, num_classes=2, img_size=TILE)
    plain = create_model(MODEL, num_classes=2, img_size=TILE, use_kernel_attention=False)
    cfg = model.config
    params = params_from_flax(flax_vit_tree(cfg, SEED))
    t0 = time.perf_counter()
    chunks = make_chunks(SEED)
    n_valid = sum(VALID)
    print(f"[slice] {MODEL} img {TILE} depth {cfg.depth} dim {cfg.embed_dim} "
          f"{cfg.dtype}; {N_SLIDES} slides x {TILES_PER_ITER} tiles, {n_valid} valid; "
          f"chunks made in {time.perf_counter() - t0:.1f} s")
    for m in (model, plain):  # warm-up: cuBLAS handles, allocator, kernel load
        extract_features(chunks[:1], m, params, str(OUT / "warmup"), dev)
    torch.cuda.reset_peak_memory_stats()

    attention.LAUNCHES = 0
    agg, t_kernel = timed_extract(chunks, model, params, OUT / "kernel", dev)
    launches = attention.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    expected = cfg.depth * len(chunks)
    print(f"[slice] mha_qkv_fwd launches {launches} (expected depth {cfg.depth} x "
          f"{len(chunks)} forwards = {expected})")
    if launches != expected:
        raise RuntimeError("the serving path did not run the attention kernel once per layer")

    feats = np.concatenate([r.features for r in agg.results])
    probs = np.concatenate([r.tile_probs for r in agg.results])
    if feats.shape != (n_valid, cfg.embed_dim) or not np.isfinite(feats).all():
        raise RuntimeError(f"features: shape {feats.shape}, finite {np.isfinite(feats).all()}")
    if not (np.isfinite(probs).all() and probs.min() >= 0.0 and probs.max() <= 1.0):
        raise RuntimeError("tile probabilities outside [0, 1]")
    written = sorted(os.listdir(OUT / "kernel" / "features"))
    want = sorted([f"slide_{s}_features.pt" for s in range(N_SLIDES)] + ["inference.data"])
    if written != want:
        raise RuntimeError(f"feature files: {written}")

    agg_plain, t_plain = timed_extract(chunks, plain, params, OUT / "plain", dev)
    _, t_plain_2 = timed_extract(chunks, plain, params, OUT / "plain", dev)
    _, t_kernel_2 = timed_extract(chunks, model, params, OUT / "kernel_2", dev)
    feats_p = np.concatenate([r.features for r in agg_plain.results])
    probs_p = np.concatenate([r.tile_probs for r in agg_plain.results])
    cos = (feats * feats_p).sum(1) / (
        np.linalg.norm(feats, axis=1) * np.linalg.norm(feats_p, axis=1))
    dprob = float(np.abs(probs - probs_p).max())
    print(f"[slice] kernel vs plain attention: min per-tile feature cosine "
          f"{cos.min():.6f} (>= {FEAT_COSINE_MIN}), max probs diff {dprob:.3e} "
          f"(<= {PROBS_MAX_DIFF}); slide AUC {agg.slide_auc():.4f} / "
          f"{agg_plain.slide_auc():.4f}")
    if cos.min() < FEAT_COSINE_MIN or dprob > PROBS_MAX_DIFF:
        raise RuntimeError("kernel and plain attention paths disagree")
    print(f"[slice] extract_features wall time (normalize + forward + fetch + "
          f"aggregation + files), {n_valid} valid tiles, run order kernel, plain, "
          f"plain, kernel: kernel {t_kernel:.4f} / {t_kernel_2:.4f} s = "
          f"{n_valid / t_kernel:.1f} / {n_valid / t_kernel_2:.1f} tiles/s; plain "
          f"{t_plain:.4f} / {t_plain_2:.4f} s = {n_valid / t_plain:.1f} / "
          f"{n_valid / t_plain_2:.1f} tiles/s; peak device memory (kernel run) "
          f"{peak / 2**30:.2f} GiB; on {smi}")
    return launches


def main() -> None:
    torch.manual_seed(SEED)
    shutil.rmtree(OUT, ignore_errors=True)
    smi = phase_device()
    phase_build()
    k2 = phase_k2(smi)
    launches = phase_slice(smi)
    print(json.dumps({"kernels": [{
        "name": "mha_qkv_fwd", "route": "cuda",
        "source": "tpuwsi_torch/ops/csrc/mha_qkv_fwd.cu",
        "replaces": "tpuwsi/ops/attention.py:633",
        "launches": launches, **k2}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
