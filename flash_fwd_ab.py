#!/usr/bin/env python3
"""A/B of the tiled attention forward (K4a, K4a') against another kernel tree, on one card.

    python3 flash_fwd_ab.py [check] [ab] [e2e] [ablate 'NAME:FIND=>REPLACE;...' ...]
        [--old DIR]

``DIR`` (default ``build/ab/csrc_v1``) holds another copy of
``tpuwsi_torch/ops/csrc`` (for instance the parent commit's, unpacked with
``git archive``); both trees are built into their own libraries, keyed by
their sources' hash, and the script switches between them in one process.
Modes, in the order given:

- ``check``: build this tree, print ptxas' lines for the flash forward, and
  run ``chip_smoke.phase_flash_kernels`` (every flash case and its timing);
- ``ab``: K4a and K4a' at the 448-px step's shape (192, 6, 785) and a 448-px
  serving chunk's (128, 6, 785), q, k, v as strided views of a fused qkv, in
  the order new, old, old, new: medians of 20 single calls and medians of 5
  runs of 50 launches back to back (CUDA events), SDPA on the same inputs,
  the bound from ``chip_smoke.flash_bound``;
- ``e2e``: the DINO step with ``--dino-global-size 448`` (one bundle, 2
  warm-up steps, then 1 + 6 steps a library, medians of the 6) and serving at
  448 px (``extract_features`` over 8 chunks of 128 tiles), each in the order
  new, old, old, new, with the launch counts checked;
- ``ablate``: variants of this tree's flash_fwd.cu, each a copy under
  ``build/ab/var_NAME/`` with the given text replacements (for instance
  ``'st10:kStages = 8=>kStages = 10'``), checked against the plain forward and
  timed beside the tree's own kernel at the step's shape in the order
  base, v1 .. vn, vn .. v1, base.

Every line names the card's name and power limit; the last line is a JSON
summary.
"""

from __future__ import annotations

import json
import shutil
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from tpuwsi_torch.cli.train import extract_features
from tpuwsi_torch.models.convert import params_from_flax
from tpuwsi_torch.models.registry import create_model
from tpuwsi_torch.ops import _build, attention

ROOT = Path(__file__).resolve().parent
NEW = _build.CSRC
AB_SHAPES = [(192, 6, 785), (128, 6, 785)]
SERVE_CHUNKS, STEP_TIMED = 8, 6


def use(csrc: Path) -> Path:
    """Make the kernels of ``csrc`` the ones every wrapper launches: the
    builder reads its tree from ``_build.CSRC`` and keys each library by the
    tree's hash, so the libraries of both trees sit side by side."""
    _build.CSRC = Path(csrc)
    _build._lib = None
    _build.load()
    return _build.library_path()


def ptxas_lines(lib: Path, needle: str) -> list[str]:
    """ptxas' report for the kernels whose mangled names hold ``needle``."""
    out, keep = [], False
    log = lib.with_suffix(".log")
    for line in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = needle in line
        if keep or "Performance Loss" in line:
            out.append(line.strip())
    return out


def back_to_back_ms(fn, launches: int = 50, runs: int = 5) -> float:
    """Median over ``runs`` of the time of ``launches`` calls between two events, per call."""
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


def mode_check(smi: str) -> dict:
    lib = use(NEW)
    for line in ptxas_lines(lib, "flash_fwd"):
        print(f"[check] ptxas: {line}")
    return cs.phase_flash_kernels(smi)


def mode_ab(smi: str, old: Path) -> dict:
    arms = [("new", NEW), ("old", old), ("old", old), ("new", NEW)]
    for _, csrc in arms[:2]:
        use(csrc)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 8)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for b, h, s in AB_SHAPES:
        q, k, v, _, o_view, _ = cs.flash_operands(gen, b, h, s, True)
        for stats in (False, True):
            name = "flash_fwd_stats" if stats else "flash_fwd"
            fn = lambda: attention._launch_flash_fwd(q, k, v, None, 0.125, stats, o_view)  # noqa: E731
            row = {"single_ms": [], "b2b_ms": [], "arms": [a for a, _ in arms]}
            ref = None
            for arm, csrc in arms:
                use(csrc)
                o = fn()[0].clone()
                if ref is None:
                    ref = o
                elif arm == "new" and not torch.equal(o, ref):
                    raise RuntimeError(f"{name}: the new kernel's o changed between arms")
                row["single_ms"].append(cs.cuda_median_ms(fn))
                row["b2b_ms"].append(back_to_back_ms(fn))
            lib = [cs.cuda_median_ms(lambda: sdpa(q, k, v)) for _ in range(2)]
            lib_b2b = back_to_back_ms(lambda: sdpa(q, k, v))
            bound = cs.flash_bound(name, b, h, s, s)
            row.update(sdpa_ms=lib, sdpa_b2b_ms=lib_b2b, bound_ms=bound["bound_ms"],
                       bound_by=bound["bound_by"])
            out[f"{name} {b}x{h}x{s}"] = row
            print(f"[ab] {name} B={b} H={h} S={s} strided qkv views, order "
                  f"{row['arms']}: single calls (medians of 20) {row['single_ms']} ms; 50 back "
                  f"to back (medians of 5, per launch) {row['b2b_ms']} ms; SDPA {lib} / "
                  f"{lib_b2b:.4f} back to back; bound {bound['bound_ms']:.4f} ms by "
                  f"{bound['bound_by']}; on {smi}")
        del q, k, v, o_view
        torch.cuda.empty_cache()
    use(NEW)
    return out


def variant_tree(name: str, edits: list[str]) -> Path:
    """A copy of this tree under build/ab/ whose flash_fwd.cu has each
    ``FIND=>REPLACE`` of ``edits`` applied (each FIND must occur)."""
    dst = ROOT / "build" / "ab" / f"var_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(NEW, dst)
    src = dst / "flash_fwd.cu"
    text = src.read_text()
    for edit in edits:
        find, _, repl = edit.partition("=>")
        if find not in text:
            raise SystemExit(f"ablate {name}: {find!r} is not in flash_fwd.cu")
        text = text.replace(find, repl)
    src.write_text(text)
    return dst


def mode_ablate(smi: str, specs: list[str]) -> dict:
    """``NAME:FIND=>REPLACE;...`` variants of flash_fwd.cu, then K4a and K4a'
    at the step's shape in the order base, v1 .. vn, vn .. v1, base."""
    trees = {"base": NEW}
    for spec in specs:
        name, _, edits = spec.partition(":")
        trees[name] = variant_tree(name, [e for e in edits.split(";") if e])
    for name, tree in trees.items():
        t0 = time.perf_counter()
        lib = use(tree)
        print(f"[ablate] {name}: built in {time.perf_counter() - t0:.1f} s")
        for line in ptxas_lines(lib, "flash_fwd"):
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"[ablate] {name} ptxas: {line}")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    b, h, s = AB_SHAPES[0]
    q, k, v, _, o_view, _ = cs.flash_operands(gen, b, h, s, True)
    want = attention._flash_reference(q, k, v, None, 0.125)
    order = [*trees, *reversed(trees)]
    res = {name: {"flash_fwd": [], "flash_fwd_stats": []} for name in trees}
    for name in order:
        use(trees[name])
        for stats in (False, True):
            kname = "flash_fwd_stats" if stats else "flash_fwd"
            fn = lambda: attention._launch_flash_fwd(q, k, v, None, 0.125, stats, o_view)  # noqa: E731
            o, lse = fn()
            torch.cuda.synchronize()
            cs.check_flash(f"{kname} {name}", f"B={b} H={h} S={s}", o, want[0])
            res[name][kname].append((cs.cuda_median_ms(fn), back_to_back_ms(fn)))
    for name, r in res.items():
        print(f"[ablate] {name}: (single, back to back) ms, order {order}: flash_fwd "
              f"{r['flash_fwd']}, flash_fwd_stats {r['flash_fwd_stats']}; B={b} H={h} S={s} "
              f"strided; on {smi}")
    use(NEW)
    return res


def mode_e2e(smi: str, old: Path) -> dict:
    arms = [("new", NEW), ("old", old), ("old", old), ("new", NEW)]
    res = {"arms": [a for a, _ in arms]}
    use(NEW)
    batch = cs.train_batch()
    bundle = cs.train_bundle(argv=cs.TRAIN_ARGV_448)
    depth = bundle.model.backbone.config.depth
    views = cs.TRAIN_BATCH * (bundle.dcfg.n_global + bundle.dcfg.n_local)
    cs.run_steps(bundle, batch, cs.WARMUP_STEPS)
    res["step_ms"] = []
    for arm, csrc in arms:
        use(csrc)
        rows = cs.run_steps(bundle, batch, 1 + STEP_TIMED)
        for r in rows:
            if r["launches"]["flash_fwd"] != depth or r["launches"]["flash_fwd_stats"] != depth:
                raise RuntimeError(f"448-px step ({arm}): launches {r['launches']}")
            if not np.isfinite(r["loss"]):
                raise RuntimeError(f"448-px step ({arm}): the loss is not finite")
        res["step_ms"].append(statistics.median(r["ms"] for r in rows[1:]))
    print(f"[e2e] the DINO step with 448-px globals, order {res['arms']}, medians of "
          f"{STEP_TIMED} steps: {res['step_ms']} ms per step = "
          f"{[round(views / ms * 1e3, 1) for ms in res['step_ms']]} views/s; on {smi}")
    del bundle
    torch.cuda.empty_cache()

    dev = torch.device("cuda")
    model = create_model(cs.MODEL_448, num_classes=2, img_size=cs.TILE_448)
    params = params_from_flax(cs.flax_vit_tree(model.config, cs.SEED))
    valid = [cs.TILES_PER_ITER_448] * SERVE_CHUNKS
    chunks = cs.make_chunks(cs.SEED, valid, cs.TILES_PER_ITER_448, cs.TILE_448)
    out_dir = cs.OUT / "ab448"
    extract_features(chunks[:1], model, params, str(out_dir / "warmup"), dev)
    res["serve_tiles_per_s"] = []
    for i, (arm, csrc) in enumerate(arms):
        use(csrc)
        extract_features(chunks[:1], model, params, str(out_dir / "warmup"), dev)
        cs.reset_launches()
        _, secs = cs.timed_extract(chunks, model, params, out_dir / f"{i}_{arm}", dev)
        if attention.LAUNCHES["flash_fwd"] != model.config.depth * len(chunks):
            raise RuntimeError(f"448-px serving ({arm}): launches {cs.all_launches()}")
        res["serve_tiles_per_s"].append(sum(valid) / secs)
    print(f"[e2e] serving at 448 px, {SERVE_CHUNKS} chunks x {cs.TILES_PER_ITER_448} tiles "
          f"through extract_features, order {res['arms']}: "
          f"{[round(x, 1) for x in res['serve_tiles_per_s']]} tiles/s; on {smi}")
    use(NEW)
    return res


def main() -> None:
    args = sys.argv[1:]
    old = ROOT / "build" / "ab" / "csrc_v1"
    if "--old" in args:
        i = args.index("--old")
        old = Path(args[i + 1])
        del args[i:i + 2]
    variants = [a for a in args if ":" in a]  # ablate's NAME:FIND=>REPLACE;...
    modes = [a for a in args if ":" not in a] or ["check"]
    torch.manual_seed(cs.SEED)
    smi = cs.phase_device()
    summary = {}
    t0 = time.perf_counter()
    for mode in modes:
        if mode == "check":
            summary["check"] = mode_check(smi)
        elif mode == "ab":
            summary["ab"] = mode_ab(smi, old)
        elif mode == "e2e":
            summary["e2e"] = mode_e2e(smi, old)
        elif mode == "ablate":
            summary["ablate"] = mode_ablate(smi, variants)
        else:
            raise SystemExit(f"unknown mode {mode!r}: check, ab, e2e, ablate")
    print(f"[ab] done in {time.perf_counter() - t0:.1f} s; on {smi}")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
