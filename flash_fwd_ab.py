#!/usr/bin/env python3
"""A/B of hand-written kernels against another kernel tree, on one card: the
flash family (K4a, K4a', K4b, K4b'), the whole-sequence backward (K1b, K3),
the fused MLP with its sub-block (K5f, K5b, K6f, K6b), the attention
sub-block (K8f, K8b) and the dense layers at width 384 (K7, K9c, K9d).

    python3 flash_fwd_ab.py [check] [ab] [bwd] [e2e] [mha_bwd] [mlp] [mlp_e2e]
        [attn_block] [dense] [ablate 'NAME:FIND=>REPLACE;...' ...] [cutout]
        [--old DIR] [--only SOURCE] [--cuts A,B] [--base DIR]

``DIR`` (default ``build/ab/csrc_v1``) holds another copy of
``tpuwsi_torch/ops/csrc`` (for instance the parent commit's, unpacked with
``git archive``); both trees are built into their own libraries, keyed by
their sources' hash, and the script switches between them in one process.
Modes, in the order given:

- ``check``: build this tree, print ptxas' lines for the flash kernels, and
  run ``chip_smoke.phase_flash_kernels`` (every flash case and its timing);
- ``ab``: K4a and K4a' at the 448-px step's shape (192, 6, 785) and a 448-px
  serving chunk's (128, 6, 785), q, k, v as strided views of a fused qkv, in
  the order new, old, old, new: medians of 20 single calls and medians of 5
  runs of 50 launches back to back (CUDA events), SDPA on the same inputs,
  the bound from ``chip_smoke.flash_bound``;
- ``bwd``: K4b and K4b' (each C function alone) and the pair through
  ``_launch_flash_bwd`` at (192, 6, 785) with q, k, v, dO, dq, dk, dv as
  strided views and at (4, 6, 1024) contiguous, in the order new, old, old,
  new, timed as ``ab`` times the forward, beside SDPA's autograd backward on
  the same inputs and the bound; the new kernels must give the same bits in
  both of their arms;
- ``e2e``: the DINO step with ``--dino-global-size 448`` (one bundle, 2
  warm-up steps, then 1 + 6 steps a library, medians of the 6) and serving at
  448 px (``extract_features`` over 8 chunks of 128 tiles), each in the order
  new, old, old, new, with the launch counts checked;
- ``ablate``: variants of this tree's flash_fwd.cu or flash_bwd.cu (the one
  that holds a variant's first FIND), each a copy under
  ``build/ab/var_NAME/`` with the given text replacements (for instance
  ``'st10:kStages = 8=>kStages = 10'``), checked against the plain version and
  timed beside the tree's own kernels at the step's shape in the order
  base, v1 .. vn, vn .. v1, base: the forward pair for flash_fwd.cu, K4b and
  K4b' for flash_bwd.cu;
- ``mha_bwd``: K1b (``mha_qkv_bwd_saved``) and K3 (``mha_qkv_bwd``) at the DINO
  step's shapes (192, 197) and (576, 37) and the supervised step's (256,
  257: the streamed form), D 384, 6 heads, in the order new,
  old, old, new, timed as ``ab`` times the forward, beside SDPA's autograd
  backward and the bound from ``chip_smoke.attention_bound`` (the new kernels
  must repeat their bits in both arms); then the tuned 224-px DINO step and
  the step with ``attn_save_probs`` off (one bundle each, 2 warm-up steps,
  then 1 + 6 steps a library, medians of the 6, launch counts checked), in
  the same order, and last one profiled step of each with each library
  (kernel time and busy share);
- ``mlp``: the four fused-MLP kernels at D 384, F 1,536, tanh GELU (``MLP_AB``:
  K5f and K5b at the DINO step's student rows, 37,824 and 21,312; K6f at a
  500-tile serving chunk's 128,500 rows and at 37,824; K6b at 37,824 and
  21,312), in the order new, old, old, new: medians of 20 single calls and
  medians of 5 runs of 50 launches back to back, beside the unfused route
  (library GEMMs and GELU, with LayerNorm and the residual sum for the
  sub-block, their autograd backward) read the same two ways, and the bound
  from ``chip_smoke.mlp_bound``; the new kernels must repeat their bits in
  both of their arms. An arm's backward gets the row groups its tree was
  launched with (``use``);
- ``mlp_e2e``: the DINO step with ``use_fused_mlp`` and with
  ``mlp_pallas_bwd``, full width and depth (one bundle each, 2 warm-up
  steps, then 1 + 6 steps a library, medians of the 6, the MLP kernels'
  launch counts checked, the sub-block's too), in the order new, old, old,
  new; then serving at 256 px with ``use_fused_mlp`` beside the default
  route (``extract_features`` over 8 chunks of 500 tiles, each route in each
  arm, launch counts checked); last, one profiled step of each route with
  each library (kernel time by kind, busy share);
- ``attn_block``: K8f and K8b at ``ATTN_AB`` (the step's global views, a
  500-tile serving chunk, a batch of 8 tiles, ViT-B at 197 and 257 tokens),
  in the order new, old, old, new (ViT-B: new only, the old kernels refuse
  it): medians of 20 single calls and of 5 runs of 50 back to back, beside
  the unfused route (the model's norm1 + attention + residual sum, its
  autograd backward) read the same two ways, the plain version and the
  bound; the new K8b must repeat its bits. A tree before PR 13 gets its own
  forward launcher (``use``);
- ``dense``: K7 at the step's qkv and proj layers and its local views, K9c
  at (37,824, 384, 384) and a serving chunk's 128,500 rows, K9d, in the
  order new, old, old, new (K7 also on nn.Linear's layout in the new arms):
  single calls and back to back beside ``F.linear`` (with the residual sum;
  or its autograd backward), the plain version and the bound; K8b at (192,
  197) and ViT-B (16, 197), the same bits in every arm; the DINO step with
  ``dense_pallas_bwd`` beside the default route, with K7's kernel time per
  profiled step; last each case's device time (``torch.profiler``). It
  profiles, so run it last or alone. A tree whose K7 takes no weight-layout
  argument gets a launcher of its own (``use``);
- ``cutout``: the kernels of a source timed beside copies of it with one
  part cut out (``CUTOUTS``): K4b and K4b' (flash_bwd.cu, at (192, 6, 785)),
  K1b and K3 (mha_qkv_bwd.cu, at (192, 197)), K5f and K5b (mlp_sm90.cu, at
  (37,824, 384, 1,536)): where their time goes; for mlp_sm90.cu also copies
  with a choice of the design undone (releases at cluster scope, a
  384-thread block with ``setmaxnreg``), whose ptxas lines are printed. The
  copies' outputs are not checked (a cut-out's are wrong by design).
  ``--only SOURCE`` limits ``cutout`` to one source, ``--cuts A,B`` to
  those copies (for mlp_sm90.cu also ``no_ln_prologue``, ``no_ln_epilogue``:
  the sub-block's in-tile LayerNorm, the dx pass's LayerNorm backward; and
  ``dy_from_smem``, the dx pass holding its tile for the epilogue's dy). For
  attn_block.cu (K8f and K8b at (192, 197), K8f also at (8, 257)): the
  attention walks, the remote o loads, each product, all arithmetic (with
  half of every weight stage fetched too), the head kernel's phases, the dx
  or dW tails; with ``--base DIR`` (the parent tree) and ``--cuts
  pr6_no_head,...`` PR 6's K8b without its head kernel, dx tail, dW tails or
  sums, or the head kernel alone. For dense_sm90.cu (K7, K9c, K9d and K8b
  at the step's shapes): clusters of 1 or 2 in place of 4, three ring
  stages, no products, no TMA stores, the row pass alone (``dx_only``,
  also with clusters of 1 or 2). Every cutout also reads each copy's device
  time (``torch.profiler``) last.

Every line names the card's name and power limit; the last line is a JSON
summary.
"""

from __future__ import annotations

import ctypes
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
from tpuwsi_torch.ops import _build, attention, dense, mlp

ROOT = Path(__file__).resolve().parent
NEW = _build.CSRC
AB_SHAPES = [(192, 6, 785), (128, 6, 785)]
BWD_SHAPES = [(192, 6, 785, True), (4, 6, 1024, False)]  # (B, H, S, strided)
ABLATE_SOURCES = {"flash_fwd.cu": ("flash_fwd", "flash_fwd_stats"),
                  "flash_bwd.cu": ("flash_bwd_dq", "flash_bwd_dkv"),
                  "mha_qkv_bwd.cu": ("mha_qkv_bwd_saved", "mha_qkv_bwd"),
                  "mlp_sm90.cu": ("mlp_fwd", "mlp_bwd", "mlp_block_fwd", "mlp_block_bwd"),
                  "attn_block.cu": ("attn_block_fwd", "attn_block_bwd"),
                  "dense_sm90.cu": ("dense_bwd", "dense_bwd proj", "gemm_res_fwd",
                                    "gemm_res_bwd", "attn_block_bwd"),
                  "ln_gemm_sm90.cu": ("ln_gemm_fwd", "ln_gemm_fwd 128500", "ln_gemm_bwd")}
MHA_SHAPES = [(192, 197, 384, 6), (576, 37, 384, 6), (256, 257, 384, 6)]  # (B, N, D, H)
SERVE_CHUNKS, STEP_TIMED = 8, 6
# the fused-MLP kernels timed by ``mlp`` at D 384, F 1,536: rows -> kernels
MLP_AB = {128500: ("mlp_block_fwd",),
          37824: ("mlp_fwd", "mlp_bwd", "mlp_block_fwd", "mlp_block_bwd"),
          21312: ("mlp_fwd", "mlp_bwd", "mlp_block_bwd")}
MLP_AB_SHAPES = cs.MLP_TIMED_B2B  # (37,824, 384, 1,536), (21,312, 384, 1,536)
# the attention sub-block timed by ``attn_block`` and ``cutout``: (B, N, D, H, kernels);
# ViT-B has no old arm (PR 6's kernels refuse D = 768)
ATTN_AB = [(192, 197, 384, 6, ("attn_block_fwd", "attn_block_bwd")),
           (500, 257, 384, 6, ("attn_block_fwd",)),
           (8, 257, 384, 6, ("attn_block_fwd",)),
           (16, 197, 768, 12, ("attn_block_fwd", "attn_block_bwd")),
           (64, 257, 768, 12, ("attn_block_fwd",))]
# the dense-layer kernels timed by ``dense``: (kernel, rows, K, N), K the
# input width and N the output width (K9c: f and d); ``cutout`` times the
# first two of K7 and the first of K9c and K9d (dense_sm90.cu), or K9a and
# K9b (ln_gemm_sm90.cu)
DENSE_AB = [("dense_bwd", 37824, 384, 1152), ("dense_bwd", 37824, 384, 384),
            ("dense_bwd", 21312, 384, 1152), ("gemm_res_fwd", 37824, 384, 384),
            ("gemm_res_fwd", 128500, 384, 384), ("gemm_res_bwd", 37824, 384, 384),
            ("ln_gemm_fwd", 37824, 384, 1152), ("ln_gemm_fwd", 128500, 384, 1152),
            ("ln_gemm_bwd", 37824, 384, 1152)]
DENSE_CUT = [DENSE_AB[0], DENSE_AB[1], DENSE_AB[3], DENSE_AB[5]]
LN_GEMM_CUT = DENSE_AB[6:9]
# K8b, whose tails at D = 384 are K7's kernels: (B, N, D, H)
DENSE_K8B = [(192, 197, 384, 6), (16, 197, 768, 12)]
_NEW_DW_GROUPS = mlp.mlp_dw_groups
_NEW_BWD_BUFFERS = mlp._bwd_buffers


def _old_dw_groups(rows: int, f: int, sms: int) -> int:
    """The row groups of the row-tiled backward kernels (csrc/mlp_bwd.cu) at
    D = 384 (one per 64-row tile at most, ``DW_WAVES`` blocks per SM over F /
    64 slices)."""
    return max(1, min(-(-rows // 64), mlp.DW_WAVES * sms // (f // 64)))


def _bwd_buffers_of(old_for: set):
    """``mlp._bwd_buffers`` as a tree computed it that launched the D = 384
    backwards with ``row_sums`` in ``old_for`` (1: K5b, 3: K6b) on the
    row-tiled kernels, and so with their row groups: ``w_part`` is sized by
    them."""
    def buffers(x2, f: int, row_sums: int):
        mlp.mlp_dw_groups = _old_dw_groups if row_sums in old_for else _NEW_DW_GROUPS
        try:
            return _NEW_BWD_BUFFERS(x2, f, row_sums)
        finally:
            mlp.mlp_dw_groups = _NEW_DW_GROUPS
    return buffers


def _launch_attn_block_fwd_pr6(x, g, be, wqkv, bqkv, wp, bp, num_heads, scale, eps):
    """K8f of a tree before PR 13 (no LN(x) workspace; clusters asked by
    length alone): the same operands, that tree's C interface."""
    attention.check_attn_block_operands(x, g, be, wqkv, bqkv, wp, bp, num_heads)
    b, n, d = x.shape
    y = torch.empty_like(x)
    attention._call("attn_block_fwd", x,
                    (x.data_ptr(), g.data_ptr(), be.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                     wp.data_ptr(), bp.data_ptr(), y.data_ptr(), b, n, d, num_heads,
                     float(scale), float(eps)))
    return y


_NEW_ATTN_BLOCK_FWD = attention._launch_attn_block_fwd


def _launch_dense_bwd_no_layout(x2, dy2, w):
    """K7 of a tree whose C function takes no weight layout: W as (D, N)
    only, a copy of a transposed view."""
    w = w.contiguous()
    dense._check_operands(x2, dy2, w)
    return mlp._launch_dense_grads("dense_bwd", dense.LAUNCHES, x2, dy2, w)


_NEW_DENSE_BWD = dense._launch_dense_bwd
_NEW_CALL = mlp._call


def _call_without_ln_layout(name, like, args, counts=mlp.LAUNCHES):
    """``mlp._call`` for a tree whose LN+GEMM C functions take no weight
    layout (before csrc/ln_gemm_sm90.cu): W as (D, F) only, the trailing
    layout argument (0 there) dropped."""
    if name.startswith("ln_gemm"):
        if args[-1] != 0:
            raise ValueError("this tree's LN+GEMM kernels read W as (D, F) only")
        args = args[:-1]
    _NEW_CALL(name, like, args, counts)


def use(csrc: Path) -> Path:
    """Make the kernels of ``csrc`` the ones every wrapper launches: the
    builder reads its tree from ``_build.CSRC`` and keys each library by the
    tree's hash, so the libraries of both trees sit side by side. A tree
    without csrc/mlp_sm90.cu gets K5b and K6b launched with the row groups of
    the row-tiled kernels, one whose mlp_sm90.cu has no sub-block K6b
    alone; a tree whose K8f takes no LN(x) workspace, or whose K7, K9a and K9b
    take no weight layout, a launcher of its own for it."""
    _build.CSRC = Path(csrc)
    _build._lib = None
    _build.load()
    sm90 = Path(csrc) / "mlp_sm90.cu"
    text = sm90.read_text() if sm90.exists() else ""
    old_for = {1, 3} if not text else set() if "block_bwd" in text else {3}
    mlp._bwd_buffers = _bwd_buffers_of(old_for) if old_for else _NEW_BWD_BUFFERS
    # a tree before PR 13 takes K8f without the LN(x) workspace
    pr6 = "ln_launch" not in (Path(csrc) / "attn_block.cu").read_text()
    attention._launch_attn_block_fwd = _launch_attn_block_fwd_pr6 if pr6 else _NEW_ATTN_BLOCK_FWD
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if pr6:
        _build._lib.tpuwsi_attn_block_fwd.argtypes = [ptr] * 8 + [i32] * 4 + [f32, f32, ptr]
    # a tree whose K7 takes W as (D, N) only, with no layout argument
    no_layout = "w_layout" not in (Path(csrc) / "dense.cu").read_text()
    dense._launch_dense_bwd = _launch_dense_bwd_no_layout if no_layout else _NEW_DENSE_BWD
    if no_layout:
        _build._lib.tpuwsi_dense_bwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    # a tree before csrc/ln_gemm_sm90.cu: K9a and K9b take W as (D, F) only
    ln_no_layout = not (Path(csrc) / "ln_gemm_sm90.cu").exists()
    mlp._call = _call_without_ln_layout if ln_no_layout else _NEW_CALL
    if ln_no_layout:
        _build._lib.tpuwsi_ln_gemm_fwd.argtypes = [ptr] * 6 + [i32, i32, i32, f32, ptr]
        _build._lib.tpuwsi_ln_gemm_bwd.argtypes = [ptr] * 10 + [i32] * 4 + [f32, ptr]
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


def mode_check(smi: str) -> dict:
    lib = use(NEW)
    for line in ptxas_lines(lib, "flash_"):
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
                row["b2b_ms"].append(cs.back_to_back_ms(fn))
            lib = [cs.cuda_median_ms(lambda: sdpa(q, k, v)) for _ in range(2)]
            lib_b2b = cs.back_to_back_ms(lambda: sdpa(q, k, v))
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


def bwd_setup(gen, b, h, s, strided, scale=0.125):
    """Operands of the backward at (b, h, s) with lse from this tree's forward
    kernel → (q, k, v, do, lse, delta, grads, {name: fn}): each C function
    alone and the pair through the wrapper, writing into ``grads``."""
    q, k, v, do, o_view, grads = cs.flash_operands(gen, b, h, s, strided)
    o, lse = attention._launch_flash_fwd(q, k, v, None, scale, True, o_view)
    delta = attention._flash_delta(o, do)
    if grads is None:
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
    dq, dk, dv = grads
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    dims = (b, h, s, s)
    dq_args = (*ptrs, dq.data_ptr(), *dims, attention._strides(q, k, do, dq), scale)
    dkv_args = (*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, attention._strides(q, k, do, dk),
                scale)
    fns = {"flash_bwd_dq": lambda: attention._call("flash_bwd_dq", q, dq_args),
           "flash_bwd_dkv": lambda: attention._call("flash_bwd_dkv", q, dkv_args),
           "pair": lambda: attention._launch_flash_bwd(q, k, v, do, lse, delta, scale, grads)}
    return q, k, v, do, lse, delta, grads, fns


def mode_bwd(smi: str, old: Path) -> dict:
    arms = [("new", NEW), ("old", old), ("old", old), ("new", NEW)]
    for _, csrc in arms[:2]:
        use(csrc)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 10)
    out = {}
    for b, h, s, strided in BWD_SHAPES:
        use(NEW)
        q, k, v, do, lse, delta, grads, fns = bwd_setup(gen, b, h, s, strided)
        rows = {name: {"single_ms": [], "b2b_ms": [], "arms": [a for a, _ in arms]}
                for name in fns}
        ref = None
        for arm, csrc in arms:
            use(csrc)
            got = [x.clone() for x in fns["pair"]()]
            if arm == "new":
                if ref is None:
                    ref = got
                elif not all(torch.equal(a, r) for a, r in zip(got, ref)):
                    raise RuntimeError(f"the new backward's bits changed between arms at {s}")
            for name, fn in fns.items():
                rows[name]["single_ms"].append(cs.cuda_median_ms(fn))
                rows[name]["b2b_ms"].append(cs.back_to_back_ms(fn))
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)

        lib = [cs.cuda_median_ms(lib_bwd) for _ in range(2)]
        lib_b2b = cs.back_to_back_ms(lib_bwd)
        bounds = {name: cs.flash_bound(name, b, h, s, s) for name in ("flash_bwd_dq",
                                                                        "flash_bwd_dkv")}
        bounds["pair"] = {"bound_ms": sum(x["bound_ms"] for x in bounds.values()),
                          "bound_by": "operations"}
        layout = "strided views" if strided else "contiguous"
        for name, row in rows.items():
            row.update(sdpa_bwd_ms=lib, sdpa_bwd_b2b_ms=lib_b2b, **bounds[name])
            out[f"{name} {b}x{h}x{s}"] = row
            print(f"[bwd] {name} B={b} H={h} S={s} {layout}, order {row['arms']}: single "
                  f"calls (medians of 20) {row['single_ms']} ms; 50 back to back (medians of "
                  f"5, per launch) {row['b2b_ms']} ms; SDPA's whole backward {lib} / "
                  f"{lib_b2b:.4f} back to back; bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']}; on {smi}")
        del q, k, v, do, lse, delta, grads, fns, ql, kl, vl, lib_out, ref
        torch.cuda.empty_cache()
    use(NEW)
    return out


def mha_operands(gen, b, n, d, h):
    """qkv, g and the saved p at (b, n, d, h) → (operands, {name: kernel fn},
    {name: plain fn}) for K1b and K3 through their wrappers; p comes from
    this tree's K1a."""
    scale = (d // h) ** -0.5
    qkv = torch.randn((b, n, 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
    _, p = attention._launch_fwd_saved(qkv, h, scale, 0)
    fns = {"mha_qkv_bwd_saved": lambda: attention._launch_bwd_saved(qkv, g, p, h, scale),
           "mha_qkv_bwd": lambda: attention._launch_bwd(qkv, g, h, scale, 0)}
    plain = {"mha_qkv_bwd_saved": lambda: attention._mha_bwd_saved_reference(qkv, g, p, h, scale),
             "mha_qkv_bwd": lambda: attention._mha_bwd_reference(qkv, g, h, scale, 0)}
    return (qkv, g, p), fns, plain


def mode_mha_bwd(smi: str, old: Path) -> dict:
    arms = [("new", NEW), ("old", old), ("old", old), ("new", NEW)]
    for _, csrc in arms[:2]:
        use(csrc)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    kinds = {"mha_qkv_bwd_saved": "bwd_saved", "mha_qkv_bwd": "bwd"}
    out = {}
    for b, n, d, h in MHA_SHAPES:
        use(NEW)
        (qkv, g, _), fns, _ = mha_operands(gen, b, n, d, h)
        rows = {name: {"single_ms": [], "b2b_ms": [], "arms": [a for a, _ in arms]}
                for name in fns}
        ref = {}
        for arm, csrc in arms:
            use(csrc)
            for name, fn in fns.items():
                got = fn().clone()
                if arm == "new":
                    if name not in ref:
                        ref[name] = got
                    elif not torch.equal(got, ref[name]):
                        raise RuntimeError(f"{name}: the new kernel's bits changed between arms")
                rows[name]["single_ms"].append(cs.cuda_median_ms(fn))
                rows[name]["b2b_ms"].append(cs.back_to_back_ms(fn))
        lib_bwd = cs.sdpa_backward_fn(qkv, g, h)
        lib = [cs.cuda_median_ms(lib_bwd) for _ in range(2)]
        lib_b2b = cs.back_to_back_ms(lib_bwd)
        for name, row in rows.items():
            row.update(sdpa_bwd_ms=lib, sdpa_bwd_b2b_ms=lib_b2b,
                       **cs.attention_bound(kinds[name], b, n, d, h))
            out[f"{name} {b}x{n}"] = row
            print(f"[mha_bwd] {name} B={b} N={n} D={d} H={h}, order {row['arms']}: single "
                  f"calls (medians of 20) {row['single_ms']} ms; 50 back to back (medians of "
                  f"5, per launch) {row['b2b_ms']} ms; SDPA's autograd backward {lib} / "
                  f"{lib_b2b:.4f} back to back; bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']}; on {smi}")
        del qkv, g, fns, lib_bwd, ref
        torch.cuda.empty_cache()

    # the 224-px DINO step, tuned (K1b) and with attn_save_probs off (K3)
    batch = cs.train_batch()
    routes = {"tuned": (None, {"mha_qkv_bwd_saved": 24, "mha_qkv_bwd": 0}),
              "attn_save_probs off": ({"attn_save_probs": False},
                                      {"mha_qkv_bwd_saved": 0, "mha_qkv_bwd": 24})}
    views = None
    for tag, (overrides, want) in routes.items():
        use(NEW)
        bundle = cs.train_bundle(overrides)
        views = cs.TRAIN_BATCH * (bundle.dcfg.n_global + bundle.dcfg.n_local)
        cs.run_steps(bundle, batch, cs.WARMUP_STEPS)
        step_ms = []
        for arm, csrc in arms:
            use(csrc)
            steps = cs.run_steps(bundle, batch, 1 + STEP_TIMED)
            for r in steps:
                got = {name: r["launches"][name] for name in want}
                if got != want or not np.isfinite(r["loss"]):
                    raise RuntimeError(f"224-px step, {tag} ({arm}): launches {got}, loss "
                                       f"{r['loss']}")
            step_ms.append(statistics.median(r["ms"] for r in steps[1:]))
        out[f"step {tag}"] = {"arms": [a for a, _ in arms], "step_ms": step_ms}
        print(f"[mha_bwd] the 224-px DINO step, {tag}, order {[a for a, _ in arms]}, medians "
              f"of {STEP_TIMED} steps: {step_ms} ms per step = "
              f"{[round(views / ms * 1e3, 1) for ms in step_ms]} views/s; on {smi}")
        del bundle
        torch.cuda.empty_cache()

    # last (a profiled process launches more slowly after): kernel time and busy share
    for tag, (overrides, _) in routes.items():
        for arm, csrc in arms[:2]:
            use(csrc)
            bundle = cs.train_bundle(overrides)
            steps = cs.run_steps(bundle, batch, cs.WARMUP_STEPS + 3)
            ms = statistics.median(r["ms"] for r in steps[cs.WARMUP_STEPS:])
            cs.profile_step(f"224-px step, {tag}, {arm} kernels", bundle, batch, ms, smi)
            del bundle
            torch.cuda.empty_cache()
    use(NEW)
    return out


def variant_tree(name: str, edits: list[str], base: Path = NEW) -> tuple[Path, str]:
    """A copy of the tree ``base`` (this one by default) under build/ab/ with
    each ``FIND=>REPLACE`` of ``edits`` applied to the one source or header
    that holds its FIND (exactly one must) → (the tree, the source of
    ``ABLATE_SOURCES`` whose kernels the first edit changes: a header
    ``X.cuh`` stands for ``X.cu``)."""
    dst = ROOT / "build" / "ab" / f"var_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(base, dst)
    files = sorted([*dst.glob("*.cu"), *dst.glob("*.cuh")])
    first = None
    for edit in edits:
        find, _, repl = edit.partition("=>")
        hits = [f for f in files if find in f.read_text()]
        if len(hits) != 1:
            raise SystemExit(f"ablate {name}: {find!r} is in {[f.name for f in hits] or 'none'}")
        hits[0].write_text(hits[0].read_text().replace(find, repl))
        first = first or hits[0].name.replace(".cuh", ".cu")
    if first not in ABLATE_SOURCES:
        raise SystemExit(f"ablate {name}: {first} is none of {list(ABLATE_SOURCES)}")
    return dst, first


def mode_ablate(smi: str, specs: list[str]) -> dict:
    """``NAME:FIND=>REPLACE;...`` variants of flash_fwd.cu or flash_bwd.cu, then
    the kernels of each edited source at the step's shape in the order base,
    v1 .. vn, vn .. v1, base, each variant held against the plain version."""
    trees, sources = {"base": NEW}, set()
    for spec in specs:
        name, _, edits = spec.partition(":")
        trees[name], source = variant_tree(name, [e for e in edits.split(";") if e])
        sources.add(source)
    return time_variants(smi, "ablate", trees, sources, check=True)


# Copies of a source with one part of its kernels cut out, to see where their
# time goes without a profiler that sees inside a kernel: their outputs are
# wrong by design, so ``cutout`` times them unchecked. Each edit names exact
# source lines, so a change to the kernel needs its entry here updated.
_ROWS = """      float p = exp2_approx(fmaf(s[4 * i + e], scale_log2, row_b ? r.nl_b : r.nl_a));
      if (kMask && key0 + 8 * i + 2 * t4 + (e & 1) >= sk) p = 0.f;
      s[4 * i + e] = p * (dp[4 * i + e] - (row_b ? r.dl_b : r.dl_a)) * scale;"""
_COL_STATS = """    const float2 l = *reinterpret_cast<const float2*>(stats + 8 * i + 2 * t4);
    const float2 dl = *reinterpret_cast<const float2*>(stats + kTile + 8 * i + 2 * t4);
    const float nl0 = -l.x * kLog2e, nl1 = -l.y * kLog2e;"""
_COLS = """      const float p = exp2_approx(fmaf(s[4 * i + e], scale_log2, odd ? nl1 : nl0));
      s[4 * i + e] = p;
      dp[4 * i + e] = p * (dp[4 * i + e] - (odd ? dl.y : dl.x)) * scale;"""
_KEEP = "      s[4 * i + e] += dp[4 * i + e];"  # keeps both products' results in use
# mha_qkv_bwd.cu: the resident form's three steps (the path shapes take it)
_STEP1 = "    for (int i = kRank; i < T; i += kStep) {\n      const int row_a"
_STEP2 = "    for (int j = kRank; j < T; j += kStep) {\n      const int key_a"
_STEP3 = "      for (int t = kRank; t < T; t += kStep) {\n        float acc[32];"
_DS_COLS = "        ds_cols<kSaved>(pt, dst, sc, dp, st, span, bnd, c * kTile, prm.scale, t4);"
_STEP2_PRODUCT = "        wgmma_rn(dv, pt, sl.tile(sl.g, c), min(4, (R - c * kTile) / 16));\n"


def _skip(loop: str) -> tuple[str, str]:
    """The edit that makes a warpgroup's tile loop start past its last tile."""
    return (loop, loop.replace("= kRank;", "= T;"))


# mlp_sm90.cu: the products that rebuild u^T (and dh^T) in the row kernels and
# the dW passes, the elementwise steps, the row kernels' accumulating product
_U_ROW = ("          ss_n32<1, 0>(u, sw128(a), sw128(opaque(xb) + (kk >> 2) * kBox + (kk & 3) * 32), "
          "kk);\n")
_DH_ROW = ("          ss_n32<0, 0>(dh, sw128(a), sw128(opaque(xb) + L::kOffDy + (kk >> 2) * kBox + "
           "(kk & 3) * 32),\n                       kk);\n")
_U_DW = ("        ss_n32<1, 0>(u, sw128(opaque(w1s) + kk * 2048),\n"
         "                     sw128(opaque(xb) + (kk >> 2) * 4096 + (kk & 3) * 32), kk);\n")
_DH_DW = ("          ss_n32<0, 0>(dh, sw128(opaque(w2s) + (kk >> 2) * kBox + (kk & 3) * 32),\n"
          "                       sw128(opaque(xb) + 6 * 4096 + (kk >> 2) * 4096 + (kk & 3) * 32), "
          "kk);\n")
_ACC_FWD = ("            ss_n192<1, 1>(acc, sw128(opaque(ta) + k4 * 2048), sw128(opaque(wb) + "
            "k4 * 2048, kBox),\n                          1);\n")
_ACC_DX = ("            ss_n192<1, 0>(acc, sw128(opaque(ta) + k4 * 2048), sw128(opaque(wb) + "
           "k4 * 32), 1);\n")
_GELU = "            v[e] = mlp::gelu(x, kApprox);"
# the sub-block's in-tile LayerNorm (K6f, K6b) and the dx pass's LayerNorm
# backward epilogue (K6b; without it the pass stores dln with the residual)
_LN_ROWS = ("      ln_rows<kBwd, kWg>(prm, base, row0, tid, base + L::kOffStats + (tc & 1) * "
            "(kRows * 8));\n")
_LN_EPILOGUE = ("      ln_backward_epilogue<kWg>(acc, prm, base, tc, tile, row0, tid);\n"
                "      continue;\n")
# and a choice of its design undone: the dx pass holds the x/dy tile until its
# epilogue has read dy from shared memory, instead of releasing it at the
# last chunk and reading dy from device memory
_DY = "      const float2 xv = pair(prm.x, at_{0} + col), dyv = pair(prm.dy, at_{0} + col);"
_DY_SMEM = ("      const float2 xv = pair(prm.x, at_{0} + col), dyv = mlp::unpack_bf16(__float_as_uint("
            "ld_shared_f32(base + L::kOffDy + (col >> 6) * kBox + swz(r{0}, col & 63))));")
_DY_FROM_SMEM = [
    ("        warp_arrive(L::x_empty(base));\n      }\n",
     "        if constexpr (!(kBwd && kBlock)) warp_arrive(L::x_empty(base));\n      }\n"),
    (_LN_EPILOGUE, _LN_EPILOGUE.replace("      continue;", "      warp_arrive(L::x_empty(base));\n"
                                                          "      continue;")),
    (_DY.format("a"), _DY_SMEM.format("a")), (_DY.format("b"), _DY_SMEM.format("b"))]
# and two choices of its design undone (valid kernels, slower): remote releases
# at cluster scope, by each warp's lane 0 for all four blocks in turn (the
# first version) or by lane r for block r; and a producer warpgroup with
# setmaxnreg 24 / 240 in a 384-thread block in place of the 288-thread one
_ARRIVE = "  if (lane < kCluster) mbar_arrive_cluster(bar, lane);"
_ARRIVE_CLUSTER = ('  if ({}) {{ for (uint32_t r = {}; r < {}; ++r) asm volatile("{{\\n.reg .b32 rem;\\n'
                   'mapa.shared::cluster.u32 rem, %0, %1;\\nmbarrier.arrive.release.cluster.'
                   'shared::cluster.b64 _, [rem];\\n}}\\n" ::"r"(bar), "r"(r) : "memory"); }}')
_T384 = [("constexpr int kThreads = 288;", "constexpr int kThreads = 384;"),
         ("  if (role == 2) {\n    if (threadIdx.x == kConsumerThreads)\n",
          '  if (role == 2) {\n    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n");\n'
          "    if (threadIdx.x == kConsumerThreads)\n"),
         ("  } else if (role == 0) {\n",
          '  } else if (role == 0) {\n    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n");\n'),
         ("  } else {\n    row_consumer",
          '  } else {\n    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n");\n    row_consumer'),
         ("  } else {\n    slice_consumer",
          '  } else {\n    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n");\n'
          "    slice_consumer")]

# K8b as PR 6 built it (attn_block.cu of the parent tree, ``--base``): its
# head kernel, the dx tail, the two dW tails, the four fixed-order sums
_HEAD = "  attn_block_bwd_head_kernel<<<dim3(kHeads, batch), kBwdWarps * 32, head_smem, stream>>>("
_DX = "  dx_kernel<<<n_row_tiles, T::kThreads, kDxSmem, stream>>>("
_DW_QKV = "  dw_kernel<<<dim3(3 * kD / S::kNs, groups_qkv), S::kThreads, S::smem_bytes(), stream>>>("
_DW_PROJ = "  dw_kernel<<<dim3(kD / S::kNs, groups_proj), S::kThreads, S::smem_bytes(), stream>>>("
_SUMS = "  sum(w_part_qkv, out, groups_qkv, n_qkv);"


def _never(launch: str) -> tuple[str, str]:
    return launch, launch.replace("  ", "  if (false) ", 1)


# K8f and K8b as this tree builds them: one part of the forward's or the head
# kernel's work cut, every barrier kept
_WALKS = "      for (int j = 0; j < T; ++j) {\n        float s[32];\n        wgmma_fence();"
_REMOTE = "            const uint4 v = ld_cluster_v4(src + kk * 2048);"
_KV_MMA = ("            ss_n128<0, 1>(acc, sw128(opaque(a) + 32 * (2 * half + kk)),\n"
           "                          sw128(opaque(w) + kWg * kBox + 2048 * kk, kBox / 2), 1);")
_Q_MMA = ("          ss_n64<0, 1>(qa, sw128(opaque(a) + 32 * kk), sw128(opaque(w) + kWg * kBox + "
          "2048 * kk), 1);")
_PROJ_MMA = "            wgmma_n64_mn(ya, af[j][kk], desc(w + kWg * kBox + 2048 * kk), 1);"
_HALF_W = ["          tma_load_2d(dst + kBox / 2, wkv_map, bars.w_full(s), 2 * kD + 64 * h0, row);\n",
           "          tma_load_2d(dst + 3 * kBox / 2, wkv_map, bars.w_full(s), 2 * kD + 64 * h1, row);\n",
           "        tma_load_2d(dst + kBox, wq_map, bars.w_full(s), 64 * h1, 64 * kc);\n",
           "        tma_load_2d(dst + kBox, wp_map, bars.w_full(s), 128 * rank + 64, 64 * kc);\n",
           "    mbar_expect_tx(bars.w_full(s), kWStage);"]
_DX_TAIL = "  const int err = launch_rows<LnBackward<true>, false>("
_DW_TAILS = ["  const int e = dw(ln, dqkv, w_part_qkv, rows, 3 * kTailD, groups_qkv, stream);",
             "  return dw(o, dyp, w_part_proj, rows, kTailD, groups_proj, stream);"]
_PHASE_A = "    for (int i = kWg; i < T; i += 2) {"
_PHASE_B = "    for (int j = kWg; j < T; j += 2) {"

# dense_sm90.cu's row kernel: the cluster that shares W (4) undone or halved,
# three ring stages, the products, the TMA stores of the epilogue
_ROW_CLUSTER = "constexpr int kRowCluster = 4;"
_ROW_MMA = ("        if constexpr (kTransB)\n"
            "          ss_n192<0, 1>(acc, sw128(opaque(st) + 32 * kk), sw128(wb + 2048 * kk, kBox), 1);\n"
            "        else\n"
            "          ss_n192<0, 0>(acc, sw128(opaque(st) + 32 * kk), sw128(wb + 32 * kk), 1);")
_ROW_STORE = ("        tma_store_2d(out_map, io + (3 * kWg + j) * kBox, kTile * (3 * kWg + j), "
              "kTile * tile);")
# K7's and K9d's launch without its dW kernel and sums: the row pass alone
_DX_ONLY = [("  err = dw(x, dy, static_cast<float*>(w_part), rows, n, groups, stream);", "  err = 0;"),
            ("  mlp::sum_partials_kernel<float><<<static_cast<unsigned>((n_w + 255) / 256)",
             "  if (false) mlp::sum_partials_kernel<float><<<static_cast<unsigned>((n_w + 255) / 256)")]

# ln_gemm_sm90.cu's K9a: its in-tile LayerNorm, products, y's writes into the
# stage and TMA stores; the cluster that shares W halved or undone
_LN_TILE = "    ln_tile<kWg>(prm, base, tid);\n"
_FWD_MMA = ("          if constexpr (kTransB)\n"
            "            ss_n192<0, 1>(acc, a, sw128(wb + 2048 * kk, kBox), 1);\n"
            "          else\n"
            "            ss_n192<0, 0>(acc, a, sw128(wb + 32 * kk), 1);")
_Y_WRITES = ("    stsm_x4(io + (3 * kWg + group / 8) * kBox + row * 128 + ((((group & 7) ^ row) & 7) "
             "<< 4), r);")
_Y_STORE = ("      if (out < shape.n) tma_store_2d(y_map, io + (3 * kWg + j) * kBox, out, "
            "kTile * tile);")
_FWD_CLUSTER = "constexpr int kFwdCluster = 2;"

CUTOUTS = {
    "ln_gemm_sm90.cu": {
        "no_ln": [(_LN_TILE, "")],
        "no_products": [(_FWD_MMA, "          (void)a;\n          (void)wb;")],
        "no_y_writes": [(_Y_WRITES, "    (void)row;")],
        "no_stores": [(_Y_STORE, "      (void)out;")],
        "loads_only": [(_LN_TILE, ""), (_FWD_MMA, "          (void)a;\n          (void)wb;"),
                       (_Y_WRITES, "    (void)row;"), (_Y_STORE, "      (void)out;")],
        "cluster1": [(_FWD_CLUSTER, _FWD_CLUSTER.replace("2", "1"))],
        "cluster4": [(_FWD_CLUSTER, _FWD_CLUSTER.replace("2", "4"))],
    },
    "dense_sm90.cu": {
        "cluster1": [(_ROW_CLUSTER, _ROW_CLUSTER.replace("4", "1"))],
        "cluster2": [(_ROW_CLUSTER, _ROW_CLUSTER.replace("4", "2"))],
        "stages3": [("constexpr int kRowStages = 4;", "constexpr int kRowStages = 3;")],
        "no_products": [(_ROW_MMA, "        (void)wb;")],
        "no_stores": [(_ROW_STORE, "        (void)out_map;")],
        "dx_only": _DX_ONLY,
        "dx_only_cluster1": [*_DX_ONLY, (_ROW_CLUSTER, _ROW_CLUSTER.replace("4", "1"))],
        "dx_only_cluster2": [*_DX_ONLY, (_ROW_CLUSTER, _ROW_CLUSTER.replace("4", "2"))],
    },
    "attn_block.cu": {
        "no_attention": [(_WALKS, _WALKS.replace("j < T", "j < 0"))],
        "no_remote_loads": [(_REMOTE, "            const uint4 v = make_uint4(src, kk, 0, 0);")],
        "no_kv_products": [(_KV_MMA, "            ;")],
        "no_q_products": [(_Q_MMA, "          ;")],
        "no_proj_products": [(_PROJ_MMA, "            ;")],
        "loads_only": [(_WALKS, _WALKS.replace("j < T", "j < 0")), (_KV_MMA, "            ;"),
                       (_Q_MMA, "          ;"), (_PROJ_MMA, "            ;")],
        "no_phases": [(_PHASE_A, _PHASE_A.replace("i < T", "i < 0")),
                      (_PHASE_B, _PHASE_B.replace("j < T", "j < 0"))],
        "no_dx_tail": [(_DX_TAIL, "  const int err = 0;\n  if (false) launch_rows<LnBackward<true>, false>(")],
        "no_dw_tails": [(_DW_TAILS[0], "  const int e = 0;"), (_DW_TAILS[1], "  return 0;")],
        # loads only, half of every weight stage fetched: bytes or latency?
        "loads_only_half_w": [(_WALKS, _WALKS.replace("j < T", "j < 0")), (_KV_MMA, "            ;"),
                              (_Q_MMA, "          ;"), (_PROJ_MMA, "            ;"),
                              (_HALF_W[0], ""), (_HALF_W[1], ""), (_HALF_W[2], ""),
                              (_HALF_W[3], ""), (_HALF_W[4], _HALF_W[4].replace("kWStage", "kWStage / 2"))],
        "pr6_no_head": [_never(_HEAD)],
        "pr6_no_dx": [_never(_DX)],
        "pr6_no_dw": [_never(_DW_QKV), _never(_DW_PROJ)],
        "pr6_no_sums": [(_SUMS, "  if (false) {\n" + _SUMS), ("  sum(dbqkv_part, out + n_qkv",
                                                                "  }\n  if (false) sum(dbqkv_part, out + n_qkv")],
        "pr6_head_only": [(_DX, "  return 0;\n" + _DX)],
    },
    "flash_bwd.cu": {
        "no_elementwise": [(_ROWS, _KEEP), (_COL_STATS, ""), (_COLS, _KEEP)],
        "no_exp": [("exp2_approx(fmaf(s[4 * i + e], scale_log2, row_b ? r.nl_b : r.nl_a))",
                    "fmaf(s[4 * i + e], scale_log2, row_b ? r.nl_b : r.nl_a)"),
                   ("exp2_approx(fmaf(s[4 * i + e], scale_log2, odd ? nl1 : nl0))",
                    "fmaf(s[4 * i + e], scale_log2, odd ? nl1 : nl0)")],
        "no_s_dp": [("      wgmma_nt_k64(s, dq_, dk);\n      wgmma_nt_k64(dp, dd, dv);\n"
                     "      wgmma_commit();\n      wgmma_rn_k64(acc", "      wgmma_commit();\n"
                     "      wgmma_rn_k64(acc"),
                    ("      wgmma_nt_k64(s, dk_, dq_);\n      wgmma_nt_k64(dp, dv_, dd);\n"
                     "      wgmma_commit();\n      wgmma_rn_k64(dv", "      wgmma_commit();\n"
                     "      wgmma_rn_k64(dv")],
        "no_accumulate": [("      wgmma_rn_k64(acc, ds, dk_prev);\n", ""),
                          ("      wgmma_rn_k64(dv, pt, dd_prev);\n"
                           "      wgmma_rn_k64(dk, dst, dq_prev);\n", "")],
    },
    "mlp_sm90.cu": {
        "no_rebuild": [(_U_ROW, ""), (_DH_ROW, ""), (_U_DW, ""), (_DH_DW, "")],
        "no_gelu": [(_GELU, "            v[e] = x;")],
        "no_accumulate": [(_ACC_FWD, "            ;\n"), (_ACC_DX, "            ;\n")],
        "loads_only": [(_U_ROW, ""), (_DH_ROW, ""), (_U_DW, ""), (_DH_DW, ""),
                       (_GELU, "            v[e] = x;"),
                       (_ACC_FWD, "            ;\n"), (_ACC_DX, "            ;\n")],
        "release_cluster": [(_ARRIVE, _ARRIVE_CLUSTER.format("lane < kCluster", "lane", "lane + 1"))],
        "release_cluster_lane0": [(_ARRIVE, _ARRIVE_CLUSTER.format("lane == 0", "0", "kCluster"))],
        "t384_setmaxnreg": _T384,
        "no_ln_prologue": [(_LN_ROWS, "")],
        "no_ln_epilogue": [(_LN_EPILOGUE, "")],
        "dy_from_smem": _DY_FROM_SMEM,
    },
    "mha_qkv_bwd.cu": {
        "no_step1": [_skip(_STEP1)],
        "no_step2_elementwise": [(_DS_COLS, "        pack_a(dp, pt);\n        pack_a(dp, dst);")],
        "no_step2_product": [(_STEP2_PRODUCT, "")],
        "no_step3": [_skip(_STEP3)],
        "loads_only": [_skip(_STEP1), _skip(_STEP2), _skip(_STEP3)],
    },
}


def mode_cutout(smi: str, only: str | None = None, cuts: set | None = None,
                base: Path = NEW) -> dict:
    """Each source's kernels with one part cut out (``CUTOUTS``) beside the
    whole kernels at the step's shape, order base, v1 .. vn, vn .. v1, base;
    unchecked. flash_bwd.cu: the elementwise work, the exponentials, S and
    dP, the accumulating products, in the steps after the first stage.
    mha_qkv_bwd.cu: each of the three steps, step 2's elementwise work or
    its accumulating product (dV), and all of the arithmetic (loads only).
    mlp_sm90.cu: the rebuild products, the GELU, the accumulating products,
    all of the arithmetic; and the design variants beside them.
    attn_block.cu (``pr6_*``, with ``--base`` the parent tree of PR 13): K8b
    as PR 6 built it with its head kernel, dx tail, dW tails or sums skipped,
    or the head kernel alone, at (192, 197, 384, 6)."""
    res = {}
    for source, cuts_of in CUTOUTS.items():
        if only not in (None, source):
            continue
        trees = {"base": base}
        for name, edits in cuts_of.items():
            if cuts is None or name in cuts:
                trees[name], _ = variant_tree(name, [f"{find}=>{repl}" for find, repl in edits],
                                              base)
        res[source] = time_variants(smi, "cutout", trees, {source}, check=False)
    return res


def time_variants(smi: str, tag: str, trees: dict, sources: set, check: bool) -> dict:
    """Build each tree, then time the kernels of ``sources`` of each at the
    step's shape (the flash kernels at (192, 6, 785), K1b and K3 at (192,
    197), K5f and K5b at (37,824, 384, 1,536)) in the order base, v1 .. vn,
    vn .. v1, base (then, in the same order, each call's device time); with
    ``check``, each variant's outputs must agree with the plain version."""
    kernels = [k for s in ABLATE_SOURCES if s in sources for k in ABLATE_SOURCES[s]]
    if "attn_block.cu" in sources:  # K8f also at a batch of 8 tiles
        kernels = [*kernels, "attn_block_fwd 8"]
    for name, tree in trees.items():
        t0 = time.perf_counter()
        lib = use(tree)
        print(f"[{tag}] {name}: built in {time.perf_counter() - t0:.1f} s")
        for needle in ("flash_", "mha_qkv_bwd", "mlp_sm90", "attn_block", "dense_sm90",
                       "ln_gemm"):
            for line in ptxas_lines(lib, needle):
                if ("registers" in line or "spill" in line or "Performance Loss" in line) and (
                        "C7519" not in line):
                    print(f"[{tag}] {name} ptxas: {line}")
    use(NEW)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    fns, checks = {}, []
    flash = {"flash_fwd.cu", "flash_bwd.cu"} & sources
    if flash:
        b, h, s = AB_SHAPES[0]
        q, k, v, do, lse, delta, grads, bwd = bwd_setup(gen, b, h, s, True)
        o_view = attention._heads(torch.empty((b, s, h * 64), dtype=q.dtype, device="cuda"),
                                  h, 1)[0]
        fns.update({
            "flash_fwd": lambda: attention._launch_flash_fwd(q, k, v, None, 0.125, False, o_view),
            "flash_fwd_stats": lambda: attention._launch_flash_fwd(q, k, v, None, 0.125, True,
                                                                   o_view),
            "flash_bwd_dq": bwd["flash_bwd_dq"], "flash_bwd_dkv": bwd["flash_bwd_dkv"]})
        case = f"B={b} H={h} S={s} strided"
        if check and "flash_fwd.cu" in sources:
            want_o = attention._flash_reference(q, k, v, None, 0.125)[0]
            checks += [lambda name, kname=kname: cs.check_flash(
                f"{kname} {name}", case, fns[kname]()[0], want_o)
                for kname in ABLATE_SOURCES["flash_fwd.cu"]]
        if check and "flash_bwd.cu" in sources:
            want_grads = attention._flash_bwd_reference(q, k, v, do, lse, delta, 0.125)

            def check_bwd(name):
                for gname, got, want in zip(("dq", "dk", "dv"), bwd["pair"](), want_grads):
                    cs.check_flash(f"flash_bwd {gname} {name}", case, got, want)
            checks.append(check_bwd)
    if "mlp_sm90.cu" in sources:
        rows, d, f = MLP_AB_SHAPES[0]
        mlp_fns, _, mlp_plain = mlp_operands(gen, rows, d, f)
        fns.update(mlp_fns)
        case = f"rows={rows} D={d} F={f}"
        if check:
            want_mlp = {kname: fn() for kname, fn in mlp_plain.items()}
            checks += [lambda name, kname=kname: cs.check_mlp(f"{kname} {name}", case, fns[kname](),
                                                              want_mlp[kname])
                       for kname in mlp_fns]
    if "attn_block.cu" in sources:
        shape = ATTN_AB[0][:4]
        blk_fns, _, blk_plain = attn_block_operands(gen, *shape)
        fns.update(blk_fns)
        fns["attn_block_fwd 8"] = attn_block_operands(gen, *ATTN_AB[2][:4], ("attn_block_fwd",))[0][
            "attn_block_fwd"]
        case = "B={} N={} D={} H={}".format(*shape)
        if check:
            want_blk = {kname: fn() for kname, fn in blk_plain.items()}
            checks += [lambda name, kname=kname: cs.check_mlp(f"{kname} {name}", case, fns[kname](),
                                                              want_blk[kname])
                       for kname in blk_fns]
    if "dense_sm90.cu" in sources:
        dense_fns, _, dense_plain, _ = dense_operands(gen, DENSE_CUT)
        names = ABLATE_SOURCES["dense_sm90.cu"][:4]
        fns.update({kname: dense_fns[key] for kname, key in zip(names, DENSE_CUT)})
        # K8b at (192, 197), whose dx tail is the row pass and dW tails the dW kernel
        fns["attn_block_bwd"] = attn_block_operands(gen, *ATTN_AB[0][:4], ("attn_block_bwd",))[0][
            "attn_block_bwd"]
        case = "K7 at (37,824, 384, 1,152) and (37,824, 384, 384), K9c and K9d at the latter"
        if check:
            want_dense = {kname: dense_plain[key]() for kname, key in zip(names, DENSE_CUT)}
            checks += [lambda name, kname=kname: cs.check_mlp(f"{kname} {name}", case, fns[kname](),
                                                              want_dense[kname])
                       for kname in names]
    if "ln_gemm_sm90.cu" in sources:
        ln_fns, _, ln_plain, _ = dense_operands(gen, LN_GEMM_CUT)
        names = ABLATE_SOURCES["ln_gemm_sm90.cu"]
        fns.update({kname: ln_fns[key] for kname, key in zip(names, LN_GEMM_CUT)})
        case = "K9a at (37,824, 384, 1,152) and (128,500, 384, 1,152), K9b at the first"
        if check:
            want_ln = {kname: ln_plain[key]() for kname, key in zip(names, LN_GEMM_CUT)}
            checks += [lambda name, kname=kname: cs.check_mlp(f"{kname} {name}", case, fns[kname](),
                                                              want_ln[kname])
                       for kname in names]
    if "mha_qkv_bwd.cu" in sources:
        shape = MHA_SHAPES[0]
        _, mha, plain = mha_operands(gen, *shape)
        fns.update(mha)
        case = f"B={shape[0]} N={shape[1]}"
        if check:
            want = {kname: fn() for kname, fn in plain.items()}
            checks += [lambda name, kname=kname: cs.check_close(
                f"{kname} {name}", (*shape, 0), mha[kname](), want[kname]) for kname in mha]
    order = [*trees, *reversed(trees)]
    res = {name: {kname: [] for kname in kernels} for name in trees}
    for name in order:
        use(trees[name])
        for fn in checks:
            fn(name)
        torch.cuda.synchronize()
        for kname in kernels:
            try:
                res[name][kname].append((cs.cuda_median_ms(fns[kname]),
                                         cs.back_to_back_ms(fns[kname])))
            except RuntimeError as e:  # a launch the variant refuses: reported, not timed
                print(f"[{tag}] {name} {kname}: {e}")
                res[name][kname].append(None)
    for name, r in res.items():
        print(f"[{tag}] {name}: (single, back to back) ms, order {order}: "
              + ", ".join(f"{kname} {r[kname]}" for kname in kernels)
              + f"; {case}; on {smi}")
    # last (a profiled process launches more slowly after): the device time of
    # each call's kernels alone, which back-to-back readings of calls as short
    # as the host's launch work cannot separate from it
    for name in order:
        use(trees[name])
        for kname in kernels:
            if None not in res[name][kname]:
                res[name].setdefault(f"{kname} device", []).append(device_ms(fns[kname]))
    for name, r in res.items():
        print(f"[{tag}] {name}: device ms a call (torch.profiler, {DEVICE_CALLS} calls), order "
              f"{order}: " + ", ".join(f"{kname} {r.get(kname + ' device')}" for kname in kernels)
              + f"; on {smi}")
    use(NEW)
    return res


DEVICE_CALLS = 10


def device_ms(fn, calls: int = DEVICE_CALLS) -> float:
    """The device time of ``calls`` calls of ``fn`` under torch.profiler (the
    CUDA kernels' own trace events, summed) per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def kernel_device_ms(fn, calls: int = DEVICE_CALLS) -> dict:
    """As ``device_ms``, by kernel: {the kernel's name up to its argument
    list: device ms a call}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.removeprefix("void ")
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def mlp_operands(gen, rows, d, f, names=ABLATE_SOURCES["mlp_sm90.cu"]):
    """bf16 operands of the fused-MLP kernels as chip_smoke makes them →
    (kernel functions, the unfused route's functions, the plain versions, on
    the same operands), for the kernels in ``names``."""
    def randn(shape, std=1.0, dtype=torch.bfloat16):
        return (std * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    x, dy = randn((rows, d)), randn((rows, d))
    g, be = 1.0 + randn((d,), 0.1, torch.float32), randn((d,), 0.1, torch.float32)
    w1, b1 = randn((d, f), d ** -0.5), randn((f,), 0.1)
    w2, b2 = randn((f, d), f ** -0.5), randn((d,), 0.1)
    fns = {"mlp_fwd": lambda: (mlp._launch_mlp_fwd(x, w1, b1, w2, b2, True),),
           "mlp_bwd": lambda: mlp._launch_mlp_bwd(x, dy, w1, b1, w2, True),
           "mlp_block_fwd": lambda: (mlp._launch_mlp_block_fwd(x, g, be, w1, b1, w2, b2, True,
                                                               1e-6),),
           "mlp_block_bwd": lambda: mlp._launch_mlp_block_bwd(x, dy, g, be, w1, b1, w2, True,
                                                              1e-6)}
    plain = {"mlp_fwd": lambda: (mlp._mlp_fwd_reference(x, w1, b1, w2, b2, True),),
             "mlp_bwd": lambda: mlp._mlp_bwd_reference(x, dy, w1, b1, w2, True),
             "mlp_block_fwd": lambda: (mlp._mlp_block_fwd_reference(x, g, be, w1, b1, w2, b2,
                                                                    True, 1e-6),),
             "mlp_block_bwd": lambda: mlp._mlp_block_bwd_reference(x, dy, g, be, w1, b1, w2, True,
                                                                   1e-6)}
    leaves = [t.detach().requires_grad_() for t in
              (x, g, be, w1.t().contiguous(), b1, w2.t().contiguous(), b2)]
    unfused = {}
    for name in names:
        block = "block" in name
        if name.endswith("fwd"):
            def unfused_fwd(block=block):
                with torch.no_grad():
                    return cs.unfused_mlp(*leaves, True, block)
            unfused[name] = unfused_fwd
        else:
            y = cs.unfused_mlp(*leaves, True, block)
            wrt = leaves if block else [leaves[0], *leaves[3:]]
            unfused[name] = lambda y=y, wrt=wrt: torch.autograd.grad(y, wrt, dy, retain_graph=True)
    return ({n: fns[n] for n in names}, unfused, {n: plain[n] for n in names})


def attn_block_operands(gen, b, n, d, h, names=ABLATE_SOURCES["attn_block.cu"]):
    """Operands of the sub-block kernels as chip_smoke makes them → (kernel
    functions, the unfused route's functions, the plain versions), for the
    kernels in ``names``. The unfused route is the model's own norm1 +
    attention + residual sum on one block of the tuned ViT of width d (its
    autograd backward for K8b)."""
    def randn(shape, std=1.0, dtype=torch.bfloat16):
        return (std * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    scale, eps = (d // h) ** -0.5, 1e-6
    x, dy = randn((b, n, d)), randn((b, n, d))
    g, be = 1.0 + randn((d,), 0.1, torch.float32), randn((d,), 0.1, torch.float32)
    wqkv, bqkv = randn((d, 3 * d), d ** -0.5), randn((3 * d,), 0.1)
    wp, bp = randn((d, d), d ** -0.5), randn((d,), 0.1)
    fns = {"attn_block_fwd": lambda: (attention._launch_attn_block_fwd(
               x, g, be, wqkv, bqkv, wp, bp, h, scale, eps),),
           "attn_block_bwd": lambda: attention._launch_attn_block_bwd(
               x, dy, g, be, wqkv, bqkv, wp, h, scale, eps)}
    plain = {"attn_block_fwd": lambda: (attention._attn_block_fwd_reference(
                 x, g, be, wqkv, bqkv, wp, bp, h, scale, eps),),
             "attn_block_bwd": lambda: attention._attn_block_bwd_reference(
                 x, dy, g, be, wqkv, bqkv, wp, h, scale, eps)}
    blk = cs.tuned_block(g, be, wqkv, bqkv, wp, bp, cs.ATTN_BLOCK_MODELS[d])
    xl = x.detach().requires_grad_()
    leaves = [xl, blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight, blk.attn.qkv.bias,
              blk.attn.proj.weight, blk.attn.proj.bias]
    unfused = {}
    for name in names:
        if name.endswith("fwd"):
            def unfused_fwd():
                with torch.no_grad():
                    return cs.unfused_attention_half(blk, x, False)
            unfused[name] = unfused_fwd
        else:
            y = cs.unfused_attention_half(blk, xl, True)
            unfused[name] = lambda y=y: torch.autograd.grad(y, leaves, dy, retain_graph=True)
    return ({n: fns[n] for n in names}, unfused, {n: plain[n] for n in names})


def dense_operands(gen, cases):
    """bf16 operands of the dense-layer kernels as chip_smoke makes them, per
    case of ``cases`` → (kernel functions, library functions, plain versions,
    and for K7 the kernel on nn.Linear's layout: W passed as ``weight.t()``);
    the kernel and plain functions return tuples.
    The kernel functions give K7, K9a and K9b W as a contiguous (K, N)
    tensor, which every tree takes as it is (``linear``: nn.Linear's storage,
    for the trees that read it in place); the library is one PyTorch call on
    nn.Linear's weight (``F.linear``, with the residual sum or after
    ``F.layer_norm`` in fp32 and a cast; or its autograd backward)."""
    F = torch.nn.functional

    def randn(shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)

    fns, library, plain, linear = {}, {}, {}, {}
    for case in cases:
        name, rows, k, n = case
        a, w, b = randn((rows, k)), randn((k, n), k ** -0.5), randn((n,), 0.1)
        wl = w.t().contiguous()  # nn.Linear's (N, K) weight
        if name.startswith("ln_gemm"):
            g = (1.0 + 0.1 * torch.randn((k,), generator=gen, device="cuda"))
            be = 0.1 * torch.randn((k,), generator=gen, device="cuda")
            ln_operands(case, a, g, be, w, wl, b, randn, fns, library, plain, linear)
            continue
        if name == "gemm_res_fwd":
            res = randn((rows, n))
            fns[case] = lambda a=a, w=w, b=b, res=res: (mlp._launch_gemm_res_fwd(res, a, w, b),)
            plain[case] = lambda a=a, w=w, b=b, res=res: (
                mlp._gemm_res_fwd_reference(res, a, w, b),)

            def linear_add(a=a, wl=wl, b=b, res=res):
                with torch.no_grad():
                    return res + F.linear(a, wl, b)
            library[case] = linear_add
            continue
        dy = randn((rows, n))
        ref = dense._dense_bwd_reference if name == "dense_bwd" else mlp._gemm_res_bwd_reference
        # the wrappers are looked up at each call: ``use`` swaps K7's for an old tree
        fns[case] = lambda a=a, dy=dy, w=w, name=name: (
            dense._launch_dense_bwd if name == "dense_bwd" else mlp._launch_gemm_res_bwd)(a, dy, w)
        plain[case] = lambda a=a, dy=dy, w=w, ref=ref: ref(a, dy, w)
        if name == "dense_bwd":
            linear[case] = lambda a=a, dy=dy, wl=wl: dense._launch_dense_bwd(a, dy, wl.t())
        leaves = [t.detach().requires_grad_() for t in (a, wl, b)]
        y = F.linear(*leaves)
        library[case] = lambda y=y, leaves=leaves, dy=dy: torch.autograd.grad(y, leaves, dy,
                                                                             retain_graph=True)
    return fns, library, plain, linear


def ln_operands(case, x, g, be, w, wl, b, randn, fns, library, plain, linear) -> None:
    """K9a's or K9b's entries of ``dense_operands`` for ``case``."""
    F = torch.nn.functional
    k = x.shape[1]

    def ln(t):
        return F.layer_norm(t.float(), (k,), g_, be_, 1e-6).to(x.dtype)

    if case[0] == "ln_gemm_fwd":
        fns[case] = lambda: (mlp._launch_ln_gemm_fwd(x, g, be, w, b, 1e-6),)
        plain[case] = lambda: (mlp._ln_gemm_fwd_reference(x, g, be, w, b, 1e-6),)
        linear[case] = lambda: (mlp._launch_ln_gemm_fwd(x, g, be, wl, b, 1e-6, 1),)
        g_, be_ = g, be

        def ln_linear():
            with torch.no_grad():
                return F.linear(ln(x), wl, b)
        library[case] = ln_linear
        return
    dy = randn((x.shape[0], w.shape[1]))
    fns[case] = lambda: mlp._launch_ln_gemm_bwd(x, dy, g, be, w, 1e-6)
    plain[case] = lambda: mlp._ln_gemm_bwd_reference(x, dy, g, be, w, 1e-6)
    linear[case] = lambda: mlp._launch_ln_gemm_bwd(x, dy, g, be, wl, 1e-6, 1)
    leaves = [t.detach().requires_grad_() for t in (x, g, be, wl, b)]
    g_, be_ = leaves[1], leaves[2]
    y = F.linear(ln(leaves[0]), leaves[3], leaves[4])
    library[case] = lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)


def mode_dense(smi: str, old: Path) -> dict:
    """K7, K9c, K9d, K9a and K9b at ``DENSE_AB`` in the order new, old, old,
    new (K7, K9a and K9b also on nn.Linear's layout, new arms only, with the
    same bits): medians of 20 single calls and of 5 runs of 50 back to back,
    beside the library call read the same two ways, the plain version once
    and the bound from ``chip_smoke.dense_bound``; the new kernels must repeat
    their bits. Then K8b at ``DENSE_K8B`` the same way (its D = 384 tails are
    K7's kernels and the LayerNorm-backward epilogue: the same bits in every
    arm), the DINO step with ``dense_pallas_bwd`` beside the default route
    (``dense_step``), and last each case's device time alone, by kernel
    (``kernel_device_ms``: the row pass with its epilogue alone in K8b and
    K9b)."""
    arms = [("new", NEW), ("old", old), ("old", old), ("new", NEW)]
    for _, csrc in arms[:2]:
        use(csrc)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 14)
    out = {}
    use(NEW)
    fns, library, plain, linear = dense_operands(gen, DENSE_AB)
    for case in DENSE_AB:
        cs.check_mlp(case[0], "rows={} K={} N={}".format(*case[1:]), fns[case](), plain[case]())
    res = {case: {"single_ms": [], "b2b_ms": [], "arms": [a for a, _ in arms]} for case in DENSE_AB}
    ref = {}
    for arm, csrc in arms:
        use(csrc)
        for case, fn in fns.items():
            got = [t.clone() for t in fn()]
            if arm == "new":
                if case not in ref:
                    ref[case] = got
                elif not all(torch.equal(a, c) for a, c in zip(got, ref[case])):
                    raise RuntimeError(f"{case}: the new kernels' bits changed between arms")
            res[case]["single_ms"].append(cs.cuda_median_ms(fn))
            res[case]["b2b_ms"].append(cs.back_to_back_ms(fn))
            if arm == "new" and case in linear:
                if not all(torch.equal(a, c) for a, c in zip(linear[case](), ref[case])):
                    raise RuntimeError(f"{case}: nn.Linear's layout gave other bits")
                res[case].setdefault("linear_layout_ms", []).append(
                    (cs.cuda_median_ms(linear[case]), cs.back_to_back_ms(linear[case])))
    use(NEW)
    for case, row in res.items():
        name, rows, k, n = case
        lib = [cs.cuda_median_ms(library[case]) for _ in range(2)]
        lib_b2b = [cs.back_to_back_ms(library[case]) for _ in range(2)]
        row.update(library_ms=lib, library_b2b_ms=lib_b2b,
                   plain_ms=cs.cuda_median_ms(plain[case], reps=5, warmup=1),
                   **cs.dense_bound(name, rows, k, n))
        out[f"{name} {rows} {k} {n}"] = row
        print(f"[dense] {name} rows={rows} K={k} N={n}, order {row['arms']}: single calls "
              f"(medians of 20) {row['single_ms']} ms; 50 back to back (medians of 5, per "
              f"launch) {row['b2b_ms']} ms; nn.Linear's layout (single, b2b, new arms) "
              f"{row.get('linear_layout_ms', '-')}; library {lib} ms, back to back {lib_b2b} "
              f"ms; plain {row['plain_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']}; on {smi}")
    del fns, library, plain, linear, ref
    torch.cuda.empty_cache()
    out["attn_block_bwd"] = dense_k8b(smi, arms)
    out["step"] = dense_step(smi, arms)
    # last, after the step's profiles: each call's kernels alone on the device
    fns = dense_operands(gen, DENSE_AB)[0]
    b, n, d, h = DENSE_K8B[0]
    k8b = f"attn_block_bwd {b} {n} {d}"
    fns[k8b] = attn_block_operands(gen, b, n, d, h, ("attn_block_bwd",))[0]["attn_block_bwd"]
    out[k8b] = {}
    for arm, csrc in arms:
        use(csrc)
        for case, fn in fns.items():
            key = case if isinstance(case, str) else " ".join(map(str, case))
            by_kernel = kernel_device_ms(fn)
            row = out[key]
            row.setdefault("device_ms", []).append(sum(by_kernel.values()))
            row.setdefault("device_ms_by_kernel", []).append(by_kernel)
    for key in [*(" ".join(map(str, c)) for c in DENSE_AB), k8b]:
        print(f"[dense] {key}: device ms a call (torch.profiler, {DEVICE_CALLS} calls), order "
              f"{[a for a, _ in arms]}: {out[key]['device_ms']}; on {smi}")
        if len(out[key]["device_ms_by_kernel"][0]) > 1 or key.startswith("ln_gemm"):
            for arm, by_kernel in zip((a for a, _ in arms), out[key]["device_ms_by_kernel"]):
                print(f"[dense] {key} ({arm}) by kernel: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()) + " ms")
    use(NEW)
    return out


def dense_k8b(smi: str, arms) -> dict:
    """K8b at ``DENSE_K8B`` in the order of ``arms``, single calls and back to
    back; its bits the same in every arm (new and old tails compute alike)."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 15)
    out = {}
    for b, n, d, h in DENSE_K8B:
        use(NEW)
        fn = attn_block_operands(gen, b, n, d, h, ("attn_block_bwd",))[0]["attn_block_bwd"]
        row = {"single_ms": [], "b2b_ms": [], "arms": [a for a, _ in arms]}
        ref = None
        for arm, csrc in arms:
            use(csrc)
            got = [t.clone() for t in fn()]
            if ref is None:
                ref = got
            elif not all(torch.equal(a, c) for a, c in zip(got, ref)):
                raise RuntimeError(f"K8b ({b}, {n}, {d}): the {arm} kernels gave other bits")
            row["single_ms"].append(cs.cuda_median_ms(fn))
            row["b2b_ms"].append(cs.back_to_back_ms(fn))
        out[f"{b} {n} {d}"] = row
        print(f"[dense] attn_block_bwd B={b} N={n} D={d} H={h}, order {row['arms']}: single "
              f"calls {row['single_ms']} ms; back to back {row['b2b_ms']} ms; the same bits in "
              f"every arm; on {smi}")
        del fn
        torch.cuda.empty_cache()
    use(NEW)
    return out


def dense_step(smi: str, arms) -> dict:
    """The DINO step with ``dense_pallas_bwd`` and by the default route, full
    width and depth, one bundle each after 2 warm-up steps: in each arm 1 + 6
    steps of both routes, the route first in the first and third arm and
    second in the others (so each route reads in the order of ``arms`` and
    sits on both sides of the other), medians of the 6, launch counts checked;
    last, one profiled step of each route with each library: kernel time by
    kind, K7's kernels and their sums per step."""
    batch = cs.train_batch()
    flag = "dense_pallas_bwd"
    use(NEW)
    bundles = {flag: cs.train_bundle({flag: True}), "default": cs.train_bundle(None)}
    depth = bundles[flag].model.backbone.config.depth
    views = cs.TRAIN_BATCH * (bundles[flag].dcfg.n_global + bundles[flag].dcfg.n_local)
    want = {flag: 4 * depth, "default": 0}
    for bundle in bundles.values():
        cs.run_steps(bundle, batch, cs.WARMUP_STEPS)
    step_ms = {route: [] for route in bundles}
    for i, (arm, csrc) in enumerate(arms):
        use(csrc)
        for route in (flag, "default") if i % 2 == 0 else ("default", flag):
            steps = cs.run_steps(bundles[route], batch, 1 + STEP_TIMED)
            for r in steps:
                if r["launches"]["dense_bwd"] != want[route] or not np.isfinite(r["loss"]):
                    raise RuntimeError(f"the {route} step ({arm}): launches {r['launches']}, "
                                       f"loss {r['loss']}")
            step_ms[route].append(statistics.median(r["ms"] for r in steps[1:]))
    out = {"arms": [a for a, _ in arms], "step_ms": step_ms}
    print(f"[dense] the DINO step, full depth, order {out['arms']} (route first in arms 1 and "
          f"3), medians of {STEP_TIMED} steps after {cs.WARMUP_STEPS} warm-up: {flag} "
          f"{step_ms[flag]} ms = {[round(views / ms * 1e3, 1) for ms in step_ms[flag]]} "
          f"views/s; default route {step_ms['default']} ms; on {smi}")
    # last (a profiled process launches more slowly after): kernel time by kind
    kinds = ("dense-layer kernels (hand-written)",
             "fixed-order sums of partial gradients (hand-written)")
    out["k7_ms_per_step"] = {}
    for i, (arm, csrc) in enumerate(arms[:2]):
        use(csrc)
        for route, bundle in bundles.items():
            totals = cs.profile_step(f"the step by the {route} route, {arm} kernels", bundle,
                                     batch, step_ms[route][i], smi)
            out["k7_ms_per_step"][f"{route} {arm}"] = sum(totals.get(k, 0.0) for k in kinds)
    print(f"[dense] K7's kernels and their fixed-order sums per profiled step: "
          f"{out['k7_ms_per_step']} ms; on {smi}")
    del bundles
    torch.cuda.empty_cache()
    use(NEW)
    return out


def mode_attn_block(smi: str, old: Path) -> dict:
    """K8f and K8b at ``ATTN_AB`` in the order new, old, old, new (ViT-B: new
    only): medians of 20 single calls and of 5 runs of 50 back to back,
    beside the unfused route read the same two ways, the plain version once
    and the bound from ``chip_smoke.attn_block_bound``; the new K8b must give
    the same bits in both of its arms."""
    arms = [("new", NEW), ("old", old), ("old", old), ("new", NEW)]
    for _, csrc in arms[:2]:
        use(csrc)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)
    out = {}
    for b, n, d, h, names in ATTN_AB:
        use(NEW)
        fns, unfused, plain = attn_block_operands(gen, b, n, d, h, names)
        case = f"B={b} N={n} D={d} H={h}"
        for name in names:
            cs.check_mlp(name, case, fns[name](), plain[name]())
        these = arms if d == 384 else [a for a in arms if a[0] == "new"]
        res = {name: {"single_ms": [], "b2b_ms": [], "arms": [a for a, _ in these]}
               for name in fns}
        ref = {}
        for arm, csrc in these:
            use(csrc)
            for name, fn in fns.items():
                got = [t.clone() for t in fn()]
                if arm == "new" and name.endswith("bwd"):
                    if name not in ref:
                        ref[name] = got
                    elif not all(torch.equal(a, c) for a, c in zip(got, ref[name])):
                        raise RuntimeError(f"{name}: the new kernels' bits changed between arms")
                res[name]["single_ms"].append(cs.cuda_median_ms(fn))
                res[name]["b2b_ms"].append(cs.back_to_back_ms(fn))
        use(NEW)
        for name, row in res.items():
            lib = [cs.cuda_median_ms(unfused[name]) for _ in range(2)]
            lib_b2b = [cs.back_to_back_ms(unfused[name]) for _ in range(2)]
            row.update(unfused_ms=lib, unfused_b2b_ms=lib_b2b,
                       plain_ms=cs.cuda_median_ms(plain[name], reps=5, warmup=1),
                       **cs.attn_block_bound(name.endswith("bwd"), b, n, d))
            out[f"{name} {b} {n} {d}"] = row
            print(f"[attn_block] {name} {case}, order {row['arms']}: single calls (medians of "
                  f"20) {row['single_ms']} ms; 50 back to back (medians of 5, per launch) "
                  f"{row['b2b_ms']} ms; unfused route {lib} ms, back to back {lib_b2b} ms; "
                  f"plain {row['plain_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']}; on {smi}")
        del fns, unfused, plain, ref
        torch.cuda.empty_cache()
    use(NEW)
    return out


def mode_mlp(smi: str, old: Path) -> dict:
    arms = [("new", NEW), ("old", old), ("old", old), ("new", NEW)]
    for _, csrc in arms[:2]:
        use(csrc)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)
    out = {}
    d, f = 384, 1536
    for rows, names in MLP_AB.items():
        use(NEW)
        fns, unfused, _ = mlp_operands(gen, rows, d, f, names)
        res = {name: {"single_ms": [], "b2b_ms": [], "arms": [a for a, _ in arms]}
               for name in fns}
        ref = {}
        for arm, csrc in arms:
            use(csrc)
            for name, fn in fns.items():
                got = [t.clone() for t in fn()]
                if arm == "new":
                    if name not in ref:
                        ref[name] = got
                    elif not all(torch.equal(a, b) for a, b in zip(got, ref[name])):
                        raise RuntimeError(f"{name}: the new kernels' bits changed between arms")
                res[name]["single_ms"].append(cs.cuda_median_ms(fn))
                res[name]["b2b_ms"].append(cs.back_to_back_ms(fn))
        for name, row in res.items():
            lib = [cs.cuda_median_ms(unfused[name]) for _ in range(2)]
            lib_b2b = [cs.back_to_back_ms(unfused[name]) for _ in range(2)]
            row.update(unfused_ms=lib, unfused_b2b_ms=lib_b2b,
                       **cs.mlp_bound(name.endswith("bwd"), "block" in name, rows, d, f))
            out[f"{name} {rows}"] = row
            print(f"[mlp] {name} rows={rows} D={d} F={f} tanh, order {row['arms']}: single "
                  f"calls (medians of 20) {row['single_ms']} ms; 50 back to back (medians of "
                  f"5, per launch) {row['b2b_ms']} ms; unfused route {lib} ms, back to back "
                  f"{lib_b2b} ms; bound {row['bound_ms']:.4f} ms by {row['bound_by']}; on {smi}")
        del fns, unfused, ref
        torch.cuda.empty_cache()
    use(NEW)
    return out


def mode_mlp_e2e(smi: str, old: Path) -> dict:
    arms = [("new", NEW), ("old", old), ("old", old), ("new", NEW)]
    for _, csrc in arms[:2]:
        use(csrc)
    batch = cs.train_batch()
    routes = {"use_fused_mlp": lambda depth: {"mlp_fwd": 2 * (depth - 1),
                                              "mlp_bwd": 2 * (depth - 1),
                                              "mlp_block_fwd": depth + 2, "mlp_block_bwd": 2},
              "mlp_pallas_bwd": lambda depth: {"mlp_fwd": 0, "mlp_bwd": 2 * depth,
                                               "mlp_block_fwd": 0, "mlp_block_bwd": 0}}
    out, step_ms_by = {}, {}
    for flag, counts in routes.items():
        use(NEW)
        bundle = cs.train_bundle({flag: True})
        want = counts(bundle.model.backbone.config.depth)
        views = cs.TRAIN_BATCH * (bundle.dcfg.n_global + bundle.dcfg.n_local)
        cs.run_steps(bundle, batch, cs.WARMUP_STEPS)
        step_ms = []
        for arm, csrc in arms:
            use(csrc)
            steps = cs.run_steps(bundle, batch, 1 + STEP_TIMED)
            for r in steps:
                got = {name: r["launches"][name] for name in want}
                if got != want or not np.isfinite(r["loss"]):
                    raise RuntimeError(f"the step with {flag} ({arm}): launches {got}, loss "
                                       f"{r['loss']}")
            step_ms.append(statistics.median(r["ms"] for r in steps[1:]))
        out[flag] = {"arms": [a for a, _ in arms], "step_ms": step_ms}
        step_ms_by[flag] = step_ms
        print(f"[mlp_e2e] the DINO step with {flag}, full depth, order {[a for a, _ in arms]}, "
              f"medians of {STEP_TIMED} steps after {cs.WARMUP_STEPS} warm-up: {step_ms} ms "
              f"per step = {[round(views / ms * 1e3, 1) for ms in step_ms]} views/s; on {smi}")
        del bundle
        torch.cuda.empty_cache()
    out["serving"] = mlp_serving(smi, arms)
    # last (a profiled process launches more slowly after): kernel time and busy share
    for flag in routes:
        for i, (arm, csrc) in enumerate(arms[:2]):
            use(csrc)
            bundle = cs.train_bundle({flag: True})
            cs.run_steps(bundle, batch, cs.WARMUP_STEPS)
            cs.profile_step(f"the step with {flag}, {arm} kernels", bundle, batch,
                            step_ms_by[flag][i], smi)
            del bundle
            torch.cuda.empty_cache()
    use(NEW)
    return out


def mlp_serving(smi: str, arms) -> dict:
    """Serving at 256 px with ``use_fused_mlp`` (K6f in every block) and by the
    default route, each once in every arm: tiles/s of ``extract_features``
    over ``SERVE_CHUNKS`` chunks of 500 tiles, launch counts checked."""
    dev = torch.device("cuda")
    models = {"use_fused_mlp": create_model(cs.MODEL, num_classes=2, img_size=cs.TILE,
                                            use_fused_mlp=True),
              "default": create_model(cs.MODEL, num_classes=2, img_size=cs.TILE)}
    depth = models["default"].config.depth
    params = params_from_flax(cs.flax_vit_tree(models["default"].config, cs.SEED))
    valid = [cs.TILES_PER_ITER] * SERVE_CHUNKS
    chunks = cs.make_chunks(cs.SEED, valid, cs.TILES_PER_ITER, cs.TILE)
    want = {"use_fused_mlp": {"mha_qkv_fwd": depth * len(chunks),
                              "mlp_block_fwd": depth * len(chunks)},
            "default": {"mha_qkv_fwd": depth * len(chunks), "mlp_block_fwd": 0}}
    out_dir = cs.OUT / "ab_serve"
    res = {"arms": [a for a, _ in arms], **{route: [] for route in models}}
    for i, (arm, csrc) in enumerate(arms):
        use(csrc)
        for route, model in models.items():
            extract_features(chunks[:1], model, params, str(out_dir / "warmup"), dev)
            cs.reset_launches()
            _, secs = cs.timed_extract(chunks, model, params, out_dir / f"{i}_{arm}_{route}", dev)
            got = {name: cs.all_launches()[name] for name in want[route]}
            if got != want[route]:
                raise RuntimeError(f"256-px serving, {route} ({arm}): launches {got}")
            res[route].append(sum(valid) / secs)
    print(f"[mlp_e2e] serving at 256 px, {SERVE_CHUNKS} chunks x {cs.TILES_PER_ITER} tiles "
          f"through extract_features, order {res['arms']}: use_fused_mlp "
          f"{[round(x, 1) for x in res['use_fused_mlp']]} tiles/s, default route "
          f"{[round(x, 1) for x in res['default']]} tiles/s; on {smi}")
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
            if any(r["launches"][name] != depth for name in cs.FLASH_NAMES):
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
    only = cuts = None
    base = NEW
    if "--base" in args:
        i = args.index("--base")
        base = Path(args[i + 1])
        del args[i:i + 2]
    if "--only" in args:
        i = args.index("--only")
        only = args[i + 1]
        del args[i:i + 2]
    if "--cuts" in args:
        i = args.index("--cuts")
        cuts = set(args[i + 1].split(","))
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
        elif mode == "bwd":
            summary["bwd"] = mode_bwd(smi, old)
        elif mode == "e2e":
            summary["e2e"] = mode_e2e(smi, old)
        elif mode == "ablate":
            summary["ablate"] = mode_ablate(smi, variants)
        elif mode == "mha_bwd":
            summary["mha_bwd"] = mode_mha_bwd(smi, old)
        elif mode == "cutout":
            summary["cutout"] = mode_cutout(smi, only, cuts, base)
        elif mode == "mlp":
            summary["mlp"] = mode_mlp(smi, old)
        elif mode == "mlp_e2e":
            summary["mlp_e2e"] = mode_mlp_e2e(smi, old)
        elif mode == "attn_block":
            summary["attn_block"] = mode_attn_block(smi, old)
        elif mode == "dense":
            summary["dense"] = mode_dense(smi, old)
        else:
            raise SystemExit(f"unknown mode {mode!r}: check, ab, bwd, e2e, mha_bwd, mlp, "
                             "mlp_e2e, attn_block, dense, ablate, cutout")
    print(f"[ab] done in {time.perf_counter() - t0:.1f} s; on {smi}")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
