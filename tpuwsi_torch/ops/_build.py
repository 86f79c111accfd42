"""Build the port's CUDA kernels with nvcc on first use and load them with ctypes.

Every ``tpuwsi_torch/ops/csrc/*.cu`` source is compiled for Hopper
(``sm_90a``), one nvcc process per source and all at once, and the objects
are linked into one shared library with a plain C interface, so no PyTorch
header is compiled. The library goes to ``build/tpuwsi_torch/`` at the
repository root, keyed by a hash of the sources, the ``*.cuh`` headers they
share and the flags: a changed file builds anew, unchanged ones load the
library already there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuwsi_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # per-kernel registers, shared memory and spills into the build log
    "-Xptxas", "-v",
)

_lib = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    """nvcc of $CUDA_HOME or $CUDA_PATH, else on $PATH, else the toolkit's
    default install prefix."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            return os.path.join(os.environ[var], "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):  # headers the sources include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpuwsi_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; return its path.

    Raises RuntimeError with nvcc's output when the compiler fails. The
    compiler's report (``-Xptxas -v``) is kept beside the library as
    ``<library>.log``, each source's part under a line ``== <source>``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    tmp = BUILD_DIR / f"{tag}.tmp"
    cmds.append([_nvcc(), "-shared", "-o", str(tmp), *map(str, objects)])
    log = []
    try:
        for i, cmd in enumerate(cmds):
            if i < len(procs):
                stdout, stderr = procs[i].communicate()
                code = procs[i].returncode
            else:
                link = subprocess.run(cmd, capture_output=True, text=True)
                stdout, stderr, code = link.stdout, link.stderr, link.returncode
            if code != 0:
                raise RuntimeError(
                    f"nvcc failed ({code}): {' '.join(cmd)}\n{stderr}{stdout}")
            log.append(f"== {Path(cmd[-1]).name}\n{stderr}{stdout}")
        out.with_suffix(".log").write_text("".join(log))
        os.replace(tmp, out)  # atomic: a process loading concurrently sees a whole file
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load the library once, and declare its C functions."""
    global _lib
    if _lib is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tpuwsi_mha_qkv_fwd.argtypes = [
            ptr, ptr, i32, i32, i32, f32, i32, ptr]
        lib.tpuwsi_mha_qkv_fwd_saved.argtypes = [
            ptr, ptr, ptr, i32, i32, i32, i32, f32, i32, ptr]
        lib.tpuwsi_mha_qkv_bwd_saved.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, ptr]
        lib.tpuwsi_mha_qkv_bwd.argtypes = [
            ptr, ptr, ptr, i32, i32, i32, f32, i32, ptr]
        # flash family: tensors, then batch, heads, sq, sk, a host array of
        # element strides, the scale and the stream
        tail = [i32, i32, i32, i32, ctypes.POINTER(ctypes.c_longlong), f32, ptr]
        lib.tpuwsi_flash_fwd.argtypes = [ptr] * 5 + tail
        lib.tpuwsi_flash_fwd_stats.argtypes = [ptr] * 6 + tail
        lib.tpuwsi_flash_bwd_dq.argtypes = [ptr] * 7 + tail
        lib.tpuwsi_flash_bwd_dkv.argtypes = [ptr] * 8 + tail
        # fused MLP: tensors, then rows, d, f (, row tiles, row groups) (, eps),
        # the GELU form and the stream
        lib.tpuwsi_mlp_fwd.argtypes = [ptr] * 6 + [i32, i32, i32, i32, ptr]
        lib.tpuwsi_mlp_block_fwd.argtypes = [ptr] * 8 + [i32, i32, i32, f32, i32, ptr]
        lib.tpuwsi_mlp_bwd.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
        lib.tpuwsi_mlp_block_bwd.argtypes = [ptr] * 12 + [i32] * 5 + [f32, i32, ptr]
        lib.tpuwsi_mlp_rows_per_tile.argtypes = [i32]
        lib.tpuwsi_mlp_hidden_per_slice.argtypes = [i32]
        # dense layers: tensors, then rows and the two widths (, row groups)
        # (, eps) (, the weight's layout) and the stream
        lib.tpuwsi_dense_bwd.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.tpuwsi_gemm_res_bwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        lib.tpuwsi_ln_gemm_fwd.argtypes = [ptr] * 6 + [i32, i32, i32, f32, i32, ptr]
        lib.tpuwsi_ln_gemm_bwd.argtypes = [ptr] * 10 + [i32] * 4 + [f32, i32, ptr]
        lib.tpuwsi_gemm_res_fwd.argtypes = [ptr] * 5 + [i32, i32, i32, ptr]
        lib.tpuwsi_dense_rows_per_step.argtypes = [i32]
        lib.tpuwsi_dense_cols_per_slice.argtypes = [i32]
        # attention sub-block: tensors, then batch, tokens, width, heads
        # (, the two numbers of row groups), scale, eps and the stream
        lib.tpuwsi_attn_block_fwd.argtypes = [ptr] * 9 + [i32] * 4 + [f32, f32, ptr]
        lib.tpuwsi_attn_block_bwd.argtypes = [ptr] * 16 + [i32] * 6 + [f32, f32, ptr]
        lib.tpuwsi_attn_block_max_seq.argtypes = [i32]
        lib.tpuwsi_attn_block_max_clusters.argtypes = [i32, i32]
        for fn in (lib.tpuwsi_mha_qkv_fwd, lib.tpuwsi_mha_qkv_fwd_saved,
                   lib.tpuwsi_mha_qkv_bwd_saved, lib.tpuwsi_mha_qkv_bwd,
                   lib.tpuwsi_flash_fwd, lib.tpuwsi_flash_fwd_stats,
                   lib.tpuwsi_flash_bwd_dq, lib.tpuwsi_flash_bwd_dkv,
                   lib.tpuwsi_mlp_fwd, lib.tpuwsi_mlp_block_fwd, lib.tpuwsi_mlp_bwd,
                   lib.tpuwsi_mlp_block_bwd, lib.tpuwsi_mlp_rows_per_tile,
                   lib.tpuwsi_mlp_hidden_per_slice, lib.tpuwsi_dense_bwd,
                   lib.tpuwsi_gemm_res_bwd, lib.tpuwsi_ln_gemm_fwd, lib.tpuwsi_ln_gemm_bwd,
                   lib.tpuwsi_gemm_res_fwd, lib.tpuwsi_dense_rows_per_step,
                   lib.tpuwsi_dense_cols_per_slice, lib.tpuwsi_attn_block_fwd,
                   lib.tpuwsi_attn_block_bwd, lib.tpuwsi_attn_block_max_seq,
                   lib.tpuwsi_attn_block_max_clusters):
            fn.restype = i32
        lib.tpuwsi_cuda_error_string.argtypes = [i32]
        lib.tpuwsi_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, like, args) -> None:
    """Call C function ``tpuwsi_<name>`` with ``args`` and the current stream
    of the CUDA device that tensor ``like`` lies on; raise on a CUDA error."""
    import torch

    lib = load()
    with torch.cuda.device(like.device):
        err = getattr(lib, f"tpuwsi_{name}")(*args, torch.cuda.current_stream().cuda_stream)
    check(lib, err, f"{name} launch")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib.tpuwsi_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
