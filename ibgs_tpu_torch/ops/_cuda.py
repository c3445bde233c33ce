"""Build and bind the port's CUDA kernels.

Each `csrc/*.cu` source has a plain C interface.  At first use it is
compiled by `nvcc` for sm_90a into a shared library under
`build/ibgs_tpu_torch/` at the repository root and loaded with ctypes.  The
library name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  All sources are compiled
in parallel, one `nvcc` process each.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ibgs_tpu_torch"
SOURCES = {"blend_fwd": CSRC / "blend_fwd.cu",
           "blend_bwd": CSRC / "blend_bwd.cu"}
# --fmad=false: no multiply-add contraction, so float ops round one by one
# as the plain PyTorch versions' ops do (see the notes in the sources).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ibgs_blend_fwd": (
        [_c_ptr, _c_int, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int,
         _c_float, _c_float, _c_float, _c_float, _c_float, _c_int, _c_int,
         _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr],
        _c_int),
    "ibgs_blend_bwd": (
        [_c_ptr, _c_int, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int,
         _c_float, _c_float, _c_float, _c_float, _c_float, _c_int, _c_int]
        + [_c_ptr] * 13, _c_int),
    "ibgs_cuda_error_string": ([_c_int], ctypes.c_char_p),
}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) that are not built yet, in
    parallel.  Returns {name: ptxas log text} for every named source (the
    log saved beside a library built earlier).  Raises on a failed build."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _lib_path(name).with_suffix(".log").read_text()
            for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (argtypes, restype) in _SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs[name]


def error_string(err: int) -> str:
    return load("blend_fwd").ibgs_cuda_error_string(err).decode()


def blend_fwd(feats, tile_start, tile_stop, tiles_x, tiles_y, tile_h,
              tile_w, fx, fy, cx, cy, row0, buffer_len, mode, out,
              stream) -> int:
    """Launch ibgs_blend_fwd; `out` is a BlendOutputs of allocated tensors.
    Returns the CUDA error code of the launch (0 = success)."""
    return load("blend_fwd").ibgs_blend_fwd(
        feats.data_ptr(), feats.shape[1], tile_start.data_ptr(),
        tile_stop.data_ptr(), tiles_x, tiles_y, tile_h, tile_w,
        fx, fy, cx, cy, row0, buffer_len, mode,
        out.color.data_ptr(), out.normal.data_ptr(), out.final_t.data_ptr(),
        out.n_contrib.data_ptr(), out.buf_depth.data_ptr(),
        out.buf_weight.data_ptr(), out.buf_contrib.data_ptr(), stream)


def blend_bwd(feats, tile_start, tile_stop, tiles_x, tiles_y, tile_h,
              tile_w, fx, fy, cx, cy, row0, buffer_len, mode, saved, cts,
              out, stream) -> int:
    """Launch ibgs_blend_bwd.  `saved` is the 7 forward outputs (colour,
    normal, T, n_contrib, buf depth, buf weight, buf contrib) and `cts` the
    5 cotangents (dcolor, dnormal, dT, dbuf_depth, dbuf_weight), all
    contiguous; `out` is the zeroed (n, 16) gradient table.  Returns the
    CUDA error code of the launch (0 = success)."""
    color, normal, final_t, n_contrib, _bd, buf_weight, buf_contrib = saved
    return load("blend_bwd").ibgs_blend_bwd(
        feats.data_ptr(), feats.shape[1], tile_start.data_ptr(),
        tile_stop.data_ptr(), tiles_x, tiles_y, tile_h, tile_w,
        fx, fy, cx, cy, row0, buffer_len, mode,
        color.data_ptr(), normal.data_ptr(), final_t.data_ptr(),
        n_contrib.data_ptr(), buf_weight.data_ptr(), buf_contrib.data_ptr(),
        *(c.data_ptr() for c in cts), out.data_ptr(), stream)
