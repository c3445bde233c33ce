"""ctypes bindings of the native host library (counterpart of
ibgs_tpu/utils/native.py).

`native/ibgs_native.cpp` is compiled with `g++` and the flags of
`native/Makefile` into `build/ibgs_tpu_torch/` at the repository root, at
first use.  The library name carries a hash of the source, the flags and
the host CPU (the flags include -march=native), so an edited source or
another host gets its own build.  There is no fallback: a failed build, or
a library of another ABI, raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "ibgs_native.cpp"
BUILD_DIR = _ROOT / "build" / "ibgs_tpu_torch"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
             "-shared"]
ABI = 2

_lock = threading.Lock()
_lib = None


def _host_cpu() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"model name"):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                       + _host_cpu()).hexdigest()[:16]
    return BUILD_DIR / f"libibgs_native_{h}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native library: cannot run {cxx}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native library: {cxx} failed for {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.ibgs_native_abi.restype = ctypes.c_int64
            abi = lib.ibgs_native_abi()
            if abi != ABI:
                raise RuntimeError(f"native library: ABI {abi}, expected "
                                   f"{ABI} ({_lib_path()})")
            lib.knn_mean_sq_dist_3.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float)]
            lib.knn_mean_sq_dist_3.restype = None
            lib.parse_colmap_points3d.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64)]
            lib.parse_colmap_points3d.restype = ctypes.c_int64
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here (it is built on the first
    call).  Use `load` where the caller needs it: that raises with the
    compiler's output."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def knn_mean_sq_dist_3(points: np.ndarray) -> np.ndarray:
    """(N, 3) float32 → (N,) mean squared distance to the 3 nearest
    neighbours (exact; Morton order and box culling on the host)."""
    lib = load()
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty(len(pts), np.float32)
    lib.knn_mean_sq_dist_3(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def parse_colmap_points3d(path: str):
    """points3D.bin → (xyz f64 (N, 3), rgb u8 (N, 3), err f64 (N,),
    track_len i64 (N,)), or None when the file is truncated or corrupt."""
    lib = load()
    blob = np.fromfile(path, np.uint8)
    if blob.size < 8:
        return None
    count = int.from_bytes(blob[:8].tobytes(), "little")
    xyz = np.empty((count, 3), np.float64)
    rgb = np.empty((count, 3), np.uint8)
    err = np.empty((count,), np.float64)
    tlen = np.empty((count,), np.int64)
    got = lib.parse_colmap_points3d(
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(blob),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        tlen.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if got != count:
        return None
    return xyz, rgb, err, tlen
