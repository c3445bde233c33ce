"""Build and bind the port's CUDA kernels.

Each `csrc/*.cu` source has a plain C interface.  At first use it is
compiled by `nvcc` for sm_90a into a shared library under
`build/ibgs_tpu_torch/` at the repository root and loaded with ctypes.  The
library name carries a hash of the source, the shared headers of `csrc/`
and the flags, so an edited source is rebuilt and an unchanged one is
reused.  All sources are compiled in parallel, one `nvcc` process each.
Nothing here runs at import.

Every kernel launch of the port goes through one wrapper here, which takes
the current stream of its tensors' device, calls the C entry, raises a
RuntimeError with the CUDA error string on a failed launch and counts the
launches in LAUNCHES; `kernel_info` reads a kernel's registers, spills
and occupancy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ibgs_tpu_torch"
SOURCES = {"blend_fwd": CSRC / "blend_fwd.cu",
           "blend_bwd": CSRC / "blend_bwd.cu",
           "warp": CSRC / "warp.cu",
           "preprocess": CSRC / "preprocess.cu",
           "binning": CSRC / "binning.cu",
           "ssim": CSRC / "ssim.cu",
           "optim": CSRC / "optim.cu"}
HEADERS = (CSRC / "blend_common.cuh",)
# --fmad=false: no multiply-add contraction, so float ops round one by one
# as the plain PyTorch versions' ops do (see the notes in the sources).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
# launches of each kernel, counted by the launch wrappers below (bin_radix
# once a sort pass: 4 for the depth order, 1-4 for the tile ids)
LAUNCHES = dict.fromkeys(
    ("blend_fwd", "blend_bwd", "rgb10_pack", "warp_fwd", "warp_bwd",
     "preprocess_fwd", "preprocess_bwd", "bin_key", "bin_radix", "bin_count",
     "bin_emit", "bin_ranges", "ssim_fwd", "ssim_bwd", "optim"), 0)

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_c_ll = ctypes.c_longlong
# feats, stride, tile_start, tile_stop, tiles_x, tiles_y, tile_h, tile_w,
# splits_y, splits_x, fx, fy, cx, cy, row0, buffer_len, mode
_HEAD = ([_c_ptr, _c_int, _c_ptr, _c_ptr] + [_c_int] * 6 + [_c_float] * 5
         + [_c_int, _c_int])
_SIGNATURES = {
    # + 7 outputs, the order scratch, the stream
    "ibgs_blend_fwd": (_HEAD + [_c_ptr] * 9, _c_int),
    # + 6 saved outputs, 5 cotangents, out, scratch, n_rows, workspace,
    # the stream
    "ibgs_blend_bwd": (_HEAD + [_c_ptr] * 13 + [_c_int, _c_ptr, _c_ptr],
                       _c_int),
    "ibgs_blend_fwd_occupancy": ([_c_int] * 4 + [ctypes.POINTER(_c_int)] * 2,
                                 _c_int),
    "ibgs_blend_bwd_occupancy": ([_c_int] * 4 + [ctypes.POINTER(_c_int)] * 2,
                                 _c_int),
    # images, S, Hs, Ws, out, the stream
    "ibgs_rgb10_pack": ([_c_ptr] + [_c_int] * 3 + [_c_ptr] * 2, _c_int),
    # bd, bw, row stride, tables, r2s, pdx, pdy, median, depths, B, H, W, S,
    # Hs, Ws, fx, fy, cx, cy, wsc, ws, wdepth, depth_err, the stream
    "ibgs_warp_fwd": ([_c_ptr, _c_ptr, _c_ll] + [_c_ptr] * 6 + [_c_int] * 6
                      + [_c_float] * 4 + [_c_ptr] * 5, _c_int),
    # bd, bw, row stride, tables, r2s, pdx, pdy, g_wsc, g_wsum, B, H, W, S,
    # Hs, Ws, fx, fy, cx, cy, dbd, dbw, the stream
    "ibgs_warp_bwd": ([_c_ptr, _c_ptr, _c_ll] + [_c_ptr] * 6 + [_c_int] * 6
                      + [_c_float] * 4 + [_c_ptr] * 3, _c_int),
    "ibgs_warp_info": ([_c_int] * 3 + [ctypes.POINTER(_c_int)], _c_int),
    # xyz, scale, quat, opacity, sh, normal, offset, alive, P, K, active,
    # view, full_proj, cam_pos, fx, fy, lim_x, lim_y, width, height, tile_h,
    # tile_w, the 10 outputs, the stream
    "ibgs_preprocess_fwd": ([_c_ptr] * 8 + [_c_ll, _c_int, _c_int]
                            + [_c_ptr] * 3 + [_c_float] * 4 + [_c_int] * 4
                            + [_c_ptr] * 11, _c_int),
    # xyz, scale, quat, sh, normal, offset, P, K, active, view, full_proj,
    # cam_pos, fx, fy, lim_x, lim_y, width, height, the 5 cotangents, their
    # 10 strides, the 6 gradients, the stream
    "ibgs_preprocess_bwd": ([_c_ptr] * 6 + [_c_ll, _c_int, _c_int]
                            + [_c_ptr] * 3 + [_c_float] * 4 + [_c_int] * 2
                            + [ctypes.POINTER(_c_ptr), ctypes.POINTER(_c_ll)]
                            + [_c_ptr] * 7, _c_int),
    "ibgs_preprocess_info": ([_c_int] * 2 + [ctypes.POINTER(_c_int)], _c_int),
    # depth, n_tiles, P, workspace, keys a, b, values a, b, order, stream
    "ibgs_bin_order": ([_c_ptr, _c_ptr, _c_ll] + [_c_ptr] * 7, _c_int),
    # order, n_tiles, rect_min, rect_max, cull, P, tiles_x, tiles_y,
    # tile_h, tile_w, row_cap, workspace, seg_off, kept, the stream
    "ibgs_bin_count": ([_c_ptr] * 5 + [_c_ll] + [_c_int] * 4 + [_c_ll]
                       + [_c_ptr] * 4, _c_int),
    # order, n_tiles, rect_min, rect_max, cull, P, tiles_x, tiles_y,
    # tile_h, tile_w, seg_off, kept, n, tile, rank, workspace, the tile
    # sort's state, the stream
    "ibgs_bin_emit": ([_c_ptr] * 5 + [_c_ll] + [_c_int] * 4 + [_c_ptr] * 2
                      + [_c_ll] + [_c_ptr] * 5, _c_int),
    # n, num_tiles, P, workspace, state, keys a, b, values a, b,
    # tile_sorted, slot, the stream
    "ibgs_bin_tiles": ([_c_ll, _c_int, _c_ll] + [_c_ptr] * 9, _c_int),
    # tile_sorted, perm, slot_rank, order, n, num_tiles, rank, gauss_id,
    # tile_id, valid, start, the stream
    "ibgs_bin_ranges": ([_c_ptr] * 4 + [_c_ll, _c_int] + [_c_ptr] * 6,
                        _c_int),
    "ibgs_bin_workspace_words": ([_c_ll], _c_ll),
    "ibgs_bin_tile_passes": ([_c_int], _c_int),
    "ibgs_bin_tile_state_words": ([_c_ll, _c_int], _c_ll),
    "ibgs_binning_info": ([_c_int, ctypes.POINTER(_c_int)], _c_int),
    # x, x batch stride, y, y batch stride, B, H, W, C, the window, c1, c2,
    # out, the moments, the stream
    "ibgs_ssim_fwd": ([_c_ptr, _c_ll, _c_ptr, _c_ll] + [_c_int] * 4
                      + [_c_ptr, _c_float, _c_float] + [_c_ptr] * 3, _c_int),
    # x, x batch stride, y, y batch stride, B, H, W, C, the window, c1, c2,
    # g, its 4 strides, the moments, x's 3 gradient terms, y's, the stream
    "ibgs_ssim_bwd": ([_c_ptr, _c_ll, _c_ptr, _c_ll] + [_c_int] * 4
                      + [_c_ptr, _c_float, _c_float, _c_ptr] + [_c_ll] * 4
                      + [_c_ptr] * 8, _c_int),
    "ibgs_ssim_info": ([_c_int, ctypes.POINTER(_c_int)], _c_int),
    # the table (OptimTable, copied into the kernel's parameter), the
    # stream
    "ibgs_optim": ([_c_ptr, _c_ptr], _c_int),
    "ibgs_optim_layout": ([ctypes.POINTER(_c_ll)], _c_int),
    "ibgs_optim_info": ([_c_int, ctypes.POINTER(_c_int)], _c_int),
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
    h = hashlib.sha256(b"".join(f.read_bytes()
                                for f in (SOURCES[name], *HEADERS))
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


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {error_string(err)} ({err})")


def _launch(counts: dict, device, entry, *args) -> None:
    """Call the C entry `entry` with `args` and the current stream of
    `device`, with `device` current; raise a RuntimeError on a failed
    launch, else add `counts` ({kernel: launches}) to LAUNCHES."""
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        _check(err, " / ".join(counts) + " kernel launch")
    for name, k in counts.items():
        LAUNCHES[name] += k


def _ptr(t):
    return None if t is None else t.data_ptr()


def blend_fwd(feats, tile_start, tile_stop, tiles_x, tiles_y, tile_h,
              tile_w, splits, fx, fy, cx, cy, row0, buffer_len, mode, out,
              order) -> None:
    """Launch ibgs_blend_fwd (the tile-order pre-pass and the blend);
    `out` is a BlendOutputs of allocated tensors, `splits` the tile's
    (splits_y, splits_x) sub-tiles and `order` int32 scratch of one entry
    per tile."""
    _launch({"blend_fwd": 1}, feats.device, load("blend_fwd").ibgs_blend_fwd,
            feats.data_ptr(), feats.shape[1], tile_start.data_ptr(),
            tile_stop.data_ptr(), tiles_x, tiles_y, tile_h, tile_w, *splits,
            fx, fy, cx, cy, row0, buffer_len, mode,
            out.color.data_ptr(), out.normal.data_ptr(),
            out.final_t.data_ptr(), out.n_contrib.data_ptr(),
            out.buf_depth.data_ptr(), out.buf_weight.data_ptr(),
            out.buf_contrib.data_ptr(), order.data_ptr())


def blend_bwd(feats, tile_start, tile_stop, tiles_x, tiles_y, tile_h,
              tile_w, splits, fx, fy, cx, cy, row0, buffer_len, mode, saved,
              cts, out, scratch, workspace) -> None:
    """Launch ibgs_blend_bwd (the tile-order pre-pass and the backward).
    `saved` is the 7 forward outputs (colour, normal, T, n_contrib, buf
    depth, buf weight, buf contrib) and `cts` the 5 cotangents (dcolor,
    dnormal, dT, dbuf_depth, dbuf_weight), all contiguous; `out` is the
    zeroed (n, 16) gradient table, `scratch` a (splits, n, 16) float32
    table or None for a tile of one sub-tile, `workspace` int32 scratch of
    num_tiles * (2 + splits) entries."""
    color, normal, final_t, n_contrib, _bd, buf_weight, buf_contrib = saved
    _launch({"blend_bwd": 1}, feats.device, load("blend_bwd").ibgs_blend_bwd,
            feats.data_ptr(), feats.shape[1], tile_start.data_ptr(),
            tile_stop.data_ptr(), tiles_x, tiles_y, tile_h, tile_w, *splits,
            fx, fy, cx, cy, row0, buffer_len, mode,
            color.data_ptr(), normal.data_ptr(), final_t.data_ptr(),
            n_contrib.data_ptr(), buf_weight.data_ptr(),
            buf_contrib.data_ptr(), *(c.data_ptr() for c in cts),
            out.data_ptr(), _ptr(scratch), feats.shape[0],
            workspace.data_ptr())


def rgb10_pack(images, out, source="warp") -> None:
    """Launch ibgs_rgb10_pack: images (S, Hs, Ws, 3) contiguous float32 into
    `out`, (S, Hs, Ws, 4) int32 footprint rows.  `source`: the library
    (a name in SOURCES)."""
    S, Hs, Ws = images.shape[:3]
    _launch({"rgb10_pack": 1}, images.device, load(source).ibgs_rgb10_pack,
            images.data_ptr(), S, Hs, Ws, out.data_ptr())


def warp_fwd(bd, bw, row_stride, tables, r2s, pdx, pdy, median, depths,
             intr, outs, source="warp") -> None:
    """Launch ibgs_warp_fwd: bd, bw (B, H, W) views of (H, W, B) buffers of
    `row_stride` floats per row, tables (S, Hs, Ws, 4) int32 footprint
    rows, r2s (S, 4, 4), pdx, pdy, median (H, W), depths (S, Hs, Ws),
    contiguous, `intr` (fx, fy, cx, cy); writes `outs` = (wsc (S, H, W,
    3), ws, wdepth, depth_err (S, H, W))."""
    B, H, W = bd.shape
    S, Hs, Ws = tables.shape[:3]
    _launch({"warp_fwd": 1}, bd.device, load(source).ibgs_warp_fwd,
            bd.data_ptr(), bw.data_ptr(), row_stride, tables.data_ptr(),
            r2s.data_ptr(), pdx.data_ptr(), pdy.data_ptr(),
            median.data_ptr(), depths.data_ptr(), B, H, W, S, Hs, Ws, *intr,
            *(t.data_ptr() for t in outs))


def warp_bwd(bd, bw, row_stride, tables, r2s, pdx, pdy, intr, g_wsc, g_wsum,
             dbd, dbw, source="warp") -> None:
    """Launch ibgs_warp_bwd: the forward's buffers, tables, transforms and
    rays and the contiguous cotangents g_wsc (S, H, W, 3), g_wsum (S, H,
    W); writes dbd, dbw, contiguous (H, W, B)."""
    B, H, W = bd.shape
    S, Hs, Ws = tables.shape[:3]
    _launch({"warp_bwd": 1}, bd.device, load(source).ibgs_warp_bwd,
            bd.data_ptr(), bw.data_ptr(), row_stride, tables.data_ptr(),
            r2s.data_ptr(), pdx.data_ptr(), pdy.data_ptr(),
            g_wsc.data_ptr(), g_wsum.data_ptr(), B, H, W, S, Hs, Ws, *intr,
            dbd.data_ptr(), dbw.data_ptr())


def occupancy(name: str, mode: int, buffer_len: int, sub_h: int,
              sub_w: int) -> tuple:
    """(CTAs one SM holds at once, threads per CTA) of kernel `name`
    ("blend_fwd" or "blend_bwd") in `mode` at `buffer_len` for a sub_h x
    sub_w sub-tile (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks, threads = _c_int(0), _c_int(0)
    _check(getattr(load(name), f"ibgs_{name}_occupancy")(
        mode, buffer_len, sub_h, sub_w, ctypes.byref(blocks),
        ctypes.byref(threads)), f"{name} occupancy query")
    return blocks.value, threads.value


def preprocess_fwd(xyz, scale, quat, opacity, sh, normal, offset, alive,
                   active, cam, lims, tile_h, tile_w, outs) -> None:
    """Launch ibgs_preprocess_fwd: contiguous float32 inputs (sh (P, K, 3)
    or None for no colour, alive (P,) bool or None), the camera's
    matrices and centre, `lims` the frustum limits; writes the 10 tensors
    of `outs` (rgb not when sh is None)."""
    _launch({"preprocess_fwd": 1}, xyz.device,
            load("preprocess").ibgs_preprocess_fwd,
            xyz.data_ptr(), scale.data_ptr(), quat.data_ptr(),
            opacity.data_ptr(), _ptr(sh), normal.data_ptr(),
            offset.data_ptr(), _ptr(alive), xyz.shape[0],
            0 if sh is None else sh.shape[1], active, cam.view.data_ptr(),
            cam.full_proj.data_ptr(), cam.cam_pos.data_ptr(), cam.fx,
            cam.fy, *lims, cam.width, cam.height, tile_h, tile_w,
            *(t.data_ptr() if t.numel() else None for t in outs))


def preprocess_bwd(xyz, scale, quat, sh, normal, offset, active, cam, lims,
                   cts, grads) -> None:
    """Launch ibgs_preprocess_bwd: the forward's float inputs and camera,
    `cts` the 5 cotangents (None = 0; read through their strides), writing
    the 6 contiguous `grads` (sh's None when sh is None)."""
    ptrs = (_c_ptr * 5)(*(_ptr(c) for c in cts))
    strides = (_c_ll * 10)(*(v for c in cts for v in (
        (0, 0) if c is None else
        (c.stride(0), c.stride(1) if c.dim() > 1 else 0))))
    _launch({"preprocess_bwd": 1}, xyz.device,
            load("preprocess").ibgs_preprocess_bwd,
            xyz.data_ptr(), scale.data_ptr(), quat.data_ptr(), _ptr(sh),
            normal.data_ptr(), offset.data_ptr(), xyz.shape[0],
            0 if sh is None else sh.shape[1], active, cam.view.data_ptr(),
            cam.full_proj.data_ptr(), cam.cam_pos.data_ptr(), cam.fx,
            cam.fy, *lims, cam.width, cam.height, ptrs, strides,
            *(_ptr(g) for g in grads))


BIN_KERNELS = ("bin_key", "bin_radix", "bin_count", "bin_emit", "bin_ranges")


def bin_workspace_words(P: int) -> int:
    """64-bit words of the binning workspace for P Gaussians."""
    return load("binning").ibgs_bin_workspace_words(P)


def bin_tile_passes(num_tiles: int) -> int:
    """Radix passes of the tile sort on a grid of num_tiles tiles."""
    return load("binning").ibgs_bin_tile_passes(num_tiles)


def bin_tile_state_words(n: int, num_tiles: int) -> int:
    """64-bit words of the tile sort's state for n instances."""
    return load("binning").ibgs_bin_tile_state_words(n, num_tiles)


def bin_order(depth, n_tiles, ws, scratch, order) -> None:
    """Launch ibgs_bin_order: depth (P,) float32, n_tiles (P,) int32, ws
    the zeroed workspace → bin_key and the depth sort's 4 passes, order
    (P,) int64; `scratch` = keys a, b and values a, b, (P,) int32 each."""
    _launch({"bin_key": 1, "bin_radix": 4}, depth.device,
            load("binning").ibgs_bin_order,
            depth.data_ptr(), n_tiles.data_ptr(), depth.shape[0],
            ws.data_ptr(), *(t.data_ptr() for t in scratch),
            order.data_ptr())


def bin_count(order, sp, cull_tab, grid, row_cap, ws, seg_off,
              kept) -> None:
    """Launch ibgs_bin_count: the depth order (P,) int64, the Splats2D
    `sp`'s n_tiles, rect_min, rect_max (int32, contiguous), cull_tab (P,
    6) float32, `grid` = (tiles_x, tiles_y, tile_h, tile_w) → seg_off (P +
    1,) int64, kept rows (P,) int32, and ws[0:3] = rows, instances, the
    out-of-grid flag."""
    _launch({"bin_count": 1}, order.device, load("binning").ibgs_bin_count,
            order.data_ptr(), sp.n_tiles.data_ptr(), sp.rect_min.data_ptr(),
            sp.rect_max.data_ptr(), cull_tab.data_ptr(), order.shape[0],
            *grid, row_cap, ws.data_ptr(), seg_off.data_ptr(),
            kept.data_ptr())


def bin_emit(order, sp, cull_tab, grid, seg_off, kept, tile, rank, ws,
             state) -> None:
    """Launch ibgs_bin_emit: bin_count's inputs and outputs → the n =
    len(tile) kept slots' tile ids and depth ranks, (n,) int32 each, and
    their digit counts in ws; zeroes `state` (the tile sort's)."""
    _launch({"bin_emit": 1}, order.device, load("binning").ibgs_bin_emit,
            order.data_ptr(), sp.n_tiles.data_ptr(), sp.rect_min.data_ptr(),
            sp.rect_max.data_ptr(), cull_tab.data_ptr(), order.shape[0],
            *grid, seg_off.data_ptr(), kept.data_ptr(), tile.shape[0],
            tile.data_ptr(), rank.data_ptr(), ws.data_ptr(),
            state.data_ptr())


def bin_tiles(tile, num_tiles, P, ws, state, scratch, tile_sorted,
              slot) -> None:
    """Launch ibgs_bin_tiles, the tile sort's passes (one bin_radix
    launch each): bin_emit's (n,) tile ids → tile_sorted (n,) int32 and
    slot (n,) int64; `scratch` = keys b, values a, b, (n,) int32 each."""
    _launch({"bin_radix": bin_tile_passes(num_tiles)}, tile.device,
            load("binning").ibgs_bin_tiles,
            tile.shape[0], num_tiles, P, ws.data_ptr(), state.data_ptr(),
            tile.data_ptr(), *(t.data_ptr() for t in scratch),
            tile_sorted.data_ptr(), slot.data_ptr())


def bin_ranges(tile_sorted, perm, slot_rank, order, num_tiles,
               outs) -> None:
    """Launch ibgs_bin_ranges: the tile sort's (n,) keys and int64
    permutation, bin_emit's ranks, the depth order → `outs` = rank,
    gauss_id, tile_id (n,) int64, inst_valid (n,) bool, start (num_tiles +
    1,) int32."""
    _launch({"bin_ranges": 1}, order.device, load("binning").ibgs_bin_ranges,
            tile_sorted.data_ptr(), perm.data_ptr(), slot_rank.data_ptr(),
            order.data_ptr(), tile_sorted.shape[0], num_tiles,
            *(t.data_ptr() for t in outs))


def ssim_window(weights) -> ctypes.Array:
    """The 11 window weights as the float array the SSIM entries take."""
    return (_c_float * len(weights))(*weights)


def ssim_fwd(x, x_batch, y, y_batch, shape, window, c1, c2, out,
             mom) -> None:
    """Launch ibgs_ssim_fwd: x, y (B, H, W, C) = `shape` float32 frames,
    each contiguous, with batch strides x_batch, y_batch (0: one frame
    for all), `window` from ssim_window → the map `out` and the five
    moments `mom` (5, B, H, W, C), or None where no gradient is wanted."""
    _launch({"ssim_fwd": 1}, x.device, load("ssim").ibgs_ssim_fwd,
            x.data_ptr(), x_batch, y.data_ptr(), y_batch, *shape, window,
            c1, c2, out.data_ptr(), _ptr(mom))


def ssim_bwd(x, x_batch, y, y_batch, shape, window, c1, c2, g, g_strides,
             mom, dx, dy) -> None:
    """Launch ibgs_ssim_bwd: the forward's frames, window, constants and
    moments, g the map's gradient read through `g_strides` (4, in floats)
    → dx, dy: x's and y's 3 gradient terms (cross, square, mean), (B, H,
    W, C) contiguous each, or None where not wanted."""
    terms = [_ptr(t) for d in (dx, dy)
             for t in (d if d is not None else (None,) * 3)]
    _launch({"ssim_bwd": 1}, x.device, load("ssim").ibgs_ssim_bwd,
            x.data_ptr(), x_batch, y.data_ptr(), y_batch, *shape, window,
            c1, c2, g.data_ptr(), *g_strides, mom.data_ptr(), *terms)


# csrc/optim.cu's table, field for field (tests/test_torch_optim.py holds
# the layout to the source's)
OPTIM_MAX_SEGS, OPTIM_MAX_HYPER = 36, 12


class OptimSeg(ctypes.Structure):
    _fields_ = ([(f, _c_ptr) for f in ("p", "m", "v", "g", "po", "mo", "vo",
                                       "alive")]
                + [(f, ctypes.c_uint) for f in ("n", "width", "sp", "sm",
                                                "sv", "sg", "rot")]
                + [(f, ctypes.c_ushort) for f in ("hyper", "flags")])


class OptimHyper(ctypes.Structure):
    _fields_ = [(f, _c_float) for f in ("lr", "b1", "omb1", "b2", "omb2",
                                        "ibc1", "ibc2", "eps")]


class OptimStats(ctypes.Structure):
    _fields_ = ([("sg", _c_ptr), ("sa", _c_ptr), ("radii", _c_ptr),
                 ("ins", _c_ptr * 5), ("outs", _c_ptr * 5)]
                + [(f, ctypes.c_uint) for f in ("P", "rot", "ssg", "ssa")]
                + [(f, _c_float) for f in ("half_w", "half_h")]
                + [("flags", ctypes.c_uint)])


class OptimTable(ctypes.Structure):
    _fields_ = [("seg", OptimSeg * OPTIM_MAX_SEGS),
                ("hyper", OptimHyper * OPTIM_MAX_HYPER),
                ("stats", OptimStats), ("count", _c_ptr), ("nseg", _c_int)]


def optim(table: OptimTable, device) -> None:
    """Launch ibgs_optim over `table` (an OptimTable of `device`'s
    pointers): zeroes the count first (where it has one), then the kernel
    (none when the table holds no element)."""
    _launch({"optim": 1}, device, load("optim").ibgs_optim,
            ctypes.addressof(table))


# kernel: (library, attribute entry, the kernel's index there, the fields
# the entry writes)
_SM = ("registers", "local_bytes", "ctas_per_sm")
_INFO = {
    **{k: ("warp", "ibgs_warp_info", i, _SM + ("cta_w", "cta_h"))
       for i, k in enumerate(("warp_fwd", "warp_bwd", "rgb10_pack"))},
    **{k: ("preprocess", "ibgs_preprocess_info", i, _SM + ("threads",))
       for i, k in enumerate(("preprocess_fwd", "preprocess_bwd"))},
    **{k: ("binning", "ibgs_binning_info", i, _SM + ("threads",))
       for i, k in enumerate(BIN_KERNELS)},
    **{k: ("ssim", "ibgs_ssim_info", i, _SM + ("threads", "shared_bytes"))
       for i, k in enumerate(("ssim_fwd", "ssim_bwd"))},
    "optim": ("optim", "ibgs_optim_info", 0, _SM + ("threads",)),
}


def kernel_info(kernel: str, *shape, source=None) -> dict:
    """Registers, local (spill) bytes per thread and CTAs one SM holds at
    once (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor) of `kernel` as the port
    launches it, with its CTA's size: cta_w and cta_h in threads for the
    warp kernels, threads for the others, and static shared bytes for the
    SSIM kernels.  `shape` is what the kernel is built for: B buffer
    entries and S sources for the warp kernels, K SH coefficients (0: no
    colour) for the projection's, nothing for the others (bin_radix as
    its intermediate passes build).  `source`: the library, if not the
    port's own (a name in SOURCES)."""
    lib, entry, which, fields = _INFO[kernel]
    out = (_c_int * len(fields))()
    _check(getattr(load(source or lib), entry)(which, *shape, out),
           f"{kernel} attribute query")
    return dict(zip(fields, out))
