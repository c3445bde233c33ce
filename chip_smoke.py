#!/usr/bin/env python3
"""Drive the PyTorch port (ibgs_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA device, `nvcc` (CUDA_HOME or /usr/local/cuda) and the repo's
`bench_bundle.npz`.  Without a card it exits 1 and prints no result.
Phases, one JSON line each; any failure makes the exit code 1:

  device     the card's name, count and nvidia-smi name / power limit
  build      nvcc of every kernel source (registers, shared memory, spills)
             and, per kernel and mode, the CTAs one SM holds at the main
             path's CTA size (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
  blend_fwd  the forward kernel against its plain PyTorch version in all
             three modes on the bundle's real instances at 960x544
  blend_bwd  the backward kernel against its plain version at 960x544 in
             modes render_geo and colour, with the cotangents of one real
             backward of the training objective and one seeded random
             set; two kernel runs bit-identical
  warp       the three warp kernels (csrc/warp.cu) against their plain
             versions at 960x544 and 1920x1088 on the source images,
             median buffers, median, source depths and cotangents of that
             real render_geo backward and on one seeded random set of
             cotangents: rgb10_pack equal, the forward's colour sums
             within 1e-5 abs + 1e-5 rel, its occlusion outputs (wdepth,
             depth_err) bit for bit and the `valid` mask equal, the
             backward bit for bit, non-finite values in the same places,
             two backward runs bit-identical
  preprocess the two projection kernels (csrc/preprocess.cu) against
             their plain versions on the bundle at 960x544 and 1920x1088
             (the training objective's own inputs and cotangents, then
             seeded random cotangents) and on the bench's random 1M scene
             (1,310,720 slots) at 960x544: the forward's integer fields
             equal (0 differing integers), its float fields within 1e-5
             abs + 1e-5 rel; the backward, per gradient column, within 2x
             the float32 plain version's max error against a float64 run
             of it + 1e-7 of the column's largest value, non-finite values
             in the plain version's places, two runs bit-identical
  binning    the staircase binning kernels (csrc/binning.cu) against the
             plain version on the bundle at 960x544 and 1920x1088 (also
             with cap and row_cap cutting the lists) and on the bench's
             random 1M scene at 960x544: every TileBins field equal
  ssim       the SSIM kernels (csrc/ssim.cu) against the plain chain
             (`losses.ssim_map_plain`) at 1920x1088 and 960x540, on a
             seeded frame pair and on the train step's stack (the ground
             truth expanded over 3 sources, batch stride 0): the map and
             each gradient bit for bit against autograd through the plain
             chain, repeats bit-identical; and each kernel's timing row
             (device ms, byte bound, registers, spills, CTAs per SM, the
             plain chain's ms)
  serve      EvalRenderer.render_one at 960x544 and 1920x1088: finite
             outputs, exactly 5 blend forwards and 5 projections, 1 rgb10
             pack, 1 warp forward and no backward per view, each binning
             kernel 5 times (the radix pass once a digit)
  train      10 IBGS training steps at 960x544 (render_geo + aggregation,
             iteration 13000), 1 launch of each kernel per step (the
             binning kernels too; 3 SSIM forwards and backwards), finite,
             loss falling; then 1 colour-only step (iteration 5000): 1
             launch of each blend and projection kernel, 1 SSIM forward
             and backward, and no pack or warp
  timing     kernel / plain / serving / train-step times (CUDA events and
             host clock; the projection and binning kernels by their
             profiled device time), each kernel case's share of its bound
             (the warp forward's also with the pack), the warp, projection
             and binning kernels' registers, spills and CTAs per SM, the
             binning call's device events, host-clock time and plain time
             at the bundle (1920x1088) and the 1M scene, the tile range
             lengths (p50, p99, max)
             per size, peak memory, device busy share (torch.profiler)
  loop       the training driver (train/loop.train) on the bundle's 5
             views at 960x544 from its 91,307 splat centres as seed
             points: KNN init, a 300-iteration cut of the schedule with
             densify events at 100, 150 and 200, the opacity reset at 200,
             an evaluation, a PLY snapshot and a checkpoint at 300, then a
             resume from it for iteration 301 (depth-cache rebuild).
             Finite losses, no non-finite gradient, a densify event that
             changes the alive count, a falling loss, a bit-exact
             checkpoint, exactly the kernel launches the schedule implies
             (the warp in each render_geo step and evaluation render);
             the native library's exact KNN against the device KNN on the
             seed cloud
  eval       the evaluation path on the loop's model directory (its PLY
             and checkpoint at 300) with the bundle view as a test view:
             `render.render_model` (the PNG source dump, the test split
             with FPS, the 5 train views, the TSDF mesh at a voxel of the
             largest extent / 256), `metrics.evaluate_model_dir`, 12 video
             frames and one viewer frame over a loopback socket.  Finite
             images, depths and vertices, the PNG counts, each PNG decoding
             to the truncated float it was written from, exactly the
             forward launches the calls imply and no backward, the card's
             TSDF against the CPU's integration of the same inputs, a
             non-empty mesh, SSIM on the card against the CPU, LPIPS null;
             the bundle model's source depths at the ring cameras against
             the bundle's cached ones
  parallel   row bands and the Gaussian-sharded step on the card, NCCL at
             world size 1: the bundle at 960x544 as 2 bands of 272 rows
             and at 1920x1088 as 4, each through `rasterize`'s viewport
             band with the warp, stitched against the full frame; both
             blend kernels and the three warp kernels held to their plain
             versions on the last 960x544 band (row0 272), whose loss
             reads the warped images; `gsp_full_train_step` on the train
             phase's step on its fast path and its generic exchange
             against the single-chip step (losses, post-Adam parameters,
             overflow 0, the two paths bit-identical), ms per step of all
             three; then
             `python -m ibgs_tpu_torch.train --gsp_shards 1` (in process,
             the bundle's 5 views as its scene) for an 80-iteration cut
             with densify events and an opacity reset: the evaluation
             PSNR rises before the reset and after it, exact launches,
             densify through gsp_densify_fn, the checkpoint equal to the
             run's PLY
  drivers    the port's drivers: `scripts/train_runs prod` in process at
             the JAX package's 1M configuration (1M seeds, 1.5M ground
             truth points, 16 views at 960x544, thresholds 8e-5 / 1.6e-4,
             the debug trip wire) cut to 60 iterations with the instance
             cap just under the first step's count, the capacity at 2^20
             (95% occupied) before the densify event at 20, and one
             evaluation: the native KNN at init, both growth events,
             finite losses, rising PSNR, exact launches; the bundle it
             writes read by `convert` and served once (5 forward
             launches); the snapshot replay of every 16th alive row of
             the run's model with one NaN log-scale row and the example,
             each with the kernels against the plain path on the card;
             `python -m
             ibgs_tpu_torch.exp_script` on the COLMAP fixture (three
             subprocesses, whose launches are not counted): its result
             files and PSNR; eval_geometry's chamfer of the eval phase's
             mesh against itself (0) and against a copy shifted by 1e-4
             along x (within 1%)
  bench      the measurement drivers: `ibgs_tpu_torch.bench` on its four
             default configs (the random 100k scene and the converged
             bundle, each at 960x544 and 1920x1088; train mode), the
             bundle in render mode at both sizes, the 1M random scene at
             960x544, and the bundle at 960x544 traced (with Python
             frames); parse_trace on that trace (its device total equal to
             this script's reading of the file, one "bench_step" label per
             step); kernel_probe (1.37M synthetic instances) with both
             kernels held to their plain versions on its first 4 rows of
             tiles; perf_probe's six stages; gsp_tax on the fast and the
             generic exchange (equal first losses); gsp_scaling's row at
             world size 1 (exact, no overflow).  Every value finite, every
             default config present, and every bench chain of k steps
             launches exactly k blend forwards, k projections, k packs
             and k warp forwards and, in train mode, k of each backward
  kernels    each kernel (blend_fwd, blend_bwd, rgb10_pack, warp_fwd,
             warp_bwd, preprocess_fwd, preprocess_bwd) with
             its launches on the serving, train, loop,
             eval, parallel, drivers and bench paths (the parallel count
             takes only the band renders, the two GSP steps and the CLI
             run, not the full-frame and single-chip references they are
             held to; the drivers count the production run and the
             bundle's served view, not the replay and example renders held
             to the plain path; the bench count takes the four bench
             runs, not the probes)

then the nvidia-smi line and, last, {"ok": true, "device": {...}}.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUNDLE = os.path.join(ROOT, "bench_bundle.npz")
SIZES = [(960, 544), (1920, 1088)]
DEVICE = "cuda"
TOL_ABS, TOL_REL = 1e-5, 1e-5      # forward float outputs, kernel vs plain
INT_MISMATCH_SHARE = 1e-4          # forward integer outputs, share of pixels
# backward, per gradient column: the sums over a tile's pixels are taken in
# another order than the plain version's
BWD_TOL_REL, BWD_TOL_ABS = 1e-4, 1e-7
SERVE_REPEATS = 7                  # timed serving calls per size
TRAIN_STEPS = 10                   # counted render_geo + aggregation steps
STEP_REPEATS = 7                   # timed train steps per size
ITER_GEO, ITER_COLOR = 13000, 5000  # after / before geometry rendering
NET_LR = 1e-3
HBM_BYTES_S = 3.35e12              # H100 SXM device memory rate
FP32_FLOP_S = 67e12                # H100 SXM float32 rate outside tensor cores
# float ops that every walked (pixel, instance) pair needs, counted from
# the kernel bodies: offsets 2, power 9, clamp + exp + opacity + clamp 4,
# gate 2.  Pairs walked = sum of n_contrib (positions up to each pixel's
# last contributor), so pairs x OPS_PER_PAIR is a lower bound on the work.
OPS_PER_PAIR = 17
# the backward's further float ops per contributing pair, counted from
# blend_bwd.cu: colour mode 48 (alpha-gradient chain, 15 terms), geo 79
# (plus the normal and buffer terms), each plus the 15 adds that sum the
# terms over the tile's pixels
OPS_PER_CONTRIB_PAIR = {0: 63, 1: 94}
# float ops per (buffer entry, source) pair, counted from csrc/warp.cu:
# forward projection 20, 1/(qz + eps) 2, pu / pv 6, w_eff 1, floors and
# fractions 4, bilinear weights 6, three channels 21, sums 7; the backward
# recomputes the first 39 and adds 78 for the channels' gradient terms, 2
# for dbw, 12 for dq/dd, 10 for the projection Jacobian and 4 for dbd.
# The rgb10 unpack is the table format's own cost, not the function's.
WARP_OPS_PER_PAIR = {"warp_fwd": 67, "warp_bwd": 145}
# the forward's occlusion test per (pixel, source): the median point's
# transform 18, 1/(qz + eps) 2, pum / pvm 6, floors and fractions 4,
# bilinear weights 6, the sample 7, |wdepth - qz|·inv 3; plus the point's
# pdx·m, pdy·m (2) per pixel
WARP_OCC_OPS, WARP_OCC_PIXEL_OPS = 46, 2
# rgb10_pack per texel: clamp (2), scale, round, per channel
PACK_OPS_PER_TEXEL = 12
# float ops per Gaussian of the projection kernels, (fixed, per SH
# coefficient), counted from csrc/preprocess.cu to about 10%: the forward's
# view and clip transforms 36, pixel mean 12, EWA Jacobian 34, rotation and
# covariance 91, the three quadratic forms 81, conic 11, radius and
# rectangle 55, view direction 13, basis 21, plane 28, and per coefficient
# the mask and the colour sums 7; the backward recomputes the geometry
# (about 290) and adds the quadratic forms' adjoint 270, the covariance's
# 108, the quaternion's 50, the Jacobian's, pixel mean's, conic's and view
# transform's 88, the colour's 90 and the plane's 53, per coefficient 16
PRE_OPS = {"preprocess_fwd": (390, 7), "preprocess_bwd": (970, 16)}
PRE_SCENE_N = 1_000_000            # the random scene of the bench (1M)
PRE_PROFILED = 5                   # profiled calls per projection kernel
BIN_FIELDS = ("order", "rank", "gauss_id", "tile_id", "inst_valid",
              "tile_start", "tile_stop", "slot", "seg_off")
# the SSIM loss's frames: the bundle cell's and the Tanks and Temples
# cell's; each as a frame pair and as the train step's stack of 3 sources
SSIM_SIZES = [(1920, 1088), (960, 540)]
# the SSIM kernels' calls a train step: the image loss, the multi-view
# photometric loss and the aggregation loss (render_geo), the image loss
# alone (colour); each forward with its backward
SSIM_STEP = {1: 3, 0: 1}
MODE_NAMES = {0: "color", 1: "render_geo", 2: "depth_only"}
FIELDS = ("color", "normal", "final_t", "n_contrib", "buf_depth",
          "buf_weight", "buf_contrib")
GRAD_COLUMNS = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c",
                "opacity", "r", "g", "b", "normal_x", "normal_y",
                "normal_z", "dist", "abs_mean_x", "abs_mean_y")
TRAIN_AUX = ("loss", "image_loss", "normal_loss", "photo_loss", "agg_loss",
             "l1", "psnr")
# the loop phase's cut of the schedule: colour-only steps up to iteration
# 110 (geometry from 120 - 2·5 views), aggregation from 151, densify events
# at 100, 150 and 200, the opacity reset at 200 after that event's densify
LOOP_SCHEDULE = dict(
    iterations=300, position_lr_max_steps=300, densify_from_iter=50,
    densification_interval=50, densify_until_iter=250,
    opacity_reset_interval=200, single_view_weight_from_iter=120,
    multi_view_weight_from_iter=120, start_color_aggregation_iter=150,
    color_aggregate_burnin_steps=50)
LOOP_TEST_ITERS = (300,)
LOOP_PROFILE = (60, 10)            # profiled colour-only iterations (from, n)
LOOP_REPORT_ITERS = (1, 100, 200, 300)
LOOP_EVAL_VIEWS = 5                # train views an evaluation renders
LOOP_DIR = os.path.join(ROOT, "build", "chip_smoke_loop")
EVAL_FPS_LOOPS = 5                 # render_split's timed passes (its default)
EVAL_VIDEO_FRAMES = 12
EVAL_VOXEL_DIVISOR = 256           # voxel = largest extent of the bounds / 256
# the card's TSDF against the CPU's: equal weights, tsdf and colour within
# TSDF_TOL where the weight is positive, on all but TSDF_MISMATCH_SHARE of
# the voxels (a pixel index that flips at a rounding tie moves a voxel whole)
TSDF_TOL, TSDF_MISMATCH_SHARE = 1e-5, 1e-4
SSIM_TOL = 1e-5                    # SSIM on the card against the CPU
VIEWER_TIMEOUT_S = 30
PAR_BAND_ROWS = 272                # rows of a band (2 at 544, 4 at 1088)
BAND_RTOL, BAND_ATOL = 1e-5, 1e-6  # stitched bands against the full frame
# the Gaussian-sharded step against the single-chip step (the JAX
# package's tests/test_gsp.py bounds): losses relative, parameters within
# GSP_LR_BOUND·lr of their group with at most GSP_SHARE of entries over
# 1e-6 (Adam's first step is ±lr whatever the gradient's size)
GSP_LOSS_RTOL, GSP_LR_BOUND, GSP_SHARE = 2e-5, 2.05, 0.05
# the CLI's cut of the loop schedule: densify events at 20 and 40, the
# opacity reset at 40 (after that event's densify), geometry from 36,
# aggregation from 61, PLY and checkpoint at 80.  The reset sets every
# opacity to at most 0.01, which 40 Adam steps of 0.025 in the logit do
# not undo, so the evaluation PSNR (the CLI's own print, at
# PAR_LOOP_EVALS) is held to rise on each side of it: from 1 to 39 and
# from 41 to 80
PAR_LOOP_SCHEDULE = dict(
    iterations=80, position_lr_max_steps=80, densify_from_iter=10,
    densification_interval=20, densify_until_iter=45,
    opacity_reset_interval=40, single_view_weight_from_iter=45,
    multi_view_weight_from_iter=45, start_color_aggregation_iter=60,
    color_aggregate_burnin_steps=10)
PAR_LOOP_EVALS = (1, 39, 41, 80)
PAR_LOOP_DIR = os.path.join(ROOT, "build", "chip_smoke_parallel")
EVAL_MESH = os.path.join(ROOT, "build", "chip_smoke_eval_mesh.ply")
# the drivers phase's production run: the JAX package's 1M configuration
# (1M seed splats from 1.5M ground-truth points, 16 views at 960x544, the
# aggressive thresholds 8e-5 / 1.6e-4, the debug trip wire armed), cut to
# 60 iterations: the instance cap just under the seed model's fewest
# instances over the train views (it grows at the first steps), one densify
# event at 20 with the capacity at 2^20 (1M seeds fill 95.4% of it, so it
# doubles before the densify), geometry from 32 (28 steps: every view's
# depth cache filled twice for the bundle), and one evaluation at 60
DRV_DIR = os.path.join(ROOT, "build", "chip_smoke_drivers")
DRV_ITERS = 60
DRV_INIT_CAPACITY = 1 << 20
DRV_ARGS = ["--seed_pts", "1000000", "--gt", "1500000", "--grad_th", "8e-5",
            "--abs_th", "1.6e-4", "--init_capacity", str(DRV_INIT_CAPACITY),
            "--debug", "1", "--log_every", "1", "--iters", str(DRV_ITERS)]
DRV_SCHEDULE = dict(densify_from_iter=10, densification_interval=10,
                    densify_until_iter=25, single_view_weight_from_iter=60,
                    multi_view_weight_from_iter=60)
DRV_EVAL_VIEWS = 7                 # 2 test views and 5 train views
# the suite runner on the COLMAP fixture: the JAX package's
# tests/test_colmap_e2e.py schedule without --backend
DRV_SUITE_EXTRA = [
    "--eval", "--iterations", "15", "--densify_from_iter", "6",
    "--densification_interval", "6", "--densify_until_iter", "12",
    "--single_view_weight_from_iter", "8", "--multi_view_weight_from_iter",
    "8", "--use_color_aggregation", "--start_color_aggregation_iter", "10",
    "--color_aggregate_burnin_steps", "3", "--number_src_frames", "2",
    "--nb_visible_src_frames", "2", "--position_lr_max_steps", "15",
    "--multi_view_num", "3", "--multi_view_max_angle", "120",
    "--multi_view_max_dis", "10", "--instance_cap", "16384",
    "--save_iterations", "15", "--test_iterations", "15",
    "--checkpoint_iterations", "15", "--quiet"]
DRV_SUITE_TIMEOUT_S = 300
# the replay's snapshot: every 16th alive row of the run's model (about
# 63k of 1M) and the poisoned one, so that the plain path's three
# backward walks stay within seconds
DRV_REPLAY_STRIDE = 16
# eval_geometry's shift: far below the 1M surface samples' spacing, so
# each shifted sample's nearest neighbour is its own original
DRV_CHAMFER_SHIFT = 1e-4
# the bench phase: `ibgs_tpu_torch.bench`'s default configs (train mode),
# the bundle in render mode, the 1M-splat random scene at 960x544
# (bench.py's reference operating point), the bundle at 960x544 with a
# Chrome trace of one chain, the probes; each bench chain is BENCH_ITERS
# steps
BENCH_ITERS = 5
BENCH_TRACE_DIR = os.path.join(ROOT, "build", "chip_smoke_bench_trace")
BENCH_CONFIGS = ["random@960x544", "random@1920x1088", "converged@960x544",
                 "converged@1920x1088"]
KP_GATE_TILE_ROWS = 4              # kernel_probe's slice held to plain


def emit(obj):
    print(json.dumps(obj), flush=True)


def launch_counts():
    """Every kernel wrapper's launch count: the blend's, the warp's
    (rgb10_pack, warp_fwd, warp_bwd) and the projection's
    (preprocess_fwd, preprocess_bwd)."""
    from ibgs_tpu_torch.ops import blend, epilogue, preprocess
    return {**blend.LAUNCHES, **epilogue.LAUNCHES, **preprocess.LAUNCHES}


def reset_launch_counts():
    from ibgs_tpu_torch.ops import blend, epilogue, preprocess
    for counts in (blend.LAUNCHES, epilogue.LAUNCHES, preprocess.LAUNCHES):
        for k in counts:
            counts[k] = 0


def ssim_counts():
    """The SSIM kernels' launch counts (ops/ssim.LAUNCHES)."""
    from ibgs_tpu_torch.ops import ssim as tssim
    return dict(tssim.LAUNCHES)


def ssim_since(before):
    now = ssim_counts()
    return {k: now[k] - before[k] for k in before}


def launches_since(before):
    now = launch_counts()
    return {k: now[k] - before[k] for k in before}


def kernel_launches(blend_fwd, blend_bwd, warp_fwd, warp_bwd):
    """The launch counts of a path; every render_geo render packs its
    source colours once before its warp forward, and every render
    projects its splats once (preprocess_fwd) before its blend and, in a
    backward, runs preprocess_bwd once after blend_bwd.  (gsp_scaling's
    row also projects once without a blend to count instances; it runs in
    the bench phase outside the counted bench runs.)"""
    return {"blend_fwd": blend_fwd, "blend_bwd": blend_bwd,
            "rgb10_pack": warp_fwd, "warp_fwd": warp_fwd,
            "warp_bwd": warp_bwd, "preprocess_fwd": blend_fwd,
            "preprocess_bwd": blend_bwd}


def geo_steps(opt, n_train, first, last):
    """Render_geo steps among iterations first..last of the loop (its
    geometry starts after single_view_weight_from_iter - 2·views)."""
    geo_from = opt.single_view_weight_from_iter - 2 * n_train
    return max(0, last - max(first - 1, geo_from))


def parse_ptxas(log):
    """Per-kernel registers / shared memory / spills from `-Xptxas -v`."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def cuda_ms(fn, iters, warmup=2):
    """Mean ms of `iters` calls after `warmup` (CUDA events)."""
    from ibgs_tpu_torch.utils import profiling
    return profiling.wall_ms(fn, iters, warmup, DEVICE)


def host_ms(fn):
    """Host clock around one call that ends in a device synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def device_profile(fn, step_ms, tag, failures, top=8):
    """Device busy time of one call of fn, its launches and top kernels
    (`profiling.device_time`), and the share of `step_ms` (the same call
    timed without the profiler) that the card is idle, as read.  A trace
    that lost a launch's device event, or busy time above `step_ms`, fails
    the script."""
    from ibgs_tpu_torch.utils import profiling
    out = profiling.idle_share(profiling.device_time(fn, DEVICE, top),
                               step_ms)
    if "error" in out:
        failures.append(f"{tag} profile: {out['error']}")
    return out


def gate_fwd(k_out, p_out, tag, failures):
    """The forward kernel's outputs against the plain version's: floats
    within TOL_ABS + TOL_REL·|plain| and finite, integers on all but
    INT_MISMATCH_SHARE of the pixels.  Returns (record, max abs error)."""
    import torch
    m, max_err = {}, 0.0
    n_pix = p_out.final_t.numel()
    for f in FIELDS:
        a, b = getattr(k_out, f), getattr(p_out, f)
        if a.dtype == torch.int32:
            bad = int((a != b).reshape(n_pix, -1).any(-1).sum())
            m[f + "_mismatch_pixels"] = bad
            if bad > INT_MISMATCH_SHARE * n_pix:
                failures.append(f"{tag} {f}: {bad} mismatching pixels")
        else:
            err = (a - b).abs()
            e = float(err.max()) if err.numel() else 0.0
            m[f + "_max_abs_err"] = e
            max_err = max(max_err, e)
            if not bool((err <= TOL_ABS + TOL_REL * b.abs()).all()) \
                    or not bool(torch.isfinite(a).all()):
                failures.append(f"{tag} {f}: max abs err {e}")
    return m, max_err


def gate_bwd(k1, k2, p, tag, failures):
    """Two backward kernel runs against the plain version: each column
    within BWD_TOL_REL x its largest plain value + BWD_TOL_ABS, finite,
    the runs bit-identical.  Returns (record, max abs error)."""
    import torch
    err = (k1 - p).abs().amax(0)[:15]
    scale = p.abs().amax(0)[:15]
    ok = bool((err <= BWD_TOL_REL * scale + BWD_TOL_ABS).all())
    finite = bool(torch.isfinite(k1).all())
    same = torch.equal(k1, k2)
    if not (ok and finite and same):
        failures.append(f"{tag}: within tolerance {ok}, finite {finite}, "
                        f"bit-identical {same}")
    return {"max_abs_err": dict(zip(GRAD_COLUMNS, err.tolist())),
            "max_abs_plain": dict(zip(GRAD_COLUMNS, scale.tolist())),
            "nonzero_rows": int((k1.abs().sum(1) > 0).sum()),
            "rows": int(k1.shape[0]), "finite": finite,
            "bit_identical_repeat": same}, float(err.max())


def warp_args(fwd, bwd):
    """(the eight tensor inputs of the forward, the intrinsics, the two
    cotangents) of a recorded warp forward and backward call, detached."""
    *tensors, fx, fy, cx, cy = fwd
    return (tuple(t.detach() for t in tensors), (fx, fy, cx, cy),
            tuple(g.detach() for g in bwd[-2:]))


def same_bits(a, b) -> bool:
    """Bit for bit, NaN in the same places (their payloads aside)."""
    import torch
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def gate_warp_pair(args, intr, cts, tag, failures, images=None):
    """The warp kernels against their plain versions on one set of inputs:
    rgb10_pack of `images` (if given) equal to pack_rgb10_rows and to the
    tables in `args`; the forward's wsc and ws within TOL_ABS +
    TOL_REL·|plain| (the B-sum's order differs), its wdepth and depth_err
    bit for bit and the `valid` mask (wdepth > 0, depth_err < the
    threshold) equal; the backward's dbd and dbw bit for bit; non-finite
    values in the same places, two backward runs bit-identical.  Returns
    (record, {kernel: max abs error})."""
    import torch
    from ibgs_tpu_torch.config import OptimizationParams
    from ibgs_tpu_torch.ops import epilogue
    rec, errs = {}, {"rgb10_pack": 0.0, "warp_fwd": 0.0, "warp_bwd": 0.0}
    if images is not None:
        packed = epilogue.rgb10_pack_cuda(images)
        plain = epilogue.pack_rgb10_rows(images)
        torch.cuda.synchronize()
        bad = int((packed != plain).sum())
        rec["rgb10_pack"] = {"mismatching_texels": bad,
                             "equal_to_recorded_tables":
                             torch.equal(packed, args[2])}
        errs["rgb10_pack"] = float(bad)
        if bad or not rec["rgb10_pack"]["equal_to_recorded_tables"]:
            failures.append(f"{tag} rgb10_pack: {rec['rgb10_pack']}")
    k = epilogue.warp_fwd_cuda(*args, *intr)
    p = epilogue.warp_views_plain(*args, *intr)
    k1 = epilogue.warp_bwd_cuda(*args[:6], intr, *cts)
    k2 = epilogue.warp_bwd_cuda(*args[:6], intr, *cts)
    pb = epilogue.warp_views_bwd_plain(*args[:6], intr, *cts)
    torch.cuda.synchronize()

    for kernel, names, got, want in (
            ("warp_fwd", ("wsum_color", "wsum", "wdepth", "depth_err"), k, p),
            ("warp_bwd", ("dbd", "dbw"), k1, pb)):
        for i, (name, a, b) in enumerate(zip(names, got, want)):
            fin = torch.isfinite(b)
            same_nonfinite = (torch.equal(torch.isfinite(a), fin)
                              and torch.equal(torch.isnan(a), torch.isnan(b)))
            err = (a - b).abs()[fin]
            e = float(err.max()) if err.numel() else 0.0
            scale = float(b[fin].abs().max()) if err.numel() else 0.0
            r = {"max_abs_err": e, "max_abs_plain": scale,
                 "nonfinite": int((~fin).sum()),
                 "bit_equal_plain": same_bits(a, b)}
            if name in ("wsum_color", "wsum"):
                ok = bool((err <= TOL_ABS + TOL_REL * b[fin].abs()).all())
            else:
                ok = r["bit_equal_plain"]
            if kernel == "warp_bwd":
                r["bit_identical_repeat"] = same_bits(a, k2[i])
                ok = ok and r["bit_identical_repeat"]
            if not (ok and same_nonfinite):
                failures.append(f"{tag} {kernel} {name}: {r}, non-finite "
                                f"in the same places {same_nonfinite}")
            rec[name] = r
            errs[kernel] = max(errs[kernel], e)
    thr = OptimizationParams().depth_error_threshold
    valid = [(o[2] > 0.0) & (o[3] < thr) for o in (k, p)]
    rec["valid_mismatch_pixels"] = int((valid[0] != valid[1]).sum())
    rec["valid_share"] = float(valid[1].float().mean())
    if rec["valid_mismatch_pixels"]:
        failures.append(f"{tag} warp_fwd: the valid mask differs at "
                        f"{rec['valid_mismatch_pixels']} pixels")
    return rec, errs


def preprocess_args(model, cam, learnt, tile_h, tile_w):
    """preprocess_fwd_cuda's arguments for `model` seen from `cam`, as
    rasterize passes them."""
    nw, off = model.oriented_normal(cam.cam_pos, learnt=learnt)
    return (model.params.xyz.detach(), model.scale.detach(),
            model.quat_unit.detach(), model.opacity.detach(),
            model.sh_coeffs.detach(), model.active_sh_degree, nw.detach(),
            off.detach(), cam, tile_h, tile_w, model.alive)


def gate_preprocess(args, cts, tag, failures):
    """The projection kernels against their plain versions on one set of
    inputs (`args` as preprocess_fwd_cuda takes them, `cts` the five
    cotangents): the forward's integer fields equal (the count of
    differing integers is 0), its float fields within TOL_ABS +
    TOL_REL·|plain|, NaN in the same places; the backward, per gradient
    column, within 2x the float32 plain version's max |error| against a
    float64 run of the plain version + 1e-7 of the column's largest
    |value|, non-finite values in the plain version's places, two runs
    bit-identical.  Returns (record, {kernel: max abs error})."""
    import torch
    from ibgs_tpu_torch.ops import preprocess as pre
    k = pre.preprocess_fwd_cuda(*args)
    p = pre.preprocess_fwd_plain(*args)
    bargs = tuple(args[i] for i in (0, 1, 2, 4, 5, 6, 7, 8))
    k1 = pre.preprocess_bwd_cuda(*bargs, cts)
    k2 = pre.preprocess_bwd_cuda(*bargs, cts)
    p32 = pre.preprocess_bwd_plain(*bargs, cts)

    def f64(x):
        return x.double() if torch.is_tensor(x) else x
    p64 = pre.preprocess_bwd_plain(*(f64(a) for a in bargs),
                                   tuple(f64(c) for c in cts))
    torch.cuda.synchronize()
    rec = {"splats": int(args[0].shape[0]), "sh_coeffs": args[4].shape[1],
           "active_sh_degree": args[5],
           "culled": int((k[9] == 0).sum()), "fwd": {}, "bwd": {}}
    errs = {"preprocess_fwd": 0.0, "preprocess_bwd": 0.0}
    bad_ints = 0
    for name, a, b in zip(pre.OUTPUTS, k, p):
        if a.dtype == torch.int32:
            n_bad = int((a != b).sum())
            bad_ints += n_bad
            rec["fwd"][name + "_differing"] = n_bad
            continue
        nan = torch.isnan(b)
        err = (a - b).abs()[~nan]
        e = float(err.max()) if err.numel() else 0.0
        ok = torch.equal(torch.isnan(a), nan) and bool(
            (err <= TOL_ABS + TOL_REL * b.abs()[~nan]).all())
        rec["fwd"][name + "_max_abs_err"] = e
        errs["preprocess_fwd"] = max(errs["preprocess_fwd"], e)
        if not ok:
            failures.append(f"{tag} preprocess_fwd {name}: max abs err {e}")
    rec["fwd"]["differing_integers"] = bad_ints
    if bad_ints:
        failures.append(f"{tag} preprocess_fwd: {bad_ints} differing "
                        f"integers")
    names = ("xyz", "scale", "quat", "sh", "normal", "offset")
    for name, a, b, c, a2 in zip(names, k1, p32, p64, k2):
        P = a.shape[0]
        a_, b_, c_ = (t.reshape(P, -1).double() for t in (a, b, c))
        same_nf = torch.equal(torch.isfinite(a_), torch.isfinite(b_))
        fin = torch.isfinite(b_) & torch.isfinite(c_)
        zero = torch.zeros((), dtype=torch.float64, device=a.device)
        ek = torch.where(fin, (a_ - c_).abs(), zero).amax(0)
        ep = torch.where(fin, (b_ - c_).abs(), zero).amax(0)
        scale = torch.where(fin, c_.abs(), zero).amax(0)
        ok = bool((ek <= 2 * ep + 1e-7 * scale).all())
        rep_ok = same_bits(a, a2)
        r = {"max_abs_err_vs_f64": float(ek.max()),
             "plain_f32_max_abs_err_vs_f64": float(ep.max()),
             "max_abs_f64": float(scale.max()),
             "worst_err_over_plain_err": float(
                 (ek / torch.clamp(2 * ep + 1e-7 * scale, min=1e-300)).max()),
             "nonfinite": int((~torch.isfinite(a_)).sum()),
             "bit_identical_repeat": rep_ok}
        rec["bwd"][name] = r
        errs["preprocess_bwd"] = max(errs["preprocess_bwd"],
                                     float((a_ - b_).abs()[fin].max())
                                     if bool(fin.any()) else 0.0)
        if not (ok and same_nf and rep_ok):
            failures.append(f"{tag} preprocess_bwd d{name}: {r}, within "
                            f"2x the plain error {ok}, non-finite in the "
                            f"same places {same_nf}")
    return rec, errs


def radix_bytes(n, passes, keys_out):
    """Bytes of a stable radix sort of n 4-byte keys in `passes` passes,
    each pass's input read once and its output written once: the first
    pass makes the values (reads no values), the last writes them as
    int64, and its keys only where `keys_out`."""
    total = 0
    for p in range(passes):
        last = p == passes - 1
        total += n * (4 + (4 if p else 0) + (4 if keys_out or not last else 0)
                      + (8 if last else 4))
    return total


def binning_bytes(P, n, num_tiles, tile_passes):
    """Bytes each binning kernel needs for P Gaussians and n kept
    instances, each input read once and each output written once (the
    workspace's words aside): bin_key the depth and tile count in, the key
    out; bin_radix the depth sort's 4 passes and the tile sort's; bin_count
    the order, tile count, rectangle and cull row in, seg_off and the kept
    rows out; bin_emit the same inputs with seg_off and the kept rows in, a
    tile id and a rank per slot out; bin_ranges the sorted tile ids, the
    permutation and the slot ranks in, the order entries of the ranks
    present (at most one per instance), rank, gauss_id, tile_id,
    inst_valid and the tile starts out."""
    return {"bin_key": 12 * P,
            "bin_radix": (radix_bytes(P, 4, False)
                          + radix_bytes(n, tile_passes, True)),
            "bin_count": 64 * P + 8, "bin_emit": 64 * P + 8 * n,
            "bin_ranges": 41 * n + 8 * min(P, n) + 4 * (num_tiles + 1)}


def binning_inputs(sp):
    """(sp, cull table) of a Splats2D as `prepare` bins it."""
    from ibgs_tpu_torch.ops.rasterize import cull_table
    return sp, cull_table(sp)


def gate_binning(sp, cull, grid, caps, tag, failures):
    """The binning kernels against the plain version on one input: every
    TileBins field and both totals equal.  `grid` = (tiles_x, tiles_y,
    tile_h, tile_w), `caps` = (cap, row_cap)."""
    import torch
    from ibgs_tpu_torch.ops import binning
    TX, TY, TH, TW = grid
    k = binning.bin_staircase_cuda(sp, TX, TY, caps[0], cull, TH, TW,
                                   caps[1])
    p = binning.bin_staircase_plain(sp, TX, TY, caps[0], cull, TH, TW,
                                    caps[1])
    differing = [f for f in BIN_FIELDS
                 if getattr(k, f).dtype != getattr(p, f).dtype
                 or not torch.equal(getattr(k, f), getattr(p, f))]
    differing += [f for f in ("n_instances", "n_rows")
                  if getattr(k, f) != getattr(p, f)]
    if differing:
        failures.append(f"binning {tag}: {differing} differ from the plain "
                        f"version")
    return {"splats": sp.depth.shape[0], "cap": caps[0], "row_cap": caps[1],
            "n_instances": p.n_instances, "n_rows": p.n_rows,
            "kept": p.rank.shape[0], "differing": differing}


def ssim_inputs(W, H, stack, dev):
    """Seeded (img1, img2, map gradient) at W x H: a frame pair, or the
    train step's stack: a frame expanded over 3 sources (batch stride 0)
    against 3 others."""
    import torch
    g = torch.Generator().manual_seed(W * H + int(stack))
    shape = (3, H, W, 3) if stack else (H, W, 3)
    a = torch.rand(shape[-3:], generator=g)
    b = (torch.rand(shape, generator=g) * 0.2 + 0.8 * a).clamp(0, 1)
    ct = torch.randn(shape, generator=g)
    a, b, ct = a.to(dev), b.to(dev), ct.to(dev)
    return (a[None].expand_as(b) if stack else a), b, ct


def ssim_phase(dev, failures):
    """The SSIM kernels against the plain chain at SSIM_SIZES, on a frame
    pair (both inputs need a gradient) and on the stack (the stack does):
    the map and each gradient bit for bit against autograd through the
    plain chain, repeats bit-identical.  Then the timing rows, as the
    train step calls
    the kernels (the frame's first input needs a gradient, the stack's
    second): each kernel's device time (the median of profiled calls of
    its one launch), its bound (each input byte read once, a stride-0
    frame once, each output written once, at 3.35 TB/s), registers,
    spills and CTAs per SM, and the plain chain's forward and backward
    (CUDA events around calls, and its device time).  Returns (the
    phase's record, the timing rows)."""
    import torch
    from ibgs_tpu_torch.ops import _cuda
    from ibgs_tpu_torch.ops import ssim as tssim
    from ibgs_tpu_torch.train import losses
    from ibgs_tpu_torch.utils import profiling

    def grads(fn, a, b, ct, need):
        x = a.detach().requires_grad_(need[0])
        y = b.detach().requires_grad_(need[1])
        out = fn(x, y)
        ins = [t for t in (x, y) if t.requires_grad]
        return out.detach(), torch.autograd.grad((out * ct).sum(), ins)

    rec, rows = {"phase": "ssim", "cases": {}}, []
    for W, H in SSIM_SIZES:
        for stack in (False, True):
            tag = f"{'stack3_' if stack else ''}{W}x{H}"
            a, b, ct = ssim_inputs(W, H, stack, dev)
            need = (False, True) if stack else (True, True)
            k = grads(tssim.ssim_map_cuda, a, b, ct, need)
            p = grads(losses.ssim_map_plain, a, b, ct, need)
            again = grads(tssim.ssim_map_cuda, a, b, ct, need)
            case = {"map_same_bits": same_bits(k[0], p[0]),
                    "grad_same_bits": [same_bits(u, v)
                                       for u, v in zip(k[1], p[1])],
                    "grad_max_abs_err": [float((u - v).abs().max())
                                         for u, v in zip(k[1], p[1])],
                    "repeat_same_bits": same_bits(k[0], again[0]) and all(
                        same_bits(u, v) for u, v in zip(k[1], again[1]))}
            if not (case["map_same_bits"] and all(case["grad_same_bits"])
                    and case["repeat_same_bits"]):
                failures.append(f"ssim {tag}: {case}")
            rec["cases"][tag] = case
            del k, p, again

            need = (False, True) if stack else (True, False)
            out, mom = tssim._forward(a, b, True)
            frame = a.numel() // (3 if stack else 1)
            n = b.numel()
            calls = {
                "ssim_fwd": (lambda: tssim._forward(a, b, True),
                             4 * (frame + 2 * n)),
                "ssim_bwd": (lambda: tssim._backward(a, b, ct, mom, *need),
                             4 * (frame + 3 * n))}
            x = a.detach().requires_grad_(need[0])
            y = b.detach().requires_grad_(need[1])
            ins = [t for t in (x, y) if t.requires_grad]
            plain_out = losses.ssim_map_plain(x, y)
            plain = {
                "ssim_fwd": lambda: losses.ssim_map_plain(x, y),
                "ssim_bwd": lambda: torch.autograd.grad(
                    plain_out, ins, ct, retain_graph=True)}
            for name, (kernel, nbytes) in calls.items():
                runs = [profiling.device_time(kernel, DEVICE)
                        for _ in range(PRE_PROFILED)]
                if any(r.get("device_launches") != 1 for r in runs):
                    failures.append(f"timing {name} {tag}: profiled calls "
                                    f"{runs}")
                    runs = [{"device_busy_ms": math.nan}]
                k_ms = sorted(r["device_busy_ms"]
                              for r in runs)[len(runs) // 2]
                bound = nbytes / HBM_BYTES_S * 1e3
                p_dev = profiling.device_time(plain[name], DEVICE)
                rows.append({
                    "kernel": name, "case": tag, "elements": n, "ms": k_ms,
                    "events_ms": cuda_ms(kernel, 20), "bound_ms": bound,
                    "bound_share": bound / k_ms, "bound_by": "bytes",
                    "bytes": nbytes,
                    "plain_ms": cuda_ms(plain[name], 3, warmup=1),
                    "plain_device_ms": p_dev.get("device_busy_ms"),
                    "plain_launches": p_dev.get("device_launches"),
                    **_cuda.ssim_info(name)})
            del out, mom, plain_out, x, y, ins
    return rec, rows


def preprocess_bytes(args, cts=None):
    """Bytes the forward (cts None) or the backward must move: each input
    read once, each output written once (the camera's 35 words included;
    the cotangents' values only, not the padding of the table they are
    slices of)."""
    xyz, scale, quat, opacity, sh, _, nw, off, cam, _, _, alive = args
    cam_bytes = 4 * (16 + 16 + 3)
    common = sum(t.numel() * t.element_size()
                 for t in (xyz, scale, quat, sh, nw, off))
    P = xyz.shape[0]
    if cts is None:
        reads = common + 4 * P + (alive.numel() if alive is not None else 0)
        writes = 4 * P * (2 + 1 + 3 + 3 + 3 + 1) + 4 * P * (1 + 2 + 2 + 1)
        return reads + cam_bytes + writes
    return 2 * common + cam_bytes + sum(4 * c.numel() for c in cts
                                       if c is not None)


def median_range(xs):
    xs = sorted(xs)
    return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1]}


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def trace_device_ms(path):
    """Device time (kernels, copies, sets) of a torch.profiler Chrome
    trace, its number of device events, and the number of host launches
    whose device event the trace lost."""
    from ibgs_tpu_torch.utils.profiling import device_events
    with open(path) as f:
        dev, lost = device_events(json.load(f).get("traceEvents", []))
    return sum(e.get("dur", 0) for e in dev) / 1e3, len(dev), len(lost)


def loop_phase(d, dev, failures):
    """The training driver from the bundle's seed cloud, counted: returns
    (the phase's record, launches of the run, launches of the resume)."""
    import shutil

    import numpy as np
    import torch
    from ibgs_tpu_torch import convert
    from ibgs_tpu_torch.config import (ModelParams, OptimizationParams,
                                       PipelineParams)
    from ibgs_tpu_torch.core import knn
    from ibgs_tpu_torch.models.gaussians import init_from_points
    from ibgs_tpu_torch.train import checkpoint, loop
    from ibgs_tpu_torch.utils import native

    wh = SIZES[0]
    scene = convert.bundle_train_scene(d, wh[0], wh[1], dev)
    pts, n_train = scene.points, scene.n_train
    rec = {"phase": "loop", "size": f"{wh[0]}x{wh[1]}", "views": n_train,
           "seed_points": int(pts.shape[0]),
           "cameras_extent": scene.cameras_extent,
           "schedule": dict(LOOP_SCHEDULE, test_iterations=LOOP_TEST_ITERS)}

    # KNN: the native library (built here from native/ibgs_native.cpp)
    # against the device KNN that init_from_points takes at this size; the
    # device form |q|² + |p|² - 2q·p keeps a few float32 ulps of max |p|²
    t0 = time.perf_counter()
    native.load()
    native_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = native.knn_mean_sq_dist_3(pts)
    native_ms = (time.perf_counter() - t0) * 1e3
    pts_dev = torch.as_tensor(pts).to(dev)
    holder = {}
    knn_ms = host_ms(lambda: holder.update(
        d2=knn.mean_sq_dist_to_3nn(pts_dev)))
    d2 = holder["d2"].cpu().numpy()
    atol = 4 * float(np.finfo(np.float32).eps) * float((pts ** 2).sum(1).max())
    err = np.abs(d2 - exact)
    log_err = np.abs(np.log(np.clip(d2, 1e-7, None))
                     - np.log(np.clip(exact, 1e-7, None))) / 2
    if not bool((err <= atol).all()):
        failures.append(f"loop: device KNN off the native KNN by "
                        f"{float(err.max())} (> {atol})")
    init_ms = [host_ms(lambda: init_from_points(pts, scene.colors, 2,
                                                device=dev))
               for _ in range(2)]
    rec["knn"] = {"native_build_s": native_build_s, "native_ms": native_ms,
                  "device_ms": knn_ms, "max_abs_err_d2": float(err.max()),
                  "tolerance_d2": atol,
                  "max_abs_err_log_scale": float(log_err.max()),
                  "init_from_points_ms": init_ms}

    # the run: 300 iterations, logged at every one (each log line reads
    # the step's losses, so consecutive elapsed times are iteration times)
    iters = LOOP_SCHEDULE["iterations"]
    opt = OptimizationParams(**LOOP_SCHEDULE)
    p_from, p_num = LOOP_PROFILE
    out = LOOP_DIR
    shutil.rmtree(out, ignore_errors=True)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = loop.train(
        scene, ModelParams(sh_degree=2), opt,
        PipelineParams(profile_from_iter=p_from, profile_num_steps=p_num),
        out, save_iterations=(iters,), test_iterations=LOOP_TEST_ITERS,
        checkpoint_iterations=(iters,), quiet=True, seed=24, log_every=1,
        device=dev)
    torch.cuda.synchronize()
    rec["run_s"] = time.perf_counter() - t0
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    run_launches = launch_counts()

    log = read_jsonl(os.path.join(out, "train_log.jsonl"))
    events = read_jsonl(os.path.join(out, "densify_log.jsonl"))
    by_it = {m["iter"]: m for m in log}
    for m in log:
        bad = [k for k in loop.LOSS_KEYS if not math.isfinite(m[k])]
        if bad or m["nonfinite_grads"]:
            failures.append(f"loop: iteration {m['iter']}: non-finite {bad}, "
                            f"{m['nonfinite_grads']} non-finite gradients")
            break
    if sorted(by_it) != list(range(1, iters + 1)):
        failures.append("loop: not every iteration was logged")
    geo_from = opt.single_view_weight_from_iter - 2 * n_train
    agg_from = opt.start_color_aggregation_iter
    skip = ({e["iter"] for e in events} | set(LOOP_TEST_ITERS)
            | set(range(p_from, p_from + p_num + 1)) | {1})
    spans = {"color": (2, geo_from), "geometry": (geo_from + 1, agg_from),
             "geometry_aggregation": (agg_from + 1, iters)}
    it_ms = {}
    for name, (a, b) in spans.items():
        xs = [(by_it[i]["elapsed"] - by_it[i - 1]["elapsed"]) * 1e3
              for i in range(a, b + 1)
              if i not in skip and i in by_it and i - 1 in by_it]
        it_ms[name] = dict(median_range(xs), iterations=[a, b],
                           counted=len(xs)) if xs else None
    rec["ms_per_iteration"] = it_ms
    rec["densify"] = events
    rec["logged"] = {i: {k: by_it[i][k] for k in
                         ("image_loss", "psnr", "points", "n_instances")}
                     for i in LOOP_REPORT_ITERS if i in by_it}
    if not any(e["n_alive_after"] != e["n_alive_before"] for e in events):
        failures.append("loop: no densify event changed the alive count")
    first = np.mean([m["image_loss"] for m in log[:20]])
    last = np.mean([m["image_loss"] for m in log[-20:]])
    rec["image_loss_first20_last20"] = [float(first), float(last)]
    if not last < first:
        failures.append(f"loop: mean image_loss of the last 20 iterations "
                        f"{last} is not below the first 20's {first}")
    # one blend per step and evaluation render, its backward per step; the
    # warp in every render_geo step (forward and backward) and evaluation
    # render (forward)
    evals = LOOP_EVAL_VIEWS * sum(1 for i in LOOP_TEST_ITERS if i <= iters)
    geo = geo_steps(opt, n_train, 1, iters)
    want = kernel_launches(iters + evals, iters, geo + evals, geo)
    rec["launches"], rec["launches_expected"] = run_launches, want
    if run_launches != want:
        failures.append(f"loop: kernel launches {run_launches}, expected "
                        f"{want}")
    ply = os.path.join(out, "point_cloud", f"iteration_{iters}",
                       "point_cloud.ply")
    if not os.path.exists(ply):
        failures.append("loop: no PLY snapshot")

    # colour-only device time per step, from the loop's own trace window
    trace = os.path.join(out, "trace", "trace.json")
    if os.path.exists(trace) and it_ms["color"]:
        busy, n_dev, lost = trace_device_ms(trace)
        per_step = busy / p_num
        rec["color_profile"] = {
            "iterations": [p_from, p_from + p_num - 1],
            "device_busy_ms_per_step": per_step,
            "device_events_per_step": n_dev / p_num,
            "lost_launches": lost,
            "idle_share": 1.0 - per_step / it_ms["color"]["median"]}
        if lost or not n_dev or rec["color_profile"]["idle_share"] < 0:
            failures.append(f"loop: the trace window's device time "
                            f"{rec['color_profile']}")
    else:
        rec["color_profile"] = "not measured"

    # the checkpoint: bit-exact round trip, write / load time
    ck = os.path.join(out, f"chkpnt{iters}.npz")
    holder = {}
    load_ms = host_ms(lambda: holder.update(
        loaded=checkpoint.load_state(state, ck)))
    loaded, ck_it = holder["loaded"]
    save_ms = host_ms(lambda: checkpoint.save_state(
        state, iters, os.path.join(out, "again.npz")))
    os.remove(os.path.join(out, "again.npz"))
    a, b = checkpoint.state_arrays(state), checkpoint.state_arrays(loaded)
    same = (ck_it == iters and sorted(a) == sorted(b)
            and all(a[k].dtype == b[k].dtype
                    and a[k].tobytes() == b[k].tobytes() for k in a))
    if not same:
        failures.append("loop: the loaded checkpoint differs from the state")
    rec["checkpoint"] = {"bytes": os.path.getsize(ck), "write_ms": save_ms,
                         "load_ms": load_ms, "bit_exact": same,
                         "capacity": state.model.capacity,
                         "ply_bytes": (os.path.getsize(ply)
                                       if os.path.exists(ply) else None)}
    del loaded, a, b

    # the resume: iteration 301 from the checkpoint, after the depth-cache
    # rebuild (one depth_only forward per view)
    reset_launch_counts()
    resume_opt = OptimizationParams(**dict(LOOP_SCHEDULE,
                                           iterations=iters + 1))
    t0 = time.perf_counter()
    rstate, rstacks = loop.train(
        scene, ModelParams(sh_degree=2), resume_opt, PipelineParams(),
        os.path.join(out, "resume"), save_iterations=(), test_iterations=(),
        start_checkpoint=ck, quiet=True, seed=24, log_every=1, device=dev)
    torch.cuda.synchronize()
    resume_launches = launch_counts()
    rlog = read_jsonl(os.path.join(out, "resume", "train_log.jsonl"))
    rec["resume"] = {
        "s": time.perf_counter() - t0, "launches": resume_launches,
        "logged": [{k: m[k] for k in ("iter", "image_loss", "psnr",
                                      "points", "nonfinite_grads")}
                   for m in rlog],
        "depth_cache_views": int((rstacks["depths"].flatten(1).amax(1)
                                  > 0).sum())}
    if ([m["iter"] for m in rlog] != [iters + 1]
            or not all(math.isfinite(rlog[0][k]) for k in loop.LOSS_KEYS)
            or rlog[0]["nonfinite_grads"]):
        failures.append(f"loop: resumed step {rec['resume']['logged']}")
    geo = geo_steps(opt, n_train, iters + 1, iters + 1)
    want = kernel_launches(1 + n_train, 1, geo, geo)
    if resume_launches != want:
        failures.append(f"loop: resume launches {resume_launches}, expected "
                        f"{want}")
    if rec["resume"]["depth_cache_views"] != n_train:
        failures.append("loop: the depth cache was not rebuilt for every "
                        "view")
    del state, rstate, rstacks
    shutil.rmtree(os.path.join(out, "resume"), ignore_errors=True)
    return rec, run_launches, resume_launches



def eval_phase(d, dev, failures):
    """The evaluation path on the loop phase's model directory, counted:
    returns (the phase's record, the forward / backward launches of the
    counted calls)."""
    import contextlib
    import shutil
    import socket
    import struct
    import threading

    import numpy as np
    import torch
    from ibgs_tpu_torch import convert
    from ibgs_tpu_torch import render as render_cli
    from ibgs_tpu_torch.config import (ModelParams, OptimizationParams,
                                       PipelineParams)
    from ibgs_tpu_torch.eval import render_driver, tsdf, video, viewer
    from ibgs_tpu_torch.eval.metrics import evaluate_model_dir, ssim
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    from ibgs_tpu_torch.renderer import (render_depth_view, render_view,
                                         source_views_from_stacks)
    from ibgs_tpu_torch.utils import image_io

    t_phase = time.perf_counter()
    wh = SIZES[0]
    model_dir = LOOP_DIR
    it = LOOP_SCHEDULE["iterations"]
    scene = convert.bundle_eval_scene(d, wh[0], wh[1], dev)
    mp, pipe = ModelParams(sh_degree=2), PipelineParams()
    opt = OptimizationParams(**LOOP_SCHEDULE)
    pts = scene.points
    span = (pts.max(0) + 0.2 * np.ptp(pts, 0)) - (pts.min(0)
                                                   - 0.2 * np.ptp(pts, 0))
    voxel = float(span.max()) / EVAL_VOXEL_DIVISOR
    rec = {"phase": "eval", "size": f"{wh[0]}x{wh[1]}", "iteration": it,
           "test_views": len(scene.test_cameras), "train_views": scene.n_train,
           "src_image_ext": "png (no JPEG codec is assumed on the card)",
           "voxel": voxel}

    # what the path writes, recorded on the way: each PNG's float image
    # (finite?) and its truncated 8 bits; each TSDF integration's inputs
    # and time, the marching time
    written = {}
    real_save = render_driver._save_png

    def save_png(path, img):
        arr = img.detach().cpu().numpy() if torch.is_tensor(img) \
            else np.asarray(img)
        written[path] = (bool(np.isfinite(arr).all()),
                         (np.clip(arr, 0, 1) * 255).astype(np.uint8))
        real_save(path, img)

    fused = {}

    class RecordingVolume(tsdf.TSDFVolume):
        def __init__(self, lo, hi, voxel_size, **kw):
            super().__init__(lo, hi, voxel_size=voxel_size, **kw)
            fused.update(volume=self, bounds=(lo, hi, voxel_size),
                         inputs=[], ms=[])

        def integrate(self, depth, image, K, w2c, **kw):
            fused["inputs"].append(
                [x.detach().cpu().numpy() if torch.is_tensor(x)
                 else np.array(x) for x in (depth, image, K, w2c)])
            fused["ms"].append(host_ms(
                lambda: super(RecordingVolume, self).integrate(
                    depth, image, K, w2c, **kw)))

        def extract_mesh(self, **kw):
            t0 = time.perf_counter()
            out = super().extract_mesh(**kw)
            fused["marching_ms"] = (time.perf_counter() - t0) * 1e3
            return out

    reset_launch_counts()
    render_driver._save_png = save_png
    tsdf.TSDFVolume, real_volume = RecordingVolume, tsdf.TSDFVolume
    t0 = time.perf_counter()
    try:
        # the CLI's printed summary goes to stderr: stdout holds JSON lines
        with contextlib.redirect_stdout(sys.stderr):
            res = render_cli.render_model(
                scene, mp, opt, pipe, model_dir, it, render_geo=True,
                voxel_size=voxel, use_depth_filter=True,
                src_image_ext="png", device=dev)
    finally:
        render_driver._save_png = real_save
        tsdf.TSDFVolume = real_volume
    torch.cuda.synchronize()
    rec["render_model_s"] = time.perf_counter() - t0
    n_test, n_train = len(scene.test_cameras), scene.n_train
    rec["fps"] = res["fps"]
    rec["ms_per_view"] = 1e3 / res["fps"]
    rec["model_mb"], rec["memory"] = res["model_mb"], res["memory"]
    rec["n_gaussians"] = res["n_gaussians"]

    # the files: counts, finite values, each PNG's decode
    counts = {}
    for split, n in (("test", n_test), ("train", n_train)):
        for sub in ("renders", "renders_aggregate", "gt", "depth", "normal"):
            dd = os.path.join(model_dir, split, f"ours_{it}", sub)
            got = len(os.listdir(dd)) if os.path.isdir(dd) else 0
            counts[f"{split}/{sub}"] = got
            if got != n:
                failures.append(f"eval: {got} PNGs in {split}/{sub}, "
                                f"expected {n}")
    rec["png_counts"] = counts
    bad_decode = [p for p, (_, want) in written.items()
                  if not np.array_equal(image_io.read_image(p), want)]
    nonfinite = [p for p, (fin, _) in written.items() if not fin]
    rec["png_written"] = len(written)
    if bad_decode or nonfinite:
        failures.append(f"eval: PNGs decoding to other bytes {bad_decode[:3]}"
                        f", non-finite images {nonfinite[:3]}")

    # the TSDF: the card's volume against the CPU's on the same inputs
    vol = fused["volume"]
    lo, hi, vsz = fused["bounds"]
    cpu = real_volume(lo, hi, voxel_size=vsz, device="cpu")
    t0 = time.perf_counter()
    for depth, image, K, w2c in fused["inputs"]:
        cpu.integrate(depth, image, K, w2c)
    cpu_ms = (time.perf_counter() - t0) * 1e3 / max(len(fused["inputs"]), 1)
    w_card, w_cpu = vol.weight.cpu(), cpu.weight
    pos = w_cpu > 0
    off = ((vol.tsdf.cpu() - cpu.tsdf).abs() > TSDF_TOL) \
        | ((vol.color.cpu() - cpu.color).abs() > TSDF_TOL).any(-1)
    off = (off & pos) | (w_card != w_cpu)
    n_vox = w_cpu.numel()
    mesh_v, mesh_f = tsdf.load_mesh_ply(os.path.join(model_dir, "mesh.ply"))
    rec["tsdf"] = {
        "grid": list(vol.dims), "voxels": n_vox, "ms_per_integration":
        fused["ms"], "cpu_ms_per_integration": cpu_ms,
        "marching_ms": fused["marching_ms"],
        "observed_voxels": int(pos.sum()),
        "weight_mismatch_voxels": int((w_card != w_cpu).sum()),
        "off_voxels": int(off.sum()), "tolerance": TSDF_TOL,
        "max_abs_err_tsdf": float((vol.tsdf.cpu() - cpu.tsdf).abs()[pos]
                                  .max()) if pos.any() else 0.0,
        "mesh_vertices": len(mesh_v), "mesh_faces": len(mesh_f)}
    if int(off.sum()) > TSDF_MISMATCH_SHARE * n_vox:
        failures.append(f"eval: TSDF card vs CPU off on {int(off.sum())} of "
                        f"{n_vox} voxels")
    if not len(mesh_f) or not np.isfinite(mesh_v).all():
        failures.append(f"eval: mesh of {len(mesh_v)} vertices, "
                        f"{len(mesh_f)} faces, finite "
                        f"{bool(np.isfinite(mesh_v).all())}")
    del vol, cpu, fused["volume"], fused["inputs"]

    # metrics, and SSIM on the card against the CPU
    t0 = time.perf_counter()
    scores = evaluate_model_dir(model_dir, device=dev)
    rec["metrics_s"] = time.perf_counter() - t0
    rec["metrics"] = scores
    if sorted(scores) != [f"ours_{it}/renders", f"ours_{it}/renders_aggregate"]:
        failures.append(f"eval: metrics for {sorted(scores)}")
    if any(v["lpips"] is not None for v in scores.values()):
        failures.append("eval: LPIPS is not null without weights")
    base = os.path.join(model_dir, "test", f"ours_{it}")
    ssim_err = 0.0
    for split in ("renders", "renders_aggregate"):
        for nm in sorted(os.listdir(os.path.join(base, split))):
            r = (image_io.read_image(os.path.join(base, split, nm))
                 / 255.0).astype(np.float32)
            g = (image_io.read_image(os.path.join(base, "gt", nm))
                 / 255.0).astype(np.float32)
            ssim_err = max(ssim_err, abs(ssim(r, g, dev) - ssim(r, g, "cpu")))
    rec["ssim_card_vs_cpu"] = ssim_err
    if not ssim_err <= SSIM_TOL:
        failures.append(f"eval: SSIM card vs CPU {ssim_err} > {SSIM_TOL}")

    # the fly-through video and one viewer frame, from an EvalRenderer over
    # the same model and net
    model, _ = render_cli.model_from_ply(
        os.path.join(model_dir, "point_cloud", f"iteration_{it}",
                     "point_cloud.ply"), mp.sh_degree, dev)
    net, _ = render_cli.restore_net(model, opt, model_dir, dev)
    rcfg = RasterConfig(buffer_len=opt.buffer_length,
                        depth_error_threshold=opt.depth_error_threshold,
                        staircase_cull=pipe.staircase_cull)
    ev = render_driver.EvalRenderer.from_scene(model, net, scene, opt, rcfg,
                                               dev)
    t0 = time.perf_counter()
    vpath = video.render_video(ev, os.path.join(model_dir, "video.mp4"),
                               n_frames=EVAL_VIDEO_FRAMES)
    torch.cuda.synchronize()
    if os.path.isdir(vpath):           # the PNG sequence (no cv2)
        frames = len(os.listdir(vpath))
    else:                              # cv2 wrote an mp4: count its frames
        import cv2
        cap = cv2.VideoCapture(vpath)
        frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
    rec["video"] = {"path": os.path.relpath(vpath, model_dir),
                    "frames": frames, "ms_per_frame":
                    (time.perf_counter() - t0) * 1e3 / EVAL_VIDEO_FRAMES}
    if frames != EVAL_VIDEO_FRAMES:
        failures.append(f"eval: {frames} video frames written")

    cam = scene.test_cameras[0]
    wvt = cam.view.cpu().numpy().astype(np.float64).T
    wvt[:, 1] *= -1.0
    wvt[:, 2] *= -1.0
    msg = json.dumps({
        "resolution_x": wh[0], "resolution_y": wh[1], "train": True,
        "fov_x": float(d["fovx"]), "fov_y": float(d["fovy"]),
        "z_near": 0.01, "z_far": 100.0, "keep_alive": True,
        "scaling_modifier": 1.0, "view_matrix": wvt.reshape(-1).tolist(),
        "view_projection_matrix": np.eye(4).reshape(-1).tolist()}).encode()
    port = viewer.init(port=0)
    reply = {}

    def client():
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=VIEWER_TIMEOUT_S) as c:
            c.sendall(struct.pack("<i", len(msg)) + msg)
            want, buf = wh[0] * wh[1] * 3, b""
            while len(buf) < want + 4:
                chunk = c.recv(want + 4 - len(buf))
                if not chunk:
                    break
                buf += chunk
            (n,) = struct.unpack("<i", buf[want:want + 4])
            reply["image"] = buf[:want]
            reply["verify"] = c.recv(n).decode()
            reply["t"] = time.perf_counter()

    frame = {}

    def render_fn(cam, msg):
        # the training loop's viewer render: a Gaussian render at the
        # viewer's resolution with sources off
        src = source_views_from_stacks(
            ev.stacks["images"], torch.zeros_like(ev.stacks["images"][..., 0]),
            ev.stacks["w2v"], ev.stacks["centers"],
            torch.zeros(rcfg.max_src, dtype=torch.long, device=dev), 0, cam)
        img = render_view(model, cam, rcfg, torch.zeros(3, device=dev),
                          src=src, learnt_normal=opt.learnt_normal,
                          return_depth_normal=False)[0].render
        frame["bytes"] = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(
            np.uint8).tobytes()
        return img

    thread = threading.Thread(target=client, daemon=True)
    viewer_launches = {}
    try:
        before = launch_counts()
        t0 = time.perf_counter()
        thread.start()
        while "bytes" not in frame and time.perf_counter() - t0 \
                < VIEWER_TIMEOUT_S:
            viewer.serve_once(render_fn, verify="ok", device=dev)
            time.sleep(0.001)
        thread.join(timeout=VIEWER_TIMEOUT_S)
        viewer_launches = launches_since(before)
    finally:
        viewer.shutdown()
    ok = (not thread.is_alive() and reply.get("verify") == "ok"
          and reply.get("image") == frame.get("bytes"))
    rec["viewer"] = {"ms": (reply["t"] - t0) * 1e3 if "t" in reply else None,
                     "bytes": len(reply.get("image", b"")), "ok": ok,
                     "launches": viewer_launches}
    if not ok:
        failures.append("eval: the viewer frame did not come back intact")
    launches = launch_counts()

    # the bundle model's source depths at the ring cameras against the
    # bundle's cached ones (uncounted)
    bundle = convert.bundle_scene(d, wh[0], wh[1], dev)
    agree = []
    for i in range(bundle["count"]):
        dd = render_depth_view(bundle["model"], scene.train_cameras[1 + i],
                               rcfg, opt.learnt_normal)
        ref = bundle["src_depths"][i]
        has = ref > 0
        ok_px = ((dd - ref).abs() <= 0.01 * ref) & has
        agree.append(round(float(ok_px.sum()) / max(int(has.sum()), 1), 4))
    rec["src_depth_agree_1pct_ring"] = agree

    # each rendered view: its source depths and one render_geo render with
    # the warp; the viewer frame: one render_geo render
    per_view = opt.number_src_frames + 1
    views = ((EVAL_FPS_LOOPS + 1) * n_test + n_test + 2 * n_train
             + EVAL_VIDEO_FRAMES)
    want = kernel_launches(per_view * views + 1, 0, views + 1, 0)
    rec["launches"], rec["launches_expected"] = launches, want
    if launches != want:
        failures.append(f"eval: kernel launches {launches}, expected {want}")
    if not all(math.isfinite(rec[k]) for k in ("fps", "model_mb", "memory")):
        failures.append(f"eval: fps / model_mb / memory {rec['fps']}, "
                        f"{rec['model_mb']}, {rec['memory']}")
    # the drivers phase evaluates geometry on this mesh
    shutil.copyfile(os.path.join(model_dir, "mesh.ply"), EVAL_MESH)
    shutil.rmtree(model_dir, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec, launches


def parallel_phase(d, dev, scenes, inputs, opt, rcfg, failures):
    """Row bands, the Gaussian-sharded step and the mesh loop, counted:
    returns (the phase's record, the launches of the phase).  `inputs`
    maps each size to the train phase's (state, sources)."""
    import copy
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from ibgs_tpu_torch import convert
    from ibgs_tpu_torch.config import OptimizationParams
    from ibgs_tpu_torch.data import dataset
    from ibgs_tpu_torch.models.gaussians import PARAM_FIELDS, lr_tree
    from ibgs_tpu_torch.ops import blend
    from ibgs_tpu_torch.ops.rasterize import prepare, rasterize
    from ibgs_tpu_torch.parallel import distributed, gsp, sharding
    from ibgs_tpu_torch.train import __main__ as train_cli
    from ibgs_tpu_torch.train import checkpoint, trainer

    rec = {"phase": "parallel"}
    # the launches of the parallel path: counted around the band renders,
    # the GSP steps and the CLI run only, never around the full-frame and
    # single-chip references
    launches = {k: 0 for k in launch_counts()}

    def count(before):
        for k, v in launches_since(before).items():
            launches[k] += v

    # ---- bands: stitched against the full frame ---------------------------
    def render(model, cam, src, row0=None, rows=None):
        nw, off = model.oriented_normal(cam.cam_pos, learnt=opt.learnt_normal)
        return rasterize(
            xyz=model.params.xyz, scale=model.scale, quat=model.quat_unit,
            opacity=model.opacity, sh_coeffs=model.sh_coeffs,
            active_sh_degree=model.active_sh_degree, normal_world=nw,
            plane_offset=off, cam=cam, bg=torch.zeros(3, device=dev),
            cfg=rcfg, src=src, alive=model.alive, render_geo=True,
            viewport_row0=row0, viewport_rows=rows)

    rec["bands"] = {}
    band_before = launch_counts()
    for wh in SIZES:
        sc, src = scenes[wh], inputs[wh][1]
        n_bands = wh[1] // PAR_BAND_ROWS
        with torch.no_grad():
            full = render(sc["model"], sc["cam"], src)
            torch.cuda.synchronize()
            before = launch_counts()
            bands = [render(sc["model"], sc["cam"], src, b * PAR_BAND_ROWS,
                            PAR_BAND_ROWS) for b in range(n_bands)]
            torch.cuda.synchronize()
            count(before)
        r = {"bands": n_bands, "rows": PAR_BAND_ROWS,
             "band_instances": [b.n_instances for b in bands],
             "full_instances": full.n_instances}
        for f in ("render", "final_t", "median_depth", "n_contrib"):
            a = torch.cat([getattr(b, f) for b in bands])
            ref = getattr(full, f)
            if f == "n_contrib":
                bad = int((a != ref).sum())
                r["n_contrib_mismatch"] = bad
                ok = bad == 0
            else:
                err = (a - ref).abs()
                r[f + "_max_abs_err"] = float(err.max())
                ok = bool((err <= BAND_ATOL + BAND_RTOL * ref.abs()).all()
                          and torch.isfinite(a).all())
            if not ok:
                failures.append(f"parallel: stitched {f} at {wh} differs "
                                f"from the full frame")
        rec["bands"][f"{wh[0]}x{wh[1]}"] = r

    # the last 960x544 band with a backward through the blend and the warp:
    # the kernels' arguments (row0 272)
    wh = SIZES[0]
    sc, src = scenes[wh], inputs[wh][1]
    row0 = wh[1] - PAR_BAND_ROWS
    model = sc["model"]
    leaves = dataclasses.replace(model, params=type(model.params)(**{
        k: getattr(model.params, k).detach().requires_grad_(True)
        for k in PARAM_FIELDS}))
    with recording() as recorded:
        before = launch_counts()
        res = render(leaves, sc["cam"], src, row0, PAR_BAND_ROWS)
        loss = (res.render.sum() + (res.median_depth ** 2).mean()
                + res.ibr.warped_image.abs().mean())
        torch.autograd.grad(loss, [leaves.params.xyz, leaves.params.sh_dc])
        torch.cuda.synchronize()
        count(before)
    # the band renders alone: the full frames are counted out
    rec["bands_launches"] = {k: launches[k] for k in launches}
    n_bands = sum(w[1] // PAR_BAND_ROWS for w in SIZES)
    want = kernel_launches(n_bands + 1, 1, n_bands + 1, 1)
    full_frames = {k: v - launches[k]
                   for k, v in launches_since(band_before).items()}
    if full_frames != kernel_launches(len(SIZES), 0, len(SIZES), 0):
        failures.append(f"parallel: full-frame reference launches "
                        f"{full_frames}")
    if rec["bands_launches"] != want:
        failures.append(f"parallel: band launches {rec['bands_launches']}, "
                        f"expected {want}")

    # ---- GSP at world size 1 (NCCL on the card) ----------------------------
    gsp_launches = {k: 0 for k in launches}
    mesh = distributed.global_mesh(1, 1, ("dp", "gs"), dev)
    state0, src0 = inputs[wh]
    cam, gt = sc["cam"], sc["gt"]
    phase = trainer.StepPhase(render_geo=True, use_aggregation=True)
    args = (ITER_GEO, torch.zeros(3, device=dev), False, 1.0, NET_LR)

    def single_path():
        st = copy.deepcopy(state0)
        step = trainer.make_train_step(opt, rcfg, st.net, phase)
        return st, lambda s: step(s, cam, 0, gt, src0, *args)

    def gsp_path(cap_local, cap_e):
        st = copy.deepcopy(state0)
        st = dataclasses.replace(st, model=gsp.shard_model(st.model, mesh))
        step = gsp.gsp_full_train_step(opt, rcfg, st.net, phase, mesh,
                                       wh[0], wh[1], cap_local, cap_e)
        ca, srcs = sharding._cam_stack([cam]), sharding.stack_sources([src0])
        return st, lambda s: step(s, ca, [0], gt[None], srcs, *args)

    first, times = {}, {}
    n_inst = None
    for name in ("single", "fast", "generic"):
        if name == "single":
            st, fn = single_path()
        elif name == "fast":           # exact caps: the identity exchange
            st, fn = gsp_path(0, 0)
        else:                          # exchange_cap < cap_local, no drop
            st, fn = gsp_path(2 * n_inst, n_inst)
        holder = {}
        torch.cuda.synchronize()
        before = launch_counts()
        st, aux = fn(st)
        torch.cuda.synchronize()
        first[name] = (st, aux)
        n_inst = n_inst or aux["n_instances"]
        holder["s"] = st

        def again():
            holder["s"], _ = fn(holder["s"])
        times[name] = median_range([host_ms(again)
                                    for _ in range(STEP_REPEATS)])
        torch.cuda.synchronize()
        if name != "single":              # the reference is counted out
            for k, v in launches_since(before).items():
                gsp_launches[k] += v
            count(before)
    del holder
    rec["gsp"] = {"size": f"{wh[0]}x{wh[1]}", "iteration": ITER_GEO,
                  "n_instances": n_inst, "ms_per_step": times,
                  "exchange_overhead_ms": {
                      k: times[k]["median"] - times["single"]["median"]
                      for k in ("fast", "generic")}}
    one_s, one = first["single"]
    lrs = lr_tree(trainer.make_lr_config(opt), ITER_GEO,
                  one_s.spatial_lr_scale)
    for name in ("fast", "generic"):
        st, aux = first[name]
        r = {"n_overflow": int(aux["n_overflow"]),
             "nonfinite_grads": int(aux["nonfinite_grads"]), "loss": {},
             "param_max_diff_over_lr": {}}
        for k in TRAIN_AUX:
            a, b = float(one[k]), float(aux[k])
            r["loss"][k] = [a, b]
            if not abs(a - b) <= GSP_LOSS_RTOL * max(abs(a), 1.0):
                failures.append(f"parallel: gsp {name} {k} {b} against the "
                                f"single-chip step's {a}")
        for f in PARAM_FIELDS:
            a = getattr(one_s.model.params, f)
            b = getattr(st.model.params, f)
            if a.numel() == 0:
                continue
            diff = (a - b).abs()
            lr = getattr(lrs, f)
            r["param_max_diff_over_lr"][f] = float(diff.max()) / lr
            if (float(diff.max()) > GSP_LR_BOUND * lr
                    or float((diff > 1e-6).float().mean()) >= GSP_SHARE):
                failures.append(f"parallel: gsp {name} {f} off the "
                                f"single-chip step by {float(diff.max())}")
        if r["n_overflow"] or r["nonfinite_grads"]:
            failures.append(f"parallel: gsp {name} {r}")
        rec["gsp"][name] = r
    fast, gen = first["fast"][0].model, first["generic"][0].model
    same = all(torch.equal(getattr(getattr(fast, t), f),
                           getattr(getattr(gen, t), f))
               for t in ("params", "mu", "nu") for f in PARAM_FIELDS)
    rec["gsp"]["fast_generic_bit_identical"] = same
    if not same:
        failures.append("parallel: the fast and generic exchange paths "
                        "differ (first moments = 0.1 x gradient)")
    rec["gsp_launches"] = gsp_launches
    n_steps = 2 * (1 + STEP_REPEATS)      # render_geo steps
    want = kernel_launches(n_steps, n_steps, n_steps, n_steps)
    if rec["gsp_launches"] != want:
        failures.append(f"parallel: gsp launches {rec['gsp_launches']}, "
                        f"expected {want}")
    del first, one_s, one, fast, gen, mesh

    # ---- the loop through the CLI on a 1 x 1 mesh ---------------------------
    n_train = convert.bundle_train_scene(d, wh[0], wh[1], dev).n_train
    before = launch_counts()
    out = PAR_LOOP_DIR
    shutil.rmtree(out, ignore_errors=True)
    iters = PAR_LOOP_SCHEDULE["iterations"]
    argv = ["-s", "bench_bundle.npz", "-m", out, "--gsp_shards", "1",
            "--device", str(dev), "--quiet", "--test_iterations",
            *map(str, PAR_LOOP_EVALS), "--save_iterations", str(iters),
            "--checkpoint_iterations", str(iters)]
    for k, v in PAR_LOOP_SCHEDULE.items():
        argv += [f"--{k}", str(v)]
    # the bundle's 5 views stand for a scene directory
    load_scene = dataset.load_scene
    dataset.load_scene = lambda *a, **k: convert.bundle_train_scene(
        d, wh[0], wh[1], dev)
    t0 = time.perf_counter()
    try:
        printed = io.StringIO()
        stdout, sys.stdout = sys.stdout, printed
        try:
            code = train_cli.main(argv)
        finally:
            sys.stdout = stdout
    finally:
        dataset.load_scene = load_scene
    torch.cuda.synchronize()
    loop_launches = launches_since(before)
    count(before)
    log = read_jsonl(os.path.join(out, "train_log.jsonl"))
    events = read_jsonl(os.path.join(out, "densify_log.jsonl"))
    # the evaluation's mean train-view PSNR, as the CLI prints it
    psnr = {int(it): float(v) for it, v in re.findall(
        r"\[ITER (\d+)\] Evaluating train: PSNR (\S+)",
        printed.getvalue())}
    rec["loop"] = {"s": time.perf_counter() - t0, "exit_code": code,
                   "schedule": PAR_LOOP_SCHEDULE, "launches": loop_launches,
                   "densify": events, "eval_psnr": psnr}
    evals = LOOP_EVAL_VIEWS * len(PAR_LOOP_EVALS)
    geo = geo_steps(OptimizationParams(**PAR_LOOP_SCHEDULE), n_train, 1,
                    iters)
    want = kernel_launches(iters + evals, iters, geo + evals, geo)
    rec["loop"]["launches_expected"] = want
    if code != 0 or [m["iter"] for m in log] != [1]:
        failures.append(f"parallel: the CLI run exited {code} with "
                        f"{len(log)} logged iterations")
    p1, p2, p3, p4 = (psnr.get(it, math.nan) for it in PAR_LOOP_EVALS)
    if not all(math.isfinite(m["image_loss"]) and not m["nonfinite_grads"]
               for m in log) or not (p2 > p1 and p4 > p3):
        failures.append(f"parallel: CLI evaluation PSNR {psnr}")
    if loop_launches != want:
        failures.append(f"parallel: CLI launches {loop_launches}, expected "
                        f"{want}")
    if not events or not all(e.get("gsp_shards") == 1 for e in events):
        failures.append(f"parallel: densify did not run through "
                        f"gsp_densify_fn: {events}")

    # the checkpoint holds the run's final model: its alive rows are the
    # PLY's rows bit for bit, and a save of the loaded state writes the
    # same arrays
    from ibgs_tpu_torch.data import ply
    ck = os.path.join(out, f"chkpnt{iters}.npz")
    template = trainer.TrainState(
        model=inputs[wh][0].model, app_ab=inputs[wh][0].app_ab,
        app_opt=inputs[wh][0].app_opt, net=copy.deepcopy(inputs[wh][0].net),
        net_opt=None, spatial_lr_scale=1.0)
    loaded, ck_it = checkpoint.load_state(template, ck)
    raw = dict(np.load(ck))
    again = checkpoint.state_arrays(loaded)
    same = ck_it == iters and all(
        again[k].tobytes() == raw[k].tobytes() for k in again)
    alive = raw["alive"]
    pl = ply.load_gaussian_ply(os.path.join(
        out, "point_cloud", f"iteration_{iters}", "point_cloud.ply"))
    same = same and np.array_equal(pl["xyz"], raw["params.xyz"][alive])
    same = same and all(np.isfinite(v).all() for k, v in raw.items()
                        if v.dtype.kind == "f")
    rec["loop"]["checkpoint_bit_exact"] = same
    if not same:
        failures.append("parallel: the CLI's checkpoint does not reload "
                        "bit-exact to its PLY, or holds a non-finite value")
    del loaded, template

    # ---- both kernels against their plain versions on the last band ------
    pr = prepare(xyz=model.params.xyz, scale=model.scale,
                 quat=model.quat_unit, opacity=model.opacity,
                 sh_coeffs=model.sh_coeffs,
                 active_sh_degree=model.active_sh_degree,
                 **dict(zip(("normal_world", "plane_offset"),
                            model.oriented_normal(sc["cam"].cam_pos,
                                                  learnt=opt.learnt_normal))),
                 cam=sc["cam"], cfg=rcfg, alive=model.alive,
                 viewport_row0=row0, viewport_rows=PAR_BAND_ROWS)
    cam = sc["cam"]
    kc = {"row0": row0, "band_instances": pr.bins.n_instances, "fwd": {},
          "bwd": {}}
    fwd_err = bwd_err = 0.0
    for mode in (0, 1, 2):
        cfg = rcfg.blend_cfg(render_geo=mode == 1, depth_only=mode == 2)
        a = (pr.feats_inst, pr.bins.tile_start, pr.bins.tile_stop, pr.Wp,
             pr.Hp, cam.fx, cam.fy, cam.cx, cam.cy, cfg, row0)
        k_out, p_out = blend.blend_fwd_cuda(*a), blend.blend_plain(*a)
        torch.cuda.synchronize()
        kc["fwd"][MODE_NAMES[mode]], e = gate_fwd(
            k_out, p_out, f"parallel: band blend_fwd {MODE_NAMES[mode]}",
            failures)
        fwd_err = max(fwd_err, e)
    *head, saved, cts, r0 = recorded["blend_bwd"][0]
    saved = type(saved)(*(getattr(saved, f).detach() for f in FIELDS))
    cts = tuple(c.detach() for c in cts)
    head[0] = head[0].detach()
    k1 = blend.blend_bwd_cuda(*head, saved, cts, r0)
    k2 = blend.blend_bwd_cuda(*head, saved, cts, r0)
    p = blend.blend_bwd_plain(*head, saved, cts, r0)
    torch.cuda.synchronize()
    kc["bwd"]["render_geo"], bwd_err = gate_bwd(
        k1, k2, p, "parallel: band blend_bwd render_geo", failures)
    if r0 != row0:
        failures.append(f"parallel: the band's backward ran at row0 {r0}")
    # the warp on the same band: its rays start at image row 272
    wa, intr, wcts = warp_args(recorded["warp_fwd"][0],
                               recorded["warp_bwd"][0])
    first_row = float(wa[5][0, 0]) * intr[1] + intr[3]
    if len(recorded["warp_fwd"]) != 1 or abs(first_row - row0) > 1e-3:
        failures.append(f"parallel: the band's warp ran "
                        f"{len(recorded['warp_fwd'])} times, its rays from "
                        f"row {first_row}")
    kc["warp"], warp_err = gate_warp_pair(
        wa, intr, wcts, "parallel: band warp", failures,
        images=recorded["rgb10_pack"][0][0])
    kc["max_abs_err"] = {"blend_fwd": fwd_err, "blend_bwd": bwd_err,
                         **warp_err}
    rec["band_kernels"] = kc
    return rec, launches


@contextlib.contextmanager
def plain_blend():
    """Route every kernel wrapper (blend, warp, projection, binning, SSIM)
    to its plain version on the card, so a run takes its plain path on the
    same device and inputs."""
    from ibgs_tpu_torch.ops import binning, blend, epilogue
    from ibgs_tpu_torch.ops import preprocess as pre
    from ibgs_tpu_torch.ops import ssim as tssim
    from ibgs_tpu_torch.train import losses
    kernels = (blend.blend_fwd_cuda, blend.blend_bwd_cuda,
               epilogue.rgb10_pack_cuda, epilogue.warp_fwd_cuda,
               epilogue.warp_bwd_cuda, pre.preprocess_fwd_cuda,
               pre.preprocess_bwd_cuda, binning.bin_staircase_cuda,
               tssim.ssim_map_cuda)
    blend.blend_fwd_cuda, blend.blend_bwd_cuda = (blend.blend_plain,
                                                  blend.blend_bwd_plain)
    epilogue.rgb10_pack_cuda = epilogue.pack_rgb10_rows
    epilogue.warp_fwd_cuda = epilogue.warp_views_plain
    epilogue.warp_bwd_cuda = epilogue.warp_views_bwd_plain
    pre.preprocess_fwd_cuda = pre.preprocess_fwd_plain
    pre.preprocess_bwd_cuda = pre.preprocess_bwd_plain
    binning.bin_staircase_cuda = binning.bin_staircase_plain
    tssim.ssim_map_cuda = losses.ssim_map_plain
    try:
        yield
    finally:
        (blend.blend_fwd_cuda, blend.blend_bwd_cuda,
         epilogue.rgb10_pack_cuda, epilogue.warp_fwd_cuda,
         epilogue.warp_bwd_cuda, pre.preprocess_fwd_cuda,
         pre.preprocess_bwd_cuda, binning.bin_staircase_cuda,
         tssim.ssim_map_cuda) = kernels


@contextlib.contextmanager
def recording():
    """Record the arguments of every blend backward, rgb10 pack, warp
    forward and backward and projection forward and backward launch while
    the block runs: yields {name: [args, ...]}."""
    from ibgs_tpu_torch.ops import blend, epilogue
    from ibgs_tpu_torch.ops import preprocess as pre
    seen = {"blend_bwd": [], "rgb10_pack": [], "warp_fwd": [],
            "warp_bwd": [], "preprocess_fwd": [], "preprocess_bwd": []}
    slots = ((blend, "blend_bwd_cuda", "blend_bwd"),
             (epilogue, "rgb10_pack_cuda", "rgb10_pack"),
             (epilogue, "warp_fwd_cuda", "warp_fwd"),
             (epilogue, "warp_bwd_cuda", "warp_bwd"),
             (pre, "preprocess_fwd_cuda", "preprocess_fwd"),
             (pre, "preprocess_bwd_cuda", "preprocess_bwd"))
    kernels = [getattr(mod, attr) for mod, attr, _ in slots]

    def recorder(fn, name):
        def call(*a):
            seen[name].append(a)
            return fn(*a)
        return call
    for (mod, attr, name), fn in zip(slots, kernels):
        setattr(mod, attr, recorder(fn, name))
    try:
        yield seen
    finally:
        for (mod, attr, _), fn in zip(slots, kernels):
            setattr(mod, attr, fn)


def drivers_phase(dev, failures):
    """The port's drivers on the card: the production run at 1M seeds
    through `scripts/train_runs` (in process), the bundle it writes served
    once, the suite runner on the COLMAP fixture (subprocesses: their
    launches are the child processes' and are not counted), the snapshot
    replay and the example against their plain paths, and eval_geometry on
    the eval phase's mesh.  Returns (the phase's record, the launches of
    the production run and the bundle's served view)."""
    import shutil

    import numpy as np
    import torch
    from ibgs_tpu_torch import convert
    from ibgs_tpu_torch.config import OptimizationParams
    from ibgs_tpu_torch.eval.render_driver import EvalRenderer
    from ibgs_tpu_torch.examples import render_synthetic as example
    from ibgs_tpu_torch.models import gaussians
    from ibgs_tpu_torch.models.aggregation import (ColorFusionResidualNet,
                                                   init_fusion_net)
    from ibgs_tpu_torch.ops.rasterize import RasterConfig, prepare
    from ibgs_tpu_torch.renderer import source_views_from_stacks
    from ibgs_tpu_torch.scripts import eval_geometry, replay_snapshot
    from ibgs_tpu_torch.scripts import train_runs
    from ibgs_tpu_torch.utils import native

    t_phase = time.perf_counter()
    shutil.rmtree(DRV_DIR, ignore_errors=True)
    os.makedirs(DRV_DIR)
    rec = {"phase": "drivers"}

    # ---- the production run at 1M seed splats ------------------------------
    bundle_path = os.path.join(DRV_DIR, "bundle.npz")
    out = os.path.join(DRV_DIR, "prod")
    pl = train_runs.plan(["prod", out, "--bundle", bundle_path,
                          "--device", str(dev)] + DRV_ARGS)
    pl.opt = dataclasses.replace(pl.opt, **DRV_SCHEDULE)
    pl.train["test_iterations"] = (DRV_ITERS,)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        scene = train_runs.build_scene(pl)
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    n_seed = int(scene.points.shape[0])
    # the instance cap: just under the seed model's fewest instances over
    # the train views, so the first steps overflow it whichever view
    # comes first
    probe_cfg = RasterConfig(staircase_cull=True)
    seed_model = gaussians.init_from_points(
        scene.points, scene.colors, 2, capacity=DRV_INIT_CAPACITY,
        device=dev)
    counts = []
    with torch.no_grad():
        for cam in scene.train_cameras:
            nw, off = seed_model.oriented_normal(cam.cam_pos, learnt=True)
            counts.append(prepare(
                xyz=seed_model.params.xyz, scale=seed_model.scale,
                quat=seed_model.quat_unit, opacity=seed_model.opacity,
                sh_coeffs=seed_model.sh_coeffs,
                active_sh_degree=seed_model.active_sh_degree,
                normal_world=nw, plane_offset=off, cam=cam, cfg=probe_cfg,
                alive=seed_model.alive).bins.n_instances)
    del seed_model
    cap = min(counts) - 1
    pl.pipe = dataclasses.replace(pl.pipe, instance_cap=cap)

    knn_ms, grow_ms = [], []
    knn, grow = native.knn_mean_sq_dist_3, gaussians.grow_capacity

    def timed_knn(pts):
        t = time.perf_counter()
        r = knn(pts)
        knn_ms.append((time.perf_counter() - t) * 1e3)
        return r

    def timed_grow(model, cap_):
        holder = {}
        grow_ms.append(host_ms(lambda: holder.update(m=grow(model, cap_))))
        return holder["m"]

    native.knn_mean_sq_dist_3, gaussians.grow_capacity = timed_knn, timed_grow
    reset_launch_counts()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            res, state, stacks, _ = train_runs.run(pl, scene)
    finally:
        native.knn_mean_sq_dist_3, gaussians.grow_capacity = knn, grow
    torch.cuda.synchronize()
    run_launches = launch_counts()

    log = read_jsonl(os.path.join(out, "train_log.jsonl"))
    events = read_jsonl(os.path.join(out, "densify_log.jsonl"))
    by_it = {m["iter"]: m for m in log}
    skip = {1, 2, DRV_ITERS} | {e["iter"] for e in events}
    it_ms = [(by_it[i]["elapsed"] - by_it[i - 1]["elapsed"]) * 1e3
             for i in range(2, DRV_ITERS + 1)
             if i not in skip and i in by_it and i - 1 in by_it]
    cap_grown = [e for e in res["events"] if e["event"] == "instance_cap"]
    cap_events = [e for e in res["events"] if e["event"] == "capacity"]
    prod = {
        "seed_points": n_seed, "native_knn_min_points":
            gaussians.NATIVE_KNN_MIN_POINTS,
        "native_knn_ms": knn_ms, "scene_build_s": scene_s,
        "first_step_instances_per_view": counts, "instance_cap": cap,
        "init_capacity": DRV_INIT_CAPACITY,
        "occupancy_at_densify": (events[0]["n_alive_before"]
                                 / DRV_INIT_CAPACITY if events else None),
        "capacity_after": events[0]["capacity"] if events else None,
        "grow_capacity_ms": grow_ms, "densify": events,
        "growth_events": res["events"],
        "ms_per_iteration": dict(median_range(it_ms), counted=len(it_ms))
        if it_ms else None,
        "ms_at_growth_iterations": {
            i: (by_it[i]["elapsed"] - by_it.get(i - 1, {"elapsed": 0.0})[
                "elapsed"]) * 1e3 for i in sorted(skip - {DRV_ITERS})
            if i in by_it},
        "wall_s": res["wall_s"], "it_per_s": res["it_per_s"],
        "psnr_first_last": [log[0]["psnr"], log[-1]["psnr"]],
        "evaluations": res["evaluations"], "points_final":
            res["points_final"],
        "max_memory_allocated": res.get("max_memory_allocated"),
        "max_memory_reserved": res.get("max_memory_reserved"),
        "launches": run_launches}
    rec["prod"] = prod
    if not (n_seed > gaussians.NATIVE_KNN_MIN_POINTS and len(knn_ms) == 1):
        failures.append(f"drivers: the init of {n_seed} seeds took the "
                        f"native KNN {len(knn_ms)} times, expected once")
    if not cap_grown:
        failures.append("drivers: the instance cap did not grow")
    if not (cap_events and events and events[0]["capacity"]
            > DRV_INIT_CAPACITY and prod["occupancy_at_densify"] > 0.9
            and grow_ms):
        failures.append(f"drivers: no capacity growth at the densify "
                        f"event: {events} {cap_events}")
    bad = [m["iter"] for m in log if m["nonfinite_grads"]
           or not all(math.isfinite(m[k]) for k in
                      ("image_loss", "normal_loss", "photo_loss",
                       "agg_loss", "psnr"))]
    if bad or sorted(by_it) != list(range(1, DRV_ITERS + 1)):
        failures.append(f"drivers: non-finite or missing iterations {bad}")
    if not log[-1]["psnr"] > log[0]["psnr"]:
        failures.append(f"drivers: PSNR {log[0]['psnr']} at iteration 1, "
                        f"{log[-1]['psnr']} at {DRV_ITERS}")
    geo = geo_steps(pl.opt, scene.n_train, 1, DRV_ITERS)
    want = kernel_launches(DRV_ITERS + DRV_EVAL_VIEWS, DRV_ITERS,
                           geo + DRV_EVAL_VIEWS, geo)
    prod["launches_expected"] = want
    if run_launches != want:
        failures.append(f"drivers: production run launches {run_launches}, "
                        f"expected {want}")

    # ---- a snapshot of the run's model with one poisoned row ---------------
    opt = pl.opt
    cam_idx = 0
    cam = scene.train_cameras[cam_idx]
    nb = list(scene.nearest_ids[cam_idx][:opt.number_src_frames])
    idx = np.zeros(5, np.int64)
    idx[:len(nb)] = nb
    src = source_views_from_stacks(
        stacks["images"], stacks["depths"], stacks["w2v"], stacks["centers"],
        torch.as_tensor(idx).to(dev), len(nb), cam)
    m = state.model
    params = {k: getattr(m.params, k).detach().cpu().numpy()
              for k in gaussians.PARAM_FIELDS}
    alive = m.alive.cpu().numpy()
    # the alive row nearest the view's centre ray, poisoned, in every
    # DRV_REPLAY_STRIDE-th alive row of the run's model
    pc = params["xyz"] @ cam.view[:3, :3].cpu().numpy().T \
        + cam.view[:3, 3].cpu().numpy()
    off = np.hypot(pc[:, 0], pc[:, 1]) / np.maximum(pc[:, 2], 1e-6)
    off[~alive | (pc[:, 2] <= 0.2)] = np.inf
    keep = np.union1d(np.flatnonzero(alive)[::DRV_REPLAY_STRIDE],
                      [int(np.argmin(off))])
    row = int(np.searchsorted(keep, int(np.argmin(off))))
    snap = {k: v[keep] for k, v in params.items()}
    snap["log_scale"][row, 0] = np.nan
    snap.update(iter=DRV_ITERS, cam_idx=cam_idx, src_idx=idx,
                alive=np.ones(len(keep), bool),
                gt=stacks["images"][cam_idx].cpu().numpy(),
                bg=np.zeros(3, np.float32),
                src_images=src.images.cpu().numpy(),
                src_depths=src.depths.cpu().numpy(),
                src_ref_to_src=src.ref_to_src.cpu().numpy(),
                src_cam_pos=src.cam_pos.cpu().numpy(), src_count=len(nb),
                burned_in=0.5, use_app=False, nonfinite_grads=0)
    snap_path = os.path.join(DRV_DIR, "snapshot_fw.npz")
    np.savez(snap_path, **snap)
    del state, stacks, m, src, params
    torch.cuda.empty_cache()

    # ---- the bundle, served once --------------------------------------------
    d = dict(np.load(bundle_path))
    wh = SIZES[0]
    sc = convert.bundle_scene(d, wh[0], wh[1], dev)
    net = init_fusion_net(ColorFusionResidualNet(
        32, opt.feat_aggregate_mode), torch.Generator().manual_seed(0))
    ev = EvalRenderer(sc["model"], net, sc["images"], sc["w2v"],
                      sc["centers"], sc["train_cameras"], OptimizationParams(),
                      RasterConfig(staircase_cull=True), device=dev)
    before = launch_counts()
    o = ev.render_one(sc["cam"], list(range(sc["count"])))
    torch.cuda.synchronize()
    serve_launches = launches_since(before)
    finite = all(bool(torch.isfinite(v).all()) for v in o.values()
                 if torch.is_tensor(v) and v.is_floating_point())
    rec["bundle"] = {"bytes": os.path.getsize(bundle_path),
                     "splats": int(d["xyz"].shape[0]),
                     "src_count": int(d["src_count"]), "finite": finite,
                     "launches": serve_launches,
                     "n_instances": o["n_instances"]}
    if not finite or serve_launches != kernel_launches(5, 0, 1, 0) \
            or int(d["xyz"].shape[0]) != res["points_final"]:
        failures.append(f"drivers: bundle {rec['bundle']}")
    del ev, sc, o, d
    launches = launch_counts()

    # ---- replay: the kernels against the plain path ------------------------
    d = dict(np.load(snap_path))
    reps = {}
    for name in ("kernel", "plain"):
        t0 = time.perf_counter()
        with (plain_blend() if name == "plain" else contextlib.nullcontext()):
            reps[name] = replay_snapshot.replay(d, cam, dev)
        torch.cuda.synchronize()
        reps[name]["s"] = time.perf_counter() - t0
    counts_of = {name: {t: (r["leaves"], r["screen"], len(r["rows"]))
                        for t, r in rep["terms"].items()}
                 for name, rep in reps.items()}
    rec["replay"] = {"rows": len(keep), "row": row,
                     "kernel": counts_of["kernel"],
                     "plain": counts_of["plain"],
                     "s": {k: reps[k]["s"] for k in reps},
                     "input_nonfinite": {k: h["nonfinite"] for k, h in
                                         reps["kernel"]["input"].items()}}
    if counts_of["kernel"] != counts_of["plain"] or not any(
            row in r["rows"] for r in reps["kernel"]["terms"].values()):
        failures.append(f"drivers: replay {rec['replay']}")
    del reps, d, scene
    torch.cuda.empty_cache()

    # ---- the example: kernels against the plain path -----------------------
    ex = example.grid_scene(device=dev)
    k_out = example.render(ex)
    with plain_blend():
        p_out = example.render(ex)
    torch.cuda.synchronize()
    err, ex_ok = {}, True
    for f in ("render", "median_depth", "normal", "final_t"):
        a, b = getattr(k_out, f), getattr(p_out, f)
        e = (a - b).abs()
        err[f] = float(e.max())
        ex_ok &= bool((e <= TOL_ABS + TOL_REL * b.abs()).all()
                      and torch.isfinite(a).all())
    mism = int((k_out.n_contrib != p_out.n_contrib).sum())
    gx = example.xyz_grad(ex)
    rec["example"] = {"max_abs_err": err, "n_contrib_mismatch": mism,
                      "n_instances": k_out.n_instances,
                      "grad_finite": bool(torch.isfinite(gx).all()),
                      "grad_max": float(gx.abs().max())}
    if not ex_ok or mism > INT_MISMATCH_SHARE * k_out.n_contrib.numel() \
            or not rec["example"]["grad_finite"]:
        failures.append(f"drivers: example {rec['example']}")

    # ---- the suite runner on the COLMAP fixture ----------------------------
    suite_out = os.path.join(DRV_DIR, "suite")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ibgs_tpu_torch.exp_script", "--data_root",
         os.path.join(ROOT, "tests", "fixtures"), "--out_root", suite_out,
         "--scenes", "mini_colmap", "--device", str(dev), "--extra",
         *DRV_SUITE_EXTRA], cwd=ROOT, capture_output=True, text=True,
        timeout=DRV_SUITE_TIMEOUT_S)
    scene_dir = os.path.join(suite_out, "custom", "mini_colmap")
    files = {f: os.path.exists(os.path.join(scene_dir, f)) for f in (
        "result_fps_mem.json", "results_renders.json",
        "results_renders_aggregate.json", "per_view_renders.json")}
    psnr = {}
    for f in ("results_renders.json", "results_renders_aggregate.json"):
        if files[f]:
            with open(os.path.join(scene_dir, f)) as fh:
                (vals,) = json.load(fh).values()
            psnr[f] = vals["PSNR"]
    rec["suite"] = {"rc": proc.returncode, "s": time.perf_counter() - t0,
                    "files": files, "psnr": psnr,
                    "stderr_tail": proc.stderr[-400:]
                    if proc.returncode else ""}
    if proc.returncode or not all(files.values()) or len(psnr) != 2 or \
            not all(math.isfinite(v) and v > 5.0 for v in psnr.values()):
        failures.append(f"drivers: suite runner {rec['suite']}")

    # ---- eval_geometry on the eval phase's mesh ----------------------------
    from ibgs_tpu_torch.eval import tsdf
    verts, faces = tsdf.load_mesh_ply(EVAL_MESH)
    shifted = os.path.join(DRV_DIR, "mesh_shifted.ply")
    tsdf.save_mesh_ply(shifted, verts + np.array(
        [DRV_CHAMFER_SHIFT, 0.0, 0.0], np.float32), faces)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        same = eval_geometry.main(["chamfer", "--mesh", EVAL_MESH, "--gt",
                                   EVAL_MESH, "--downsample", "0"])
        moved = eval_geometry.main(["chamfer", "--mesh", shifted, "--gt",
                                    EVAL_MESH, "--downsample", "0"])
    rec["eval_geometry"] = {"vertices": len(verts), "faces": len(faces),
                            "self": same, "shift": DRV_CHAMFER_SHIFT,
                            "shifted": moved,
                            "s": time.perf_counter() - t0}
    if same["overall"] != 0.0 or abs(moved["overall"] - DRV_CHAMFER_SHIFT) \
            > 0.01 * DRV_CHAMFER_SHIFT:
        failures.append(f"drivers: eval_geometry {rec['eval_geometry']}")
    shutil.rmtree(DRV_DIR, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec, launches


def bench_phase(dev, failures):
    """The measurement drivers on the card: gsp_tax on both exchange
    paths and gsp_scaling's row at world size 1; `bench.run` on its
    default configs (train mode), the bundle in render mode, the 1M random
    scene and the traced bundle at 960x544; parse_trace on that trace;
    kernel_probe with both kernels held to their plain versions on its
    first KP_GATE_TILE_ROWS rows of tiles; perf_probe.  Returns (the
    phase's record, the launches of the four bench runs)."""
    import shutil

    import torch
    import torch.distributed as dist
    from ibgs_tpu_torch import bench
    from ibgs_tpu_torch.ops import blend
    from ibgs_tpu_torch.scripts import (gsp_scaling, gsp_tax, kernel_probe,
                                        parse_trace, perf_probe)

    t_phase = time.perf_counter()
    rec = {"phase": "bench"}
    launches = {k: 0 for k in launch_counts()}
    shutil.rmtree(BENCH_TRACE_DIR, ignore_errors=True)

    def finite(x):
        if isinstance(x, dict):
            return all(finite(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return all(finite(v) for v in x)
        return not isinstance(x, float) or math.isfinite(x)

    def run_bench(tag, argv, want_bwd):
        before = launch_counts()
        t0 = time.perf_counter()
        out = bench.run(bench.build_parser().parse_args(
            ["--device", str(dev), "--iters", str(BENCH_ITERS)] + argv))
        for k, v in launches_since(before).items():
            launches[k] += v
        out["detail"]["s"] = time.perf_counter() - t0
        rec[tag] = out
        n_bwd = BENCH_ITERS if want_bwd else 0
        want = kernel_launches(BENCH_ITERS, n_bwd, BENCH_ITERS, n_bwd)
        for row in out["detail"]["configs"]:
            got = {**row["blend_launches"], **row["warp_launches"],
                   **row["preprocess_launches"]}
            if got != want:
                failures.append(f"bench {tag} {row['config']} "
                                f"{row['resolution']}: a chain launched "
                                f"{got}, expected {want}")
            if "profile_error" in row:
                failures.append(f"bench {tag} {row['config']} "
                                f"{row['resolution']}: profile "
                                f"{row['profile_error']}")
        if not finite(out) or not out["value"] > 0:
            failures.append(f"bench {tag}: a non-finite value {out}")
        if "skipped_over_budget" in out["detail"]:
            failures.append(f"bench {tag}: skipped "
                            f"{out['detail']['skipped_over_budget']}")
        return out

    # the sharded step first (see PERF.md §7 q9)
    rec["gsp_tax"] = {}
    for generic in (False, True):
        t0 = time.perf_counter()
        argv = ["--device", str(dev)] + (["--generic"] if generic else [])
        recs = gsp_tax.run(gsp_tax.build_parser().parse_args(argv))
        u, g = recs[0], recs[1]
        rec["gsp_tax"][g["variant"]] = dict(records=recs,
                                            s=time.perf_counter() - t0)
        if not finite(recs) or not abs(u["loss"] - g["loss"]) \
                <= GSP_LOSS_RTOL * max(abs(u["loss"]), 1.0):
            failures.append(f"bench: gsp_tax {g['variant']} loss "
                            f"{g['loss']} against {u['loss']}")

    opened = not dist.is_initialized()
    t0 = time.perf_counter()
    try:
        row = gsp_scaling.rank_row(1, str(dev), True)
    finally:
        if opened and dist.is_initialized():
            dist.destroy_process_group()
    rec["gsp_scaling"] = dict(row, s=time.perf_counter() - t0)
    if not (row["exact"] and row["overflow"] == 0 and finite(row)):
        failures.append(f"bench: gsp_scaling {row}")

    out = run_bench("train", [], True)
    got = [f"{r['config']}@{r['resolution']}"
           for r in out["detail"]["configs"]]
    if got != BENCH_CONFIGS:
        failures.append(f"bench: configs {got}, expected {BENCH_CONFIGS}")
    run_bench("render", ["--ckpt", BUNDLE, "--mode", "render"], False)
    run_bench("random_1m", ["--n", "1000000", "--width", "960", "--height",
                            "544", "--repeats", "1"], True)
    run_bench("traced", ["--ckpt", BUNDLE, "--width", "960", "--height",
                         "544", "--repeats", "1", "--profile",
                         BENCH_TRACE_DIR], True)
    rec["launches"] = dict(launches)

    # parse_trace on the converged 960x544 chain: its device total is the
    # one this script reads from the same file
    traced = rec["traced"]["detail"]["configs"][0]
    path = os.path.join(BENCH_TRACE_DIR, f"converged_{traced['resolution']}",
                        "trace.json")
    t0 = time.perf_counter()
    summ = parse_trace.summarize(parse_trace.load_events(path), BENCH_ITERS,
                                 top_n=20)
    own_ms, own_n, own_lost = trace_device_ms(path)
    rec["parse_trace"] = dict(summ, s=time.perf_counter() - t0,
                              trace_bytes=os.path.getsize(path))
    if (summ["device_events"] != own_n or not summ["device_ms"] > 0
            or summ["lost_launches"] or own_lost
            or abs(summ["device_ms"] * BENCH_ITERS - own_ms)
            > 1e-9 * own_ms):
        failures.append(f"bench: parse_trace read {summ['device_ms']} ms x "
                        f"{BENCH_ITERS} in {summ['device_events']} events "
                        f"({summ['lost_launches']} lost), the trace holds "
                        f"{own_ms} ms in {own_n} ({own_lost} lost)")
    steps = [x for x in summ["spans"] if x[0] == "bench_step"]
    if not steps or steps[0][6] != BENCH_ITERS:
        failures.append(f"bench: the trace's bench_step spans {steps}")
    shutil.rmtree(BENCH_TRACE_DIR, ignore_errors=True)

    # kernel_probe: timed, then both kernels against plain on a slice
    t0 = time.perf_counter()
    rec["kernel_probe"] = kernel_probe.run(device=dev)
    pl = kernel_probe.probe_list(device=dev)
    cfg = kernel_probe.config()
    top = pl.rows(KP_GATE_TILE_ROWS)
    k_out = blend.blend_fwd_cuda(*pl.args(cfg))
    p_out = blend.blend_plain(*top.args(cfg))
    torch.cuda.synchronize()
    gate = {"tile_rows": KP_GATE_TILE_ROWS,
            "instances": int(top.stop[-1])}
    gate["fwd"], fwd_err = gate_fwd(k_out.crop(top.Hp, top.Wp), p_out,
                                    "bench: kernel_probe blend_fwd",
                                    failures)
    cts = tuple(torch.ones_like(getattr(k_out, f)) for f in
                ("color", "normal", "final_t", "buf_depth", "buf_weight"))
    k1, k2 = (blend.blend_bwd_cuda(*pl.args(cfg), k_out, cts)
              for _ in range(2))
    m = gate["instances"]
    p = blend.blend_bwd_plain(*top.args(cfg), k_out.crop(top.Hp, top.Wp),
                              tuple(c[:top.Hp] for c in cts))
    torch.cuda.synchronize()
    gate["bwd"], bwd_err = gate_bwd(k1[:m], k2[:m], p[:m],
                                    "bench: kernel_probe blend_bwd",
                                    failures)
    gate["max_abs_err"] = {"blend_fwd": fwd_err, "blend_bwd": bwd_err}
    gate["s"] = time.perf_counter() - t0
    rec["kernel_probe_gate"] = gate
    if not finite(rec["kernel_probe"]):
        failures.append(f"bench: kernel_probe {rec['kernel_probe']}")
    del pl, top, k_out, p_out, k1, k2, p, cts

    t0 = time.perf_counter()
    rec["perf_probe"] = perf_probe.run(device=dev)
    rec["perf_probe_s"] = time.perf_counter() - t0
    stages = [r for r in rec["perf_probe"]
              if r["probe"].startswith("stage_")]
    if [r["probe"] for r in stages] != list(perf_probe.STAGES) or \
            not finite(stages) or any("profile_error" in r for r in stages):
        failures.append(f"bench: perf_probe {stages}")

    rec["phase_s"] = time.perf_counter() - t_phase
    return rec, launches


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ibgs_tpu_torch import convert
    from ibgs_tpu_torch.config import OptimizationParams, PipelineParams
    from ibgs_tpu_torch.eval.render_driver import EvalRenderer
    from ibgs_tpu_torch.models.aggregation import (ColorFusionResidualNet,
                                                   init_fusion_net)
    from ibgs_tpu_torch.ops import _cuda, blend, epilogue
    from ibgs_tpu_torch.ops.rasterize import RasterConfig, prepare
    from ibgs_tpu_torch.renderer import (render_depth_view,
                                         source_views_from_stacks)
    from ibgs_tpu_torch.train import trainer

    # reference semantics: full float32 matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    failures = []

    # ---- device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    from ibgs_tpu_torch.bench import smi_line
    smi = smi_line()
    emit({"phase": "device", "name": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- build -----------------------------------------------------------
    opt, pipe = OptimizationParams(), PipelineParams()
    rcfg = RasterConfig(buffer_len=opt.buffer_length,
                        depth_error_threshold=opt.depth_error_threshold,
                        staircase_cull=pipe.staircase_cull,
                        row_cap=pipe.row_cap)
    t0 = time.time()
    logs = _cuda.build()
    cta = {}
    for name, modes, limit in (("blend_fwd", (0, 1, 2), blend.FWD_CTA),
                               ("blend_bwd", (1, 0), blend.BWD_CTA)):
        sy, sx = blend.sub_tile_split(rcfg.tile_h, rcfg.tile_w, limit)
        sub = (-(-rcfg.tile_h // sy), -(-rcfg.tile_w // sx))
        cta[name] = {"sub_tile": list(sub), "modes": {
            MODE_NAMES[m]: dict(zip(("ctas_per_sm", "threads"),
                                    _cuda.occupancy(name, m, rcfg.buffer_len,
                                                    *sub)))
            for m in modes}}
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "kernels": {name: parse_ptxas(log) for name, log in logs.items()},
          "tile": [rcfg.tile_h, rcfg.tile_w], "cta": cta})

    # ---- inputs ----------------------------------------------------------
    d = dict(np.load(BUNDLE))
    scenes = {wh: convert.bundle_scene(d, wh[0], wh[1], dev) for wh in SIZES}

    def prepared(sc):
        model, cam = sc["model"], sc["cam"]
        nw, off = model.oriented_normal(cam.cam_pos, learnt=opt.learnt_normal)
        return prepare(xyz=model.params.xyz, scale=model.scale,
                       quat=model.quat_unit, opacity=model.opacity,
                       sh_coeffs=model.sh_coeffs,
                       active_sh_degree=model.active_sh_degree,
                       normal_world=nw, plane_offset=off, cam=cam, cfg=rcfg,
                       alive=model.alive)

    def blend_args(pr, cam, mode):
        cfg = rcfg.blend_cfg(render_geo=mode == 1, depth_only=mode == 2)
        return (pr.feats_inst, pr.bins.tile_start, pr.bins.tile_stop, pr.Wp,
                pr.Hp, cam.fx, cam.fy, cam.cx, cam.cy, cfg)

    preps = {wh: prepared(scenes[wh]) for wh in SIZES}

    def range_lengths(pr):
        """p50, p99 and max of the tile range lengths."""
        lens = (pr.bins.tile_stop - pr.bins.tile_start).double()
        q = torch.quantile(lens, torch.tensor([0.5, 0.99], device=lens.device,
                                              dtype=lens.dtype))
        return {"p50": float(q[0]), "p99": float(q[1]),
                "max": int(lens.max()), "tiles": int(lens.numel())}

    # ---- blend_fwd: kernel vs plain at 960x544 -----------------------------
    wh = SIZES[0]
    pr, cam = preps[wh], scenes[wh]["cam"]
    rec = {"phase": "blend_fwd", "size": f"{wh[0]}x{wh[1]}",
           "n_instances": pr.bins.n_instances, "n_rows": pr.bins.n_rows,
           "tile_ranges": range_lengths(pr), "modes": {}}
    fwd_max_abs_err = 0.0
    pairs = {}
    for mode in (0, 1, 2):
        args = blend_args(pr, cam, mode)
        k_out = blend.blend_fwd_cuda(*args)
        p_out = blend.blend_plain(*args)
        torch.cuda.synchronize()
        m, e = gate_fwd(k_out, p_out, f"blend_fwd {MODE_NAMES[mode]}",
                        failures)
        fwd_max_abs_err = max(fwd_max_abs_err, e)
        pairs[(wh, mode)] = int(p_out.n_contrib.long().sum())
        rec["modes"][MODE_NAMES[mode]] = m
    emit(rec)

    # ---- training inputs: the port's depth pre-pass of the sources --------
    ref_view = scenes[SIZES[0]]["cam"].view.cpu().numpy()
    cam_centers = np.concatenate(
        [(-ref_view[:3, :3].T @ ref_view[:3, 3])[None],
         np.asarray(d["src_cam_pos"], np.float64)])
    extent = convert.cameras_extent(cam_centers)
    nearest = list(range(scenes[SIZES[0]]["count"]))

    def train_inputs(wh):
        sc = scenes[wh]
        net = init_fusion_net(ColorFusionResidualNet(
            32, opt.feat_aggregate_mode), torch.Generator().manual_seed(0))
        state = convert.train_state_from_numpy(
            d, net=net, spatial_lr_scale=extent, device=dev)
        with torch.no_grad():
            depths = [render_depth_view(state.model, sc["train_cameras"][i],
                                        rcfg, opt.learnt_normal)
                      for i in nearest]
        S = rcfg.max_src
        idx = torch.zeros(S, dtype=torch.long)
        idx[:len(nearest)] = torch.as_tensor(nearest)
        idx = idx.to(dev)
        dstack = torch.stack(depths + [torch.zeros_like(depths[0])]
                             * (S - len(depths)))
        src = source_views_from_stacks(
            sc["images"][idx], dstack, sc["w2v"][idx], sc["centers"][idx],
            torch.arange(S, device=dev), len(nearest), sc["cam"])
        return state, src

    train_in = {wh: train_inputs(wh) for wh in SIZES}
    phases = {1: trainer.StepPhase(render_geo=True, use_aggregation=True),
              0: trainer.StepPhase(render_geo=False, use_aggregation=False)}
    iters = {1: ITER_GEO, 0: ITER_COLOR}
    bg = torch.zeros(3, device=dev)

    def captured_bwd_args(wh, mode):
        """The blend-backward arguments of one real backward of the
        training objective (loss_and_grads) in `mode` and, in render_geo,
        the warp's (forward inputs, intrinsics, cotangents, source
        images)."""
        sc = scenes[wh]
        state, src = train_in[wh]
        with recording() as seen:
            trainer.loss_and_grads(opt, rcfg, state.net, phases[mode], state,
                                   sc["cam"], 0, sc["gt"], src, iters[mode],
                                   bg, False, 1.0)
        torch.cuda.synchronize()
        feats, start, stop, *geom, saved, cts, row0 = seen["blend_bwd"][0]
        saved = type(saved)(*(getattr(saved, f).detach() for f in FIELDS))
        # the projection's forward arguments and the backward's cotangents
        pre_fwd = tuple(a.detach() if torch.is_tensor(a) else a
                        for a in seen["preprocess_fwd"][0])
        pre_cts = tuple(None if c is None else c.detach()
                        for c in seen["preprocess_bwd"][0][-1])
        return ((feats.detach(), start, stop, *geom, saved,
                 tuple(c.detach() for c in cts), row0),
                (*warp_args(seen["warp_fwd"][0], seen["warp_bwd"][0]),
                 seen["rgb10_pack"][0][0]) if mode == 1 else None,
                (pre_fwd, pre_cts))

    captured = {(wh, mode): captured_bwd_args(wh, mode)
                for wh in SIZES for mode in (1, 0)}
    bwd_args = {k: v[0] for k, v in captured.items()}
    warp_in = {wh: captured[(wh, 1)][1] for wh in SIZES}
    pre_in = {wh: captured[(wh, 1)][2] for wh in SIZES}
    del captured

    # ---- blend_bwd: kernel vs plain at 960x544 -----------------------------
    wh = SIZES[0]
    rec = {"phase": "blend_bwd", "size": f"{wh[0]}x{wh[1]}", "modes": {}}
    bwd_max_abs_err = 0.0
    contrib_pairs = {}
    gen = torch.Generator().manual_seed(1234)
    for mode in (1, 0):
        *head, saved, real_cts, row0 = bwd_args[(wh, mode)]
        rand_cts = tuple(torch.randn(c.shape, generator=gen).to(dev)
                         for c in real_cts)
        m = {}
        for name, cts in (("real", real_cts), ("random", rand_cts)):
            k1 = blend.blend_bwd_cuda(*head, saved, cts, row0)
            k2 = blend.blend_bwd_cuda(*head, saved, cts, row0)
            stats = {}
            p = blend.blend_bwd_plain(*head, saved, cts, row0,
                                      stats=stats if name == "real" else None)
            torch.cuda.synchronize()
            if name == "real":
                contrib_pairs[(wh, mode)] = stats["contrib_pairs"]
            m[name], e = gate_bwd(k1, k2, p,
                                  f"blend_bwd {MODE_NAMES[mode]} {name}",
                                  failures)
            bwd_max_abs_err = max(bwd_max_abs_err, e)
        rec["modes"][MODE_NAMES[mode]] = m
    emit(rec)

    # ---- warp: the three kernels vs plain at both sizes --------------------
    rec = {"phase": "warp", "sizes": {}}
    warp_max_abs_err = {"rgb10_pack": 0.0, "warp_fwd": 0.0, "warp_bwd": 0.0}
    gen = torch.Generator().manual_seed(4321)
    for wh in SIZES:
        wa, intr, real_cts, images = warp_in[wh]
        rand_cts = tuple(torch.randn(c.shape, generator=gen).to(dev)
                         for c in real_cts)
        r = {"buffer": wa[0].shape[0], "sources": list(wa[2].shape[:3]),
             "buffer_strides": list(wa[0].stride())}
        for name, cts in (("real", real_cts), ("random", rand_cts)):
            r[name], errs = gate_warp_pair(
                wa, intr, cts, f"warp {wh} {name}", failures,
                images=images if name == "real" else None)
            for k, v in errs.items():
                warp_max_abs_err[k] = max(warp_max_abs_err[k], v)
        rec["sizes"][f"{wh[0]}x{wh[1]}"] = r
    rec["max_abs_err"] = warp_max_abs_err
    emit(rec)

    # ---- preprocess: the projection kernels vs plain -----------------------
    # the bundle at both sizes (the training objective's own inputs and
    # cotangents, then seeded random cotangents) and the bench's random 1M
    # scene at 960x544 (random cotangents), as strided slices of a
    # (P, 15) table, the way rasterize's table hands them back
    from ibgs_tpu_torch.bench import random_model, round_up, simple_camera
    rec = {"phase": "preprocess", "cases": {}}
    pre_max_abs_err = {"preprocess_fwd": 0.0, "preprocess_bwd": 0.0}
    gen = torch.Generator().manual_seed(2468)

    def table_cts(P):
        tab = torch.randn(P, 15, generator=gen).to(dev)
        return (tab[:, 0:2], tab[:, 2:5], tab[:, 6:9], tab[:, 9:12],
                tab[:, 12])

    scene_1m = (random_model(PRE_SCENE_N, round_up(1.31 * PRE_SCENE_N,
                                                    1024), dev),
                simple_camera(*SIZES[0], device=dev))
    pre_scenes = [(f"bundle_{w}x{h}_{kind}", pre_in[(w, h)][0],
                  pre_in[(w, h)][1] if kind == "real" else None)
                 for w, h in SIZES for kind in ("real", "random")]
    pre_scenes.append((f"random_1m_{SIZES[0][0]}x{SIZES[0][1]}",
                      preprocess_args(scene_1m[0], scene_1m[1],
                                      opt.learnt_normal, rcfg.tile_h,
                                      rcfg.tile_w), None))
    for tag, args, cts in pre_scenes:
        cts = cts if cts is not None else table_cts(args[0].shape[0])
        rec["cases"][tag], errs = gate_preprocess(
            args, cts, f"preprocess {tag}", failures)
        for k, v in errs.items():
            pre_max_abs_err[k] = max(pre_max_abs_err[k], v)
    rec["max_abs_err"] = pre_max_abs_err
    emit(rec)

    # ---- binning: the staircase binning kernels vs plain -------------------
    # the bundle at both sizes as `prepare` bins it (and at 1920x1088 with
    # row_cap at half the rows and cap at a quarter of the instances) and
    # the random 1M scene
    from ibgs_tpu_torch.ops import preprocess as pre
    with torch.no_grad():
        sp_1m = pre.preprocess(*preprocess_args(
            scene_1m[0], scene_1m[1], opt.learnt_normal, rcfg.tile_h,
            rcfg.tile_w))
    bin_in = {f"bundle_{w}x{h}": (binning_inputs(preps[(w, h)].sp),
                                  (preps[(w, h)].Wp // rcfg.tile_w,
                                   preps[(w, h)].Hp // rcfg.tile_h,
                                   rcfg.tile_h, rcfg.tile_w))
              for w, h in SIZES}
    bin_in[f"random_1m_{SIZES[0][0]}x{SIZES[0][1]}"] = (
        binning_inputs(sp_1m), (-(-SIZES[0][0] // rcfg.tile_w),
                                -(-SIZES[0][1] // rcfg.tile_h), rcfg.tile_h,
                                rcfg.tile_w))
    rec = {"phase": "binning", "cases": {}}
    for tag, ((sp, cull), grid) in bin_in.items():
        rec["cases"][tag] = gate_binning(sp, cull, grid, (0, 0), tag,
                                         failures)
    tag = f"bundle_{SIZES[1][0]}x{SIZES[1][1]}"
    free = rec["cases"][tag]
    caps = (free["n_instances"] // 4 + 1, free["n_rows"] // 2 + 1)
    rec["cases"][tag + "_caps"] = gate_binning(*bin_in[tag][0],
                                               bin_in[tag][1], caps,
                                               tag + "_caps", failures)
    emit(rec)

    # ---- ssim: the SSIM kernels against the plain chain ---------------------
    rec, ssim_cases = ssim_phase(dev, failures)
    emit(rec)

    # ---- serve: the serving path, counted ----------------------------------
    net = init_fusion_net(ColorFusionResidualNet(
        32, opt.feat_aggregate_mode), torch.Generator().manual_seed(0))
    renderers = {wh: EvalRenderer(
        sc["model"], net, sc["images"], sc["w2v"], sc["centers"],
        sc["train_cameras"], opt, rcfg, device=dev)
        for wh, sc in scenes.items()}
    from ibgs_tpu_torch.ops import binning

    def bin_launches(renders, wh):
        """The binning kernels' launches for `renders` staircase renders
        at wh: each kernel once a render, bin_radix once a sort pass (4
        for the depth order, 1-4 for the tile ids)."""
        tiles = (-(-wh[0] // rcfg.tile_w)) * (-(-wh[1] // rcfg.tile_h))
        n = renders * int(rcfg.staircase_cull)
        return {"bin_key": n, "bin_count": n, "bin_emit": n,
                "bin_ranges": n,
                "bin_radix": n * (4 + _cuda.bin_tile_passes(tiles))}
    outs, per_view, bin_view = {}, {}, {}
    reset_launch_counts()
    ssim_before = ssim_counts()
    for wh in SIZES:
        before, bin_before = launch_counts(), dict(binning.LAUNCHES)
        outs[wh] = renderers[wh].render_one(scenes[wh]["cam"], nearest)
        torch.cuda.synchronize()
        per_view[wh] = launches_since(before)
        bin_view[wh] = {k: binning.LAUNCHES[k] - bin_before[k]
                        for k in bin_before}
    serve_launches = launch_counts()
    ssim_by_path = {"serve": ssim_since(ssim_before)}
    for wh in SIZES:
        sc, out = scenes[wh], outs[wh]
        finite = all(bool(torch.isfinite(v).all()) for v in out.values()
                     if torch.is_tensor(v) and v.is_floating_point())
        if not finite:
            failures.append(f"serve {wh}: non-finite output")
        # 4 source depths and one render_geo render with the warp
        if per_view[wh] != kernel_launches(5, 0, 1, 0):
            failures.append(f"serve {wh}: kernel launches {per_view[wh]}, "
                            f"expected {kernel_launches(5, 0, 1, 0)}")
        if bin_view[wh] != bin_launches(5, wh):
            failures.append(f"serve {wh}: binning launches {bin_view[wh]}, "
                            f"expected {bin_launches(5, wh)}")

        def psnr(img):
            mse = float(((img.clamp(0, 1) - sc["gt"]) ** 2).mean())
            return 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")

        agree = []
        for i in nearest:
            dd = render_depth_view(sc["model"], sc["train_cameras"][i], rcfg,
                                   opt.learnt_normal)
            ref = sc["src_depths"][i]
            has = ref > 0
            ok = ((dd - ref).abs() <= 0.01 * ref) & has
            agree.append(float(ok.sum()) / max(int(has.sum()), 1))
        emit({"phase": "serve", "size": f"{wh[0]}x{wh[1]}",
              "finite": finite, "kernel_launches": per_view[wh],
              "binning_launches": bin_view[wh],
              "n_instances": out["n_instances"], "n_rows": out["n_rows"],
              "psnr_render": round(psnr(out["render"]), 4),
              "psnr_aggregate": round(psnr(out["aggregate"]), 4),
              "src_depth_agree_1pct": [round(a, 4) for a in agree]})

    # ---- train: the training path, counted ---------------------------------
    wh = SIZES[0]
    sc = scenes[wh]
    state, src = train_in[wh]
    steps = {mode: trainer.make_train_step(opt, rcfg, state.net, phases[mode])
             for mode in (1, 0)}

    from ibgs_tpu_torch.ops import ssim as tssim

    def run_step(state, mode):
        before, bin_before = launch_counts(), dict(binning.LAUNCHES)
        ssim_before = dict(tssim.LAUNCHES)
        state, aux = steps[mode](state, sc["cam"], 0, sc["gt"], src,
                                 iters[mode], bg, False, 1.0, NET_LR)
        torch.cuda.synchronize()
        bin_step = {k: binning.LAUNCHES[k] - bin_before[k]
                    for k in bin_before}
        if bin_step != bin_launches(1, wh):
            failures.append(f"train {MODE_NAMES[mode]}: binning launches "
                            f"{bin_step}, expected {bin_launches(1, wh)}")
        ssim_step = {k: tssim.LAUNCHES[k] - ssim_before[k]
                     for k in ssim_before}
        if ssim_step != dict.fromkeys(ssim_before, SSIM_STEP[mode]):
            failures.append(f"train {MODE_NAMES[mode]}: SSIM launches "
                            f"{ssim_step}, expected {SSIM_STEP[mode]} each")
        row = {k: float(aux[k]) for k in TRAIN_AUX}
        row.update(nonfinite_grads=int(aux["nonfinite_grads"]),
                   n_instances=aux["n_instances"], n_rows=aux["n_rows"],
                   launches=launches_since(before), ssim_launches=ssim_step)
        if not all(math.isfinite(row[k]) for k in TRAIN_AUX):
            failures.append(f"train {MODE_NAMES[mode]}: non-finite {row}")
        if row["nonfinite_grads"]:
            failures.append(f"train {MODE_NAMES[mode]}: "
                            f"{row['nonfinite_grads']} non-finite gradients")
        want = kernel_launches(1, 1, mode, mode)  # the warp in render_geo
        if row["launches"] != want:
            failures.append(f"train {MODE_NAMES[mode]}: kernel launches "
                            f"{row['launches']}, expected {want}")
        return state, row

    reset_launch_counts()
    ssim_before = ssim_counts()
    geo_rows = []
    for _ in range(TRAIN_STEPS):
        state, row = run_step(state, 1)
        geo_rows.append(row)
    geo_launches = launch_counts()
    if not geo_rows[-1]["loss"] < geo_rows[0]["loss"]:
        failures.append(f"train: loss did not fall over {TRAIN_STEPS} steps "
                        f"({geo_rows[0]['loss']} -> {geo_rows[-1]['loss']})")
    reset_launch_counts()
    state, color_row = run_step(state, 0)
    color_launches = launch_counts()
    ssim_by_path["train"] = ssim_since(ssim_before)
    train_launches = {k: geo_launches[k] + color_launches[k]
                      for k in geo_launches}
    emit({"phase": "train", "size": f"{wh[0]}x{wh[1]}",
          "render_geo_steps": geo_rows, "render_geo_launches": geo_launches,
          "color_step": color_row, "color_launches": color_launches,
          "spatial_lr_scale": extent})

    # ---- timing ------------------------------------------------------------
    fwd_cases = []
    for wh in SIZES:
        pr, cam = preps[wh], scenes[wh]["cam"]
        B = rcfg.buffer_len
        n_pix = pr.Wp * pr.Hp
        nbytes = (pr.feats_inst.shape[0] * 13 * 4
                  + 2 * pr.bins.tile_start.numel() * 4
                  + n_pix * (8 + 3 * B) * 4)
        for mode in (0, 1, 2):
            args = blend_args(pr, cam, mode)
            if (wh, mode) not in pairs:
                pairs[(wh, mode)] = int(
                    blend.blend_fwd_cuda(*args).n_contrib.long().sum())
            k_ms = cuda_ms(lambda: blend.blend_fwd_cuda(*args), 20)
            p_ms = cuda_ms(lambda: blend.blend_plain(*args), 1, warmup=0)
            t_bytes = nbytes / HBM_BYTES_S
            t_ops = pairs[(wh, mode)] * OPS_PER_PAIR / FP32_FLOP_S
            fwd_cases.append({
                "size": f"{wh[0]}x{wh[1]}", "mode": MODE_NAMES[mode],
                "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_share": max(t_bytes, t_ops) * 1e3 / k_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "pairs": pairs[(wh, mode)]})

    bwd_cases = []
    for wh in SIZES:
        for mode in (1, 0):
            *head, saved, cts, row0 = bwd_args[(wh, mode)]
            feats, B = head[0], rcfg.buffer_len
            if (wh, mode) not in contrib_pairs:
                stats = {}
                blend.blend_bwd_plain(*head, saved, cts, row0, stats=stats)
                contrib_pairs[(wh, mode)] = stats["contrib_pairs"]
            walked = int(saved.n_contrib.long().sum())
            n_pix = saved.final_t.numel()
            # saved colour, T, n_contrib and cotangents dcolour, dT per
            # pixel; render_geo adds normal, buffer weights / contributors
            # and the dnormal / dbuffer cotangents
            per_pix = 9 + (6 + 4 * B if mode == 1 else 0)
            nbytes = (feats.shape[0] * (13 + 16) * 4
                      + 2 * head[1].numel() * 4 + n_pix * per_pix * 4)
            ops = (walked * OPS_PER_PAIR
                   + contrib_pairs[(wh, mode)] * OPS_PER_CONTRIB_PAIR[mode])
            k_ms = cuda_ms(lambda: blend.blend_bwd_cuda(
                *head, saved, cts, row0), 20)
            p_ms = cuda_ms(lambda: blend.blend_bwd_plain(
                *head, saved, cts, row0), 1, warmup=0)
            t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_FLOP_S
            bwd_cases.append({
                "size": f"{wh[0]}x{wh[1]}", "mode": MODE_NAMES[mode],
                "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_share": max(t_bytes, t_ops) * 1e3 / k_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "walked_pairs": walked,
                "contrib_pairs": contrib_pairs[(wh, mode)], "ops": ops})

    warp_cases = []
    for wh in SIZES:
        wa, intr, cts, images = warp_in[wh]
        (B, H, W), (S, Hs, Ws) = wa[0].shape, wa[2].shape[:3]
        pairs, texels = B * H * W * S, S * Hs * Ws
        # each input of a kernel read once, each output written once.  The
        # pack: the float colours in, the footprint rows out.  The forward
        # and the backward: the buffer's depths and weights, the colour
        # tables at one 4-byte word per texel (the least that holds the
        # 10-bit colours; the rows repeat each word four times, the
        # design's own cost), transforms and rays; the forward also the
        # median and the S depth maps in, wsc, ws, wdepth and depth_err
        # out; the backward the cotangents of wsc and ws in, dbd and dbw
        # out.  No byte is counted in two kernels' bounds.
        in_bytes = 4 * (2 * B * H * W + texels + S * 16 + 2 * H * W)
        fwd_bytes = in_bytes + 4 * (H * W + texels) + 4 * S * H * W * 6
        fwd_ops = (pairs * WARP_OPS_PER_PAIR["warp_fwd"]
                   + S * H * W * WARP_OCC_OPS + H * W * WARP_OCC_PIXEL_OPS)
        calls = {
            "rgb10_pack": (lambda: epilogue.rgb10_pack_cuda(images),
                           lambda: epilogue.pack_rgb10_rows(images),
                           4 * texels * (3 + 4),
                           texels * PACK_OPS_PER_TEXEL),
            "warp_fwd": (lambda: epilogue.warp_fwd_cuda(*wa, *intr),
                         lambda: epilogue.warp_views_plain(*wa, *intr),
                         fwd_bytes, fwd_ops),
            "warp_bwd": (lambda: epilogue.warp_bwd_cuda(*wa[:6], intr, *cts),
                         lambda: epilogue.warp_views_bwd_plain(
                             *wa[:6], intr, *cts),
                         in_bytes + 4 * S * H * W * 4 + 4 * 2 * B * H * W,
                         pairs * WARP_OPS_PER_PAIR["warp_bwd"])}
        by_name = {}
        for name, (kernel, plain, nbytes, ops) in calls.items():
            k_ms = cuda_ms(kernel, 20)
            p_ms = cuda_ms(plain, 1, warmup=0)
            t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_FLOP_S
            by_name[name] = {
                "kernel": name, "size": f"{wh[0]}x{wh[1]}", "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_share": max(t_bytes, t_ops) * 1e3 / k_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops, "pairs": pairs,
                "sources": [S, Hs, Ws], "buffer": B,
                **_cuda.warp_info(name, B, S)}
        # the pack and the forward together, from the float colours: the
        # colours in once (the footprint rows are the design's own cost)
        # and the forward's other bytes
        fwd = by_name["warp_fwd"]
        t_bytes = (fwd_bytes + 4 * texels * 2) / HBM_BYTES_S
        t_ops = (fwd_ops + texels * PACK_OPS_PER_TEXEL) / FP32_FLOP_S
        fwd["ms_with_pack"] = fwd["ms"] + by_name["rgb10_pack"]["ms"]
        fwd["bound_ms_with_pack"] = max(t_bytes, t_ops) * 1e3
        fwd["bound_share_with_pack"] = (fwd["bound_ms_with_pack"]
                                        / fwd["ms_with_pack"])
        warp_cases += by_name.values()

    from ibgs_tpu_torch.ops import preprocess as pre
    from ibgs_tpu_torch.utils import profiling
    pre_cases = []
    for tag, args in ((f"bundle_{SIZES[0][0]}x{SIZES[0][1]}",
                       pre_in[SIZES[0]][0]),
                      (f"random_1m_{SIZES[0][0]}x{SIZES[0][1]}",
                       preprocess_args(scene_1m[0], scene_1m[1],
                                       opt.learnt_normal, rcfg.tile_h,
                                       rcfg.tile_w))):
        P, K = args[0].shape[0], args[4].shape[1]
        cts = table_cts(P)
        bargs = tuple(args[i] for i in (0, 1, 2, 4, 5, 6, 7, 8))
        calls = {
            "preprocess_fwd": (lambda: pre.preprocess_fwd_cuda(*args),
                               lambda: pre.preprocess_fwd_plain(*args),
                               preprocess_bytes(args)),
            "preprocess_bwd": (lambda: pre.preprocess_bwd_cuda(*bargs, cts),
                               lambda: pre.preprocess_bwd_plain(*bargs, cts),
                               preprocess_bytes(args, cts))}
        for name, (kernel, plain, nbytes) in calls.items():
            base, per_coeff = PRE_OPS[name]
            ops = P * (base + per_coeff * K)
            # the kernel's own time: the median device time of profiled
            # calls (at the bundle's size one launch takes less device time
            # than the wrapper's host work, so CUDA events around calls
            # back to back time the host: kept as events_ms)
            events_ms = cuda_ms(kernel, 20)
            runs = [profiling.device_time(kernel, DEVICE)
                    for _ in range(PRE_PROFILED)]
            if any(r.get("device_launches") != 1 for r in runs):
                failures.append(f"timing {name} {tag}: profiled calls {runs}")
                runs = [{"device_busy_ms": math.nan}]
            k_ms = sorted(r["device_busy_ms"] for r in runs)[len(runs) // 2]
            p_ms = cuda_ms(plain, 1, warmup=1)
            t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_FLOP_S
            pre_cases.append({
                "kernel": name, "scene": tag, "splats": P, "sh_coeffs": K,
                "ms": k_ms, "events_ms": events_ms, "plain_ms": p_ms,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_share": max(t_bytes, t_ops) * 1e3 / k_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops,
                **_cuda.preprocess_info(name, K)})

    # the binning kernels at the bundle (1920x1088) and the 1M scene
    # (960x544): each kernel's device time from profiled calls of the
    # whole wrapper (by kernel name; bin_radix all its passes), the rest
    # of its device events (the workspace's memset, the totals' copy) as
    # other_ms, the call on the host clock (it ends in its one sync) and
    # the plain version's
    bin_cases = []
    for tag in (f"bundle_{SIZES[1][0]}x{SIZES[1][1]}",
                f"random_1m_{SIZES[0][0]}x{SIZES[0][1]}"):
        (sp, cull), (TX, TY, TH, TW) = bin_in[tag]
        P = sp.depth.shape[0]

        def kernel():
            return binning.bin_staircase_cuda(sp, TX, TY, 0, cull, TH, TW,
                                              0)

        def plain():
            return binning.bin_staircase_plain(sp, TX, TY, 0, cull, TH,
                                               TW, 0)
        n = kernel().rank.shape[0]
        runs = [profiling.device_time(kernel, DEVICE, top=64)
                for _ in range(PRE_PROFILED)]
        if any("error" in r for r in runs):
            failures.append(f"timing binning {tag}: {runs}")
            continue
        mine = {k: sorted(sum(t[1] for t in r["top"] if f"{k}_kernel" in t[0])
                          for r in runs)[len(runs) // 2]
                for k in _cuda.BIN_KERNELS}
        other = sorted(r["device_busy_ms"] - sum(
            t[1] for t in r["top"] if "bin_" in t[0] and "_kernel" in t[0])
            for r in runs)[len(runs) // 2]
        call = median_range([host_ms(kernel) for _ in range(PRE_PROFILED)])
        plain_ms = median_range([host_ms(plain) for _ in range(3)])
        nbytes = binning_bytes(P, n, TX * TY, _cuda.bin_tile_passes(TX * TY))
        for k in _cuda.BIN_KERNELS:
            bound = nbytes[k] / HBM_BYTES_S * 1e3
            bin_cases.append({
                "kernel": k, "scene": tag, "splats": P, "instances": n,
                "ms": mine[k], "bound_ms": bound, "bytes": nbytes[k],
                "bound_share": bound / mine[k] if mine[k] else math.nan,
                "bound_by": "bytes", **_cuda.binning_info(k)})
        bin_cases.append({
            "kernel": "bin_splats", "scene": tag, "splats": P,
            "instances": n, "device_launches": runs[0]["device_launches"],
            "kernels_ms": sum(mine.values()), "other_ms": other,
            "call_ms": call, "plain_ms": plain_ms})

    serve_ms = {}
    for wh in SIZES:
        sc = scenes[wh]

        def serve_one():
            renderers[wh].render_one(sc["cam"], nearest)

        def depth_prepass():
            for i in nearest:
                render_depth_view(sc["model"], sc["train_cameras"][i], rcfg,
                                  opt.learnt_normal)

        torch.cuda.reset_peak_memory_stats()
        serve_one()
        peak = torch.cuda.max_memory_allocated()
        # each call timed alone: median and range over SERVE_REPEATS calls
        total = sorted(cuda_ms(serve_one, 1, warmup=0)
                       for _ in range(SERVE_REPEATS))
        depth = sorted(cuda_ms(depth_prepass, 1, warmup=0)
                       for _ in range(SERVE_REPEATS))
        med, dmed = total[len(total) // 2], depth[len(depth) // 2]
        serve_ms[f"{wh[0]}x{wh[1]}"] = {
            "ms_per_view": med, "ms_per_view_min": total[0],
            "ms_per_view_max": total[-1], "depth_prepass_ms": dmed,
            "geo_render_and_fusion_ms": med - dmed,
            "max_memory_allocated": peak,
            "profile": device_profile(serve_one, med,
                                      f"timing serve {wh}", failures)}

    train_ms = {}
    for wh in SIZES:
        sc = scenes[wh]
        holder = {"state": train_in[wh][0]}
        src_w = train_in[wh][1]
        step = trainer.make_train_step(opt, rcfg, holder["state"].net,
                                       phases[1])

        def train_one():
            holder["state"], _ = step(holder["state"], sc["cam"], 0,
                                      sc["gt"], src_w, ITER_GEO, bg, False,
                                      1.0, NET_LR)

        train_one()                       # warm-up
        torch.cuda.reset_peak_memory_stats()
        train_one()
        peak = torch.cuda.max_memory_allocated()
        times = median_range([host_ms(train_one)
                              for _ in range(STEP_REPEATS)])
        train_ms[f"{wh[0]}x{wh[1]}"] = {
            "ms_per_step": times, "max_memory_allocated": peak,
            "profile": device_profile(train_one, times["median"],
                                      f"timing train {wh}", failures)}
    emit({"phase": "timing", "blend_fwd": fwd_cases, "blend_bwd": bwd_cases,
          "warp": warp_cases, "preprocess": pre_cases,
          "binning": bin_cases, "ssim": ssim_cases,
          "tile_ranges": {f"{wh[0]}x{wh[1]}": range_lengths(preps[wh])
                          for wh in SIZES},
          "serve": serve_ms, "train_step": train_ms})

    # ---- loop: the training driver from the seed cloud, counted ------------
    del renderers, train_in, bwd_args, warp_in, pre_in, scene_1m, preps, outs
    del bin_in, sp_1m, sp, cull
    del state
    torch.cuda.empty_cache()
    ssim_before = ssim_counts()
    rec, loop_launches, resume_launches = loop_phase(d, dev, failures)
    ssim_by_path["loop"] = ssim_since(ssim_before)
    emit(rec)

    # ---- eval: the evaluation path on the loop's model, counted -------------
    torch.cuda.empty_cache()
    ssim_before = ssim_counts()
    rec, eval_launches = eval_phase(d, dev, failures)
    ssim_by_path["eval"] = ssim_since(ssim_before)
    emit(rec)

    # ---- parallel: bands, the Gaussian-sharded step, the mesh loop ----------
    torch.cuda.empty_cache()
    par_in = {wh: train_inputs(wh) for wh in SIZES}
    ssim_before = ssim_counts()
    rec, par_launches = parallel_phase(d, dev, scenes, par_in, opt, rcfg,
                                       failures)
    ssim_by_path["parallel"] = ssim_since(ssim_before)
    emit(rec)
    del par_in

    # ---- drivers: the production run at 1M seeds, bundle, suite, replay -----
    torch.cuda.empty_cache()
    ssim_before = ssim_counts()
    rec, drv_launches = drivers_phase(dev, failures)
    ssim_by_path["drivers"] = ssim_since(ssim_before)
    emit(rec)

    # ---- bench: the north-star step, the probes, the trace parser ---------
    torch.cuda.empty_cache()
    ssim_before = ssim_counts()
    rec, bench_launches = bench_phase(dev, failures)
    ssim_by_path["bench"] = ssim_since(ssim_before)
    emit(rec)

    # ---- kernels -----------------------------------------------------------
    size0 = f"{SIZES[0][0]}x{SIZES[0][1]}"
    fwd_main = next(c for c in fwd_cases
                    if c["mode"] == "render_geo" and c["size"] == size0)
    bwd_main = next(c for c in bwd_cases
                    if c["mode"] == "render_geo" and c["size"] == size0)
    warp_main = {c["kernel"]: c for c in warp_cases if c["size"] == size0}
    pre_main = {c["kernel"]: c for c in pre_cases
                if c["scene"] == f"bundle_{size0}"}
    launches_by_path = {k: {"serve": serve_launches[k],
                            "train": train_launches[k],
                            "loop": loop_launches[k],
                            "loop_resume": resume_launches[k],
                            "eval": eval_launches[k],
                            "parallel": par_launches[k],
                            "drivers": drv_launches[k],
                            "bench": bench_launches[k]}
                        for k in launch_counts()}
    emit({"phase": "kernels", "launches": launches_by_path,
          "ssim_launches": ssim_by_path})
    # the SSIM kernels run wherever a loss is taken on the card: every
    # path but serving, which takes none (evaluation: forwards only)
    for path, counts in ssim_by_path.items():
        for k, n in counts.items():
            if path == "serve" and n:
                failures.append(f"{k} was launched on the serving path")
            elif path != "serve" and not n and \
                    not (path == "eval" and k == "ssim_bwd"):
                failures.append(f"{k} was not launched on the {path} path")
    for k, by_path in launches_by_path.items():
        if by_path["train"] == 0:
            failures.append(f"{k} was not launched on the training path")
        if by_path["loop"] == 0:
            failures.append(f"{k} was not launched on the loop path")
        if by_path["parallel"] == 0:
            failures.append(f"{k} was not launched on the parallel path")
        if by_path["drivers"] == 0:
            failures.append(f"{k} was not launched on the drivers path")
        if by_path["bench"] == 0:
            failures.append(f"{k} was not launched on the bench path")
    for k in ("blend_fwd", "rgb10_pack", "warp_fwd", "preprocess_fwd"):
        if serve_launches[k] == 0:
            failures.append(f"{k} was not launched on the serving path")
        if eval_launches[k] == 0:
            failures.append(f"{k} was not launched on the evaluation path")
    for k in ("blend_bwd", "preprocess_bwd"):
        if color_launches[k] != 1:
            failures.append(f"the colour-only step did not launch {k}")

    if failures:
        for f in failures:
            print("chip_smoke FAILED: " + f, file=sys.stderr)
        return 1

    def line(name, source, replaces, main, max_err, cases):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": launches_by_path[name]["train"],
                "launches_by_path": launches_by_path[name],
                "max_abs_err": max_err, "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None,
                "cta": cta.get(name), "cases": cases}

    emit({"kernels": [
        line("blend_fwd", "ibgs_tpu_torch/ops/csrc/blend_fwd.cu",
             "ibgs_tpu/ops/blend_pallas.py:165", fwd_main, fwd_max_abs_err,
             fwd_cases),
        line("blend_bwd", "ibgs_tpu_torch/ops/csrc/blend_bwd.cu",
             "ibgs_tpu/ops/blend_pallas.py:422", bwd_main, bwd_max_abs_err,
             bwd_cases),
        # no single PyTorch call computes the warp (grid_sample has no
        # per-entry weight, in-bounds mask, texel-0 rule or B-sum) or the
        # rgb10 packing
        *(line(name, "ibgs_tpu_torch/ops/csrc/warp.cu",
               f"ibgs_tpu/ops/epilogue.py:{at}", warp_main[name],
               warp_max_abs_err[name],
               [c for c in warp_cases if c["kernel"] == name])
          for name, at in (("rgb10_pack", 152), ("warp_fwd", 219),
                           ("warp_bwd", 286))),
        # no single PyTorch call computes the projection (the EWA
        # covariance, the SH colour, the camera-space plane and the tile
        # rectangles of each splat) or its gradient
        *(line(name, "ibgs_tpu_torch/ops/csrc/preprocess.cu",
               "ibgs_tpu/ops/preprocess.py:142", pre_main[name],
               pre_max_abs_err[name],
               [c for c in pre_cases if c["kernel"] == name])
          for name in ("preprocess_fwd", "preprocess_bwd"))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
