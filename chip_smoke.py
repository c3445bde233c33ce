#!/usr/bin/env python3
"""The port's kernel table on one CUDA card: each hand kernel held to its
plain PyTorch twin, its device time beside the twin's and its bound.

    python3 chip_smoke.py

Needs a CUDA device, `nvcc` and `bench_bundle.npz`; without a card it
exits 1.  Correctness on the card is `python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`, the step and the view end to end `python3 -m
benchmark.run`.  One JSON line a phase:

  device  the card's name and count, nvidia-smi's name and power limit
  build   ptxas registers, shared memory and spills per kernel; per blend
          kernel and mode the CTAs one SM holds at the main path's CTA size
  timing  a row per kernel case, its outputs first held to the twin's by
          the gpu suite's comparisons (tests/torch_bundle_inputs.py): ms
          (CUDA events over 20 launches, or, where one launch takes less
          device time than the wrapper's host work, the median device
          time of profiled calls, events ms beside), the twin's ms, the
          bound (the larger of the bytes moved, each input read and each
          output written once, at 3.35 TB/s and the float ops at 67
          TFLOP/s) and its share, registers, spills and CTAs per SM
          (`_cuda.kernel_info`); tile range lengths.  Inputs: the bundle
          at 960x544 and 1920x1088 with one real backward of each mode,
          the random 1M scene at 960x544, seeded SSIM frames at 1920x1088
          and 960x540 as the train step passes them, a seeded train
          state at 1,310,720 and 2,620,416 slots for the optimizer, and
          `pack_rows`' backward on the binning cases' instances (the
          bundle at 1920x1088, the 1M scene at 960x544) with seeded
          cotangents of 15 columns

then {"kernels": [...], "launches": {...}} (a row per kernel: source,
what it replaces, its main case's ms, plain ms and bound, every case; the
launches of the served view at both sizes and of a train step of each mode,
counted from zero), the nvidia-smi line and {"ok": true, "device": {...}}.
A kernel output off its twin's, a launch count off the expected one, a
non-finite path output or a profiled call that lost a device event exits
1.  A/B of two kernel versions: this script from a checkout of each, in
turns, in one call on the card (README, "PyTorch / H100 port").
"""
import json
import math
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUNDLE = os.path.join(ROOT, "bench_bundle.npz")
SIZES = [(960, 544), (1920, 1088)]
DEVICE = "cuda"
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
# the SSIM loss's frames: the bundle cell's and the Tanks and Temples
# cell's; each as a frame pair and as the train step's stack of 3 sources
SSIM_SIZES = [(1920, 1088), (960, 540)]
# the optimizer's slots: the 1M and the Tanks and Temples cells' capacities
OPTIM_SLOTS = {"1m": 1_310_720, "tnt": 2_620_416}
MODE_NAMES = {0: "color", 1: "render_geo", 2: "depth_only"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def parse_ptxas(log):
    """Per-kernel registers / shared memory / spills from `-Xptxas -v`."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out[m.group(1)] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            s = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)),
                       smem_bytes=int(s.group(1)) if s else 0)
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


def profiled_ms(fn, tag, failures):
    """The median device ms of PRE_PROFILED profiled calls of fn, each of
    one launch; a call with another count fails the script."""
    from ibgs_tpu_torch.utils import profiling
    runs = [profiling.device_time(fn, DEVICE) for _ in range(PRE_PROFILED)]
    if any(r.get("device_launches") != 1 for r in runs):
        failures.append(f"timing {tag}: profiled calls {runs}")
        return math.nan
    return sorted(r["device_busy_ms"] for r in runs)[len(runs) // 2]


def bound(nbytes, ops=0):
    """{bound_ms, bound_by} of a kernel that moves nbytes and does ops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_FLOP_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def row(ms, plain_ms, nbytes, ops=0, **extra):
    """A timing row: ms, plain ms, the bound and the share of it."""
    b = bound(nbytes, ops)
    return {"ms": ms, "plain_ms": plain_ms, **b,
            "bound_share": b["bound_ms"] / ms if ms else math.nan,
            "bytes": nbytes, **({"ops": ops} if ops else {}), **extra}


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


def pack_bytes(P, n, C, long_ranks, long_slots):
    """Bytes `pack_rows`' backward needs for P Gaussians, n instances and C
    columns, each input read once and each output written once: n (9 +
    4C) + P (16 + 4C) + 8, 274 MB at the 1M scene.  pack_inv the slots
    (8) and the valid flags (1) in (its inverse is the design's own
    scratch, read back from L2); pack_long the cotangent rows (4C) of the
    long ranks' slots, their seg_off pairs and order entries (24) in and
    their gradient rows (4C) out; pack_bwd the rest."""
    total = n * (9 + 4 * C) + P * (16 + 4 * C) + 8
    long_ = 4 * C * long_slots + (24 + 4 * C) * long_ranks
    return {"pack_inv": 9 * n, "pack_bwd": total - 9 * n - long_,
            "pack_long": long_}


def check(failures, tag, fn, *args, **kw):
    """One of tests/torch_bundle_inputs.py's comparisons of a kernel with
    its plain twin: a failed assertion fails the script."""
    try:
        fn(*args, **kw)
    except AssertionError as e:
        failures.append(f"{tag}: {e!r}"[:600])


def ssim_rows(dev, failures, tbi):
    """The SSIM kernels' rows at SSIM_SIZES as the train step calls them
    (the frame's first input needs a gradient, the stack's second), each
    held to the plain chain bit for bit first; the bound reads a stride-0
    frame once; the plain chain's ms by CUDA events, with its device time
    and launches."""
    import torch
    from ibgs_tpu_torch.ops import _cuda
    from ibgs_tpu_torch.ops import ssim as tssim
    from ibgs_tpu_torch.train import losses
    from ibgs_tpu_torch.utils import profiling

    rows = []
    for W, H in SSIM_SIZES:
        for stack in (False, True):
            tag = f"{'stack3_' if stack else ''}{W}x{H}"
            a, b, ct = tbi.ssim_inputs(H, W, stack, dev, W * H + int(stack))
            need = (False, True) if stack else (True, False)
            check(failures, f"ssim {tag}", tbi.assert_ssim_pair, a, b, ct,
                  (need,))
            _, mom = tssim._forward(a, b, True)
            frame, n = a.numel() // (3 if stack else 1), b.numel()
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
                p_dev = profiling.device_time(plain[name], DEVICE)
                rows.append({
                    "kernel": name, "case": tag, "elements": n,
                    **row(profiled_ms(kernel, f"{name} {tag}", failures),
                          cuda_ms(plain[name], 3, warmup=1), nbytes),
                    "events_ms": cuda_ms(kernel, 20),
                    "plain_device_ms": p_dev.get("device_busy_ms"),
                    "plain_launches": p_dev.get("device_launches"),
                    **_cuda.kernel_info(name)})
            del mom, plain_out, x, y, ins
    return rows


def optim_bytes(x):
    """Bytes the optimizer's pass must move on optim_inputs `x`: Adam reads
    p, m, v, g and writes p, m, v (28 bytes an element) and a Gaussian
    field the alive mask (a byte a slot); the statistics read both screen
    gradients, the radii and the five statistics and write the five (60
    bytes a slot); a gradient only counted is read (4 bytes an element);
    the count is written (8)."""
    from ibgs_tpu_torch.models.gaussians import PARAM_FIELDS
    P = x.radii.shape[0]
    fields = sum(getattr(x.g.params, k).numel() for k in PARAM_FIELDS)
    net = sum(t.numel() for t in x.g.net)
    return (28 * (fields + x.g.app_ab.numel()) + len(PARAM_FIELDS) * P
            + 60 * P + (28 if x.phase.use_aggregation else 4) * net + 8)


def optim_ops(x):
    """Float ops of the pass: 14 an Adam element (b1·m, (1-b1)·g, their
    sum, b2·v, (1-b2)·g·g, their sum, the two bias corrections, lr·, the
    root, + eps, the quotient, the difference), 16 a statistics slot (4
    scales, 4 squares, 2 sums, 2 roots, 4 accumulations)."""
    from ibgs_tpu_torch.models.gaussians import PARAM_FIELDS
    n = (sum(getattr(x.g.params, k).numel() for k in PARAM_FIELDS)
         + x.g.app_ab.numel()
         + (sum(t.numel() for t in x.g.net) if x.phase.use_aggregation
            else 0))
    return 14 * n + 16 * x.radii.shape[0]


def optim_rows(dev, failures, tbi):
    """The optimizer kernel's rows at OPTIM_SLOTS, a geometry step with
    aggregation as trainer.apply_grads runs it, each held to the plain
    chain bit for bit first (tbi.assert_optim_pair): the kernel's device ms
    (the median of profiled calls, by its name), the whole call's device
    ms (the count's memset with it) and host ms, the plain chain's ms by
    CUDA events with its device ms and launches."""
    from ibgs_tpu_torch.ops import _cuda, optim
    from ibgs_tpu_torch.train import trainer
    from ibgs_tpu_torch.utils import profiling

    rows = []
    for tag, P in OPTIM_SLOTS.items():
        x = tbi.optim_inputs(P, dev, P, True)
        check(failures, f"optim {tag}", tbi.assert_optim_pair, x)

        def call():
            return trainer.apply_grads(x.state, x.g, x.radii, *x.wh, x.lrs,
                                       x.state.net, x.phase, x.net_lr)

        def plain():
            on_kernel = optim.on_kernel
            optim.on_kernel = lambda device: False
            try:
                return call()
            finally:
                optim.on_kernel = on_kernel
        call()
        runs = [profiling.device_time(call, DEVICE, top=4)
                for _ in range(PRE_PROFILED)]
        if any("error" in r for r in runs):
            failures.append(f"timing optim {tag}: {runs}")
            continue
        kernel_ms = sorted(sum(t[1] for t in r["top"]
                               if "optim_kernel" in t[0])
                           for r in runs)[len(runs) // 2]
        p_dev = profiling.device_time(plain, DEVICE)
        rows.append({
            "kernel": "optim", "case": tag, "slots": P,
            **row(kernel_ms, cuda_ms(plain, 3, warmup=1), optim_bytes(x),
                  optim_ops(x)),
            "call_device_ms": sorted(r["device_busy_ms"]
                                     for r in runs)[len(runs) // 2],
            "call_launches": runs[0]["device_launches"],
            "host_ms": median_range([host_ms(call)
                                     for _ in range(PRE_PROFILED)]),
            "events_ms": cuda_ms(call, 20),
            "plain_device_ms": p_dev.get("device_busy_ms"),
            "plain_launches": p_dev.get("device_launches"),
            **_cuda.kernel_info("optim")})
        del x
    return rows


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # tests/ goes last, so that none of its modules shadows a package
    sys.path[:0], sys.path[len(sys.path):] = [ROOT], [ROOT + "/tests"]
    import torch_bundle_inputs as tbi
    from ibgs_tpu_torch.bench import smi_line
    from ibgs_tpu_torch.config import OptimizationParams
    from ibgs_tpu_torch.ops import _cuda, binning, blend, epilogue
    from ibgs_tpu_torch.ops import preprocess as pre
    from ibgs_tpu_torch.ops.rasterize import RasterConfig, cull_table
    from ibgs_tpu_torch.utils import profiling

    # reference semantics: full float32 matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    failures = []

    # ---- device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    emit({"phase": "device", "name": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- build -----------------------------------------------------------
    rcfg = RasterConfig(buffer_len=OptimizationParams().buffer_length)
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

    # ---- inputs: the bundle, one real backward of each mode, the 1M scene
    b = tbi.bundle_inputs(dev, SIZES, BUNDLE)
    rcfg, opt, scenes, preps, inputs = (b.rcfg, b.opt, b.scenes, b.preps,
                                        b.captured)

    def range_lengths(pr):
        """p50, p99 and max of the tile range lengths."""
        lens = (pr.bins.tile_stop - pr.bins.tile_start).double()
        q = torch.quantile(lens, torch.tensor([0.5, 0.99], device=lens.device,
                                              dtype=lens.dtype))
        return {"p50": float(q[0]), "p99": float(q[1]),
                "max": int(lens.max()), "tiles": int(lens.numel())}

    args_1m = tbi.preprocess_args(
        *tbi.random_scene(dev, SIZES[0], PRE_SCENE_N), opt.learnt_normal,
        rcfg.tile_h, rcfg.tile_w)

    # ---- timing, each kernel case held to its plain twin first ---------
    fwd_cases = []
    for wh in SIZES:
        pr, cam = preps[wh], scenes[wh]["cam"]
        B = rcfg.buffer_len
        n_pix = pr.Wp * pr.Hp
        nbytes = (pr.feats_inst.shape[0] * 13 * 4
                  + 2 * pr.bins.tile_start.numel() * 4
                  + n_pix * (8 + 3 * B) * 4)
        for mode in (0, 1, 2):
            cfg = rcfg.blend_cfg(render_geo=mode == 1, depth_only=mode == 2)
            args = (pr.feats_inst, pr.bins.tile_start, pr.bins.tile_stop,
                    pr.Wp, pr.Hp, cam.fx, cam.fy, cam.cx, cam.cy, cfg)
            out = blend.blend_fwd_cuda(*args)
            check(failures, f"blend_fwd {wh} {MODE_NAMES[mode]}",
                  tbi.assert_fwd_matches, out, blend.blend_plain(*args), 1e-4)
            pairs = int(out.n_contrib.long().sum())
            fwd_cases.append({
                "kernel": "blend_fwd", "size": f"{wh[0]}x{wh[1]}",
                "mode": MODE_NAMES[mode],
                **row(cuda_ms(lambda: blend.blend_fwd_cuda(*args), 20),
                      cuda_ms(lambda: blend.blend_plain(*args), 1, warmup=0),
                      nbytes, pairs * OPS_PER_PAIR), "pairs": pairs})

    bwd_cases = []
    for wh in SIZES:
        for mode in (1, 0):
            *head, saved, cts, row0 = inputs[(wh, mode)][0]
            feats, B = head[0], rcfg.buffer_len
            stats = {}
            check(failures, f"blend_bwd {wh} {MODE_NAMES[mode]}",
                  tbi.assert_bwd_pair, head, saved, cts, row0, stats)
            walked = int(saved.n_contrib.long().sum())
            n_pix = saved.final_t.numel()
            # saved colour, T, n_contrib and cotangents dcolour, dT per
            # pixel; render_geo adds normal, buffer weights / contributors
            # and the dnormal / dbuffer cotangents
            per_pix = 9 + (6 + 4 * B if mode == 1 else 0)
            nbytes = (feats.shape[0] * (13 + 16) * 4
                      + 2 * head[1].numel() * 4 + n_pix * per_pix * 4)
            ops = (walked * OPS_PER_PAIR
                   + stats["contrib_pairs"] * OPS_PER_CONTRIB_PAIR[mode])
            bwd_cases.append({
                "kernel": "blend_bwd", "size": f"{wh[0]}x{wh[1]}",
                "mode": MODE_NAMES[mode],
                **row(cuda_ms(lambda: blend.blend_bwd_cuda(
                          *head, saved, cts, row0), 20),
                      cuda_ms(lambda: blend.blend_bwd_plain(
                          *head, saved, cts, row0), 1, warmup=0),
                      nbytes, ops),
                "walked_pairs": walked,
                "contrib_pairs": stats["contrib_pairs"]})

    # ---- timing: the warp ----------------------------------------------
    warp_cases = []
    for wh in SIZES:
        wa, intr, cts, images = inputs[(wh, 1)][1]
        (B, H, W), (S, Hs, Ws) = wa[0].shape, wa[2].shape[:3]
        pairs, texels = B * H * W * S, S * Hs * Ws
        check(failures, f"warp {wh}", tbi.assert_warp_pair, wa, intr, cts,
              images)
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
            by_name[name] = {
                "kernel": name, "size": f"{wh[0]}x{wh[1]}",
                **row(cuda_ms(kernel, 20), cuda_ms(plain, 1, warmup=0),
                      nbytes, ops),
                "pairs": pairs, "sources": [S, Hs, Ws], "buffer": B,
                **_cuda.kernel_info(name, B, S)}
        # the pack and the forward together, from the float colours: the
        # colours in once (the footprint rows are the design's own cost)
        # and the forward's other bytes
        fwd = by_name["warp_fwd"]
        both = bound(fwd_bytes + 4 * texels * 2,
                     fwd_ops + texels * PACK_OPS_PER_TEXEL)
        fwd["ms_with_pack"] = fwd["ms"] + by_name["rgb10_pack"]["ms"]
        fwd["bound_ms_with_pack"] = both["bound_ms"]
        fwd["bound_share_with_pack"] = (both["bound_ms"]
                                        / fwd["ms_with_pack"])
        warp_cases += by_name.values()

    # ---- timing: the projection ----------------------------------------
    pre_cases = []
    for tag, args in ((f"bundle_{SIZES[0][0]}x{SIZES[0][1]}",
                       inputs[(SIZES[0], 1)][2]),
                      (f"random_1m_{SIZES[0][0]}x{SIZES[0][1]}", args_1m)):
        P, K = args[0].shape[0], args[4].shape[1]
        cts, bargs = tbi.table_cts(P, dev), tbi.pre_bwd_args(args)
        check(failures, f"preprocess_fwd {tag}", tbi.assert_pre_fwd, args)
        check(failures, f"preprocess_bwd {tag}", tbi.assert_pre_bwd_pair,
              bargs, cts)
        calls = {
            "preprocess_fwd": (lambda: pre.preprocess_fwd_cuda(*args),
                               lambda: pre.preprocess_fwd_plain(*args),
                               preprocess_bytes(args)),
            "preprocess_bwd": (lambda: pre.preprocess_bwd_cuda(*bargs, cts),
                               lambda: pre.preprocess_bwd_plain(*bargs, cts),
                               preprocess_bytes(args, cts))}
        for name, (kernel, plain, nbytes) in calls.items():
            base, per_coeff = PRE_OPS[name]
            pre_cases.append({
                "kernel": name, "scene": tag, "splats": P, "sh_coeffs": K,
                **row(profiled_ms(kernel, f"{name} {tag}", failures),
                      cuda_ms(plain, 1, warmup=1), nbytes,
                      P * (base + per_coeff * K)),
                "events_ms": cuda_ms(kernel, 20),
                **_cuda.kernel_info(name, K)})

    # ---- timing: binning -------------------------------------------------
    # the bundle (1920x1088) and the 1M scene (960x544): each kernel's
    # device time from profiled calls of the whole wrapper (by kernel name;
    # bin_radix all its passes), the rest of its device events (the
    # workspace's memset, the totals' copy) as other_ms, the call on the
    # host clock (it ends in its one sync) and the plain version's
    with torch.no_grad():
        sp_1m = pre.preprocess(*args_1m)
    bin_in = {f"bundle_{SIZES[1][0]}x{SIZES[1][1]}": (
                  preps[SIZES[1]].sp,
                  (preps[SIZES[1]].Wp // rcfg.tile_w,
                   preps[SIZES[1]].Hp // rcfg.tile_h)),
              f"random_1m_{SIZES[0][0]}x{SIZES[0][1]}": (
                  sp_1m, (-(-SIZES[0][0] // rcfg.tile_w),
                          -(-SIZES[0][1] // rcfg.tile_h)))}
    bin_cases = []
    for tag, (sp, (TX, TY)) in bin_in.items():
        P, TH, TW, cull = (sp.depth.shape[0], rcfg.tile_h, rcfg.tile_w,
                           cull_table(sp))

        def kernel():
            return binning.bin_staircase_cuda(sp, TX, TY, 0, cull, TH, TW,
                                              0)

        def plain():
            return binning.bin_staircase_plain(sp, TX, TY, 0, cull, TH,
                                               TW, 0)
        check(failures, f"binning {tag}", tbi.assert_bins_equal, kernel(),
              plain())
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
        nbytes = binning_bytes(P, n, TX * TY, _cuda.bin_tile_passes(TX * TY))
        for k in _cuda.BIN_KERNELS:
            bin_cases.append({
                "kernel": k, "scene": tag, "splats": P, "instances": n,
                **row(mine[k], None, nbytes[k]), **_cuda.kernel_info(k)})
        bin_cases.append({
            "kernel": "bin_splats", "scene": tag, "splats": P,
            "instances": n, "device_launches": runs[0]["device_launches"],
            "kernels_ms": sum(mine.values()), "other_ms": other,
            "call_ms": median_range([host_ms(kernel)
                                     for _ in range(PRE_PROFILED)]),
            "plain_ms": median_range([host_ms(plain) for _ in range(3)])})

    # ---- timing: pack_rows' backward -----------------------------------
    # the binning cases' instances with seeded cotangents of 15 columns:
    # each kernel's device time from profiled calls of the wrapper (by
    # kernel name), the three's events ms, the plain chain's ms by CUDA
    # events with its device ms and launches, the ranks of more than 32
    # slots (pack_long's) and the longest
    pack_cases = []
    for tag, (sp, (TX, TY)) in bin_in.items():
        bins = binning.bin_staircase_cuda(sp, TX, TY, 0, cull_table(sp),
                                          rcfg.tile_h, rcfg.tile_w, 0)
        P, n = bins.order.shape[0], bins.rank.shape[0]
        lens = torch.diff(bins.seg_off.clamp(0, n))
        long_ = lens > 32
        g = torch.randn(n, 15, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        args = (g, bins.inst_valid, bins.slot, bins.seg_off, bins.order)
        check(failures, f"pack_bwd {tag}", tbi.pack_bwd_pair, g, bins)

        def kernel():
            return binning.pack_rows_bwd_cuda(*args)

        def plain():
            return binning.pack_rows_bwd_plain(*args)
        runs = [profiling.device_time(kernel, DEVICE, top=8)
                for _ in range(PRE_PROFILED)]
        if any("error" in r for r in runs):
            failures.append(f"timing pack_bwd {tag}: {runs}")
            continue
        mine = {k: sorted(sum(t[1] for t in r["top"] if f"{k}_kernel" in t[0])
                          for r in runs)[len(runs) // 2]
                for k in _cuda.PACK_KERNELS}
        nbytes = pack_bytes(P, n, 15, int(long_.sum()),
                            int(lens[long_].sum()))
        plain_ms = cuda_ms(plain, 3, warmup=1)
        for k in _cuda.PACK_KERNELS:
            pack_cases.append({
                "kernel": k, "scene": tag, "splats": P, "instances": n,
                **row(mine[k], plain_ms, nbytes[k]), **_cuda.kernel_info(k)})
        p_dev = profiling.device_time(plain, DEVICE)
        pack_cases.append({
            "kernel": "pack_rows_bwd", "scene": tag, "splats": P,
            "instances": n,
            **row(sum(mine.values()), plain_ms, sum(nbytes.values())),
            "device_launches": runs[0]["device_launches"],
            "long_ranks": int(long_.sum()), "longest": int(lens.max()),
            "events_ms": cuda_ms(kernel, 20),
            "plain_device_ms": p_dev.get("device_busy_ms"),
            "plain_launches": p_dev.get("device_launches")})
        del bins, g, args

    ssim_cases = ssim_rows(dev, failures, tbi)
    optim_cases = optim_rows(dev, failures, tbi)
    emit({"phase": "timing", "blend_fwd": fwd_cases, "blend_bwd": bwd_cases,
          "warp": warp_cases, "preprocess": pre_cases,
          "binning": bin_cases, "pack": pack_cases, "ssim": ssim_cases,
          "optim": optim_cases,
          "tile_ranges": {f"{wh[0]}x{wh[1]}": range_lengths(preps[wh])
                          for wh in SIZES}})
    if failures or not all(math.isfinite(c["ms"]) for c in (
            *fwd_cases, *bwd_cases, *warp_cases, *pre_cases, *pack_cases,
            *ssim_cases, *optim_cases)):
        for f in failures or ["a non-finite kernel time"]:
            print("chip_smoke FAILED: " + f, file=sys.stderr)
        return 1

    # ---- launches by path: the served view at both sizes, one train step
    # of each mode at 960x544; each count against the expected one
    paths = {}
    for wh in SIZES:
        out, got, want = tbi.served_view(b, wh)
        paths["serve_%dx%d" % wh] = got
        if got != want or not tbi.finite(out):
            failures.append(f"serve {wh}: {got}, expected {want}")
    for mode, (_, ok, got, want) in zip(("render_geo", "color"),
                                        tbi.train_steps(b, 1, SIZES[0])):
        paths["train_" + mode] = got
        if got != want or not ok:
            failures.append(f"train {mode}: finite {ok}, {got}, expected "
                            f"{want}")

    # ---- kernels: a row each, with its main case ------------------------
    # (no single PyTorch call computes any of them: the warp's per-entry
    # weights, mask and B-sum, the projection's EWA covariance, SH colour,
    # plane and tile rectangle a splat, or their gradients; no torch.optim
    # Adam masks dead slots, counts non-finite gradients or keeps the
    # statistics)
    s0, s1 = (f"{w}x{h}" for w, h in SIZES)
    geo0 = {"mode": "render_geo", "size": s0}
    table = {  # kernel: (source, what it replaces, its main case)
        "blend_fwd": ("blend_fwd", "ops/blend_pallas.py:165", geo0),
        "blend_bwd": ("blend_bwd", "ops/blend_pallas.py:422", geo0),
        "rgb10_pack": ("warp", "ops/epilogue.py:152", {"size": s0}),
        "warp_fwd": ("warp", "ops/epilogue.py:219", {"size": s0}),
        "warp_bwd": ("warp", "ops/epilogue.py:286", {"size": s0}),
        **{k: ("preprocess", "ops/preprocess.py:142",
               {"scene": f"bundle_{s0}"})
           for k in ("preprocess_fwd", "preprocess_bwd")},
        **{k: ("binning", "ops/binning.py bin_splats",
               {"scene": f"bundle_{s1}"}) for k in _cuda.BIN_KERNELS},
        **{k: ("binning", "ops/binning.py _pack_rows_bwd",
               {"scene": f"random_1m_{s0}"}) for k in _cuda.PACK_KERNELS},
        **{k: ("ssim", "train/losses.py ssim_map",
               {"case": "%dx%d" % SSIM_SIZES[0]})
           for k in ("ssim_fwd", "ssim_bwd")},
        "optim": ("optim", "models/gaussians.py:253 adam_step, :285 "
                  "accumulate_stats; train/trainer.py:54 side_adam, :211 "
                  "the non-finite count", {"case": "1m"})}
    cases = [*fwd_cases, *bwd_cases, *warp_cases, *pre_cases, *bin_cases,
             *pack_cases, *ssim_cases, *optim_cases]
    rows = []
    for name, (source, replaces, key) in table.items():
        mine = [c for c in cases if c["kernel"] == name]
        main = next(c for c in mine if key.items() <= c.items())
        rows.append({
            "name": name, "route": "cuda",
            "source": f"ibgs_tpu_torch/ops/csrc/{source}.cu",
            "replaces": "ibgs_tpu/" + replaces, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "cta": cta.get(name), "cases": mine})
    emit({"kernels": rows, "launches": paths})
    print(smi, flush=True)
    if failures:
        for f in failures:
            print("chip_smoke FAILED: " + f, file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
