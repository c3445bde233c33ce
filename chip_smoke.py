#!/usr/bin/env python3
"""Drive the PyTorch port (ibgs_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA device, `nvcc` (CUDA_HOME or /usr/local/cuda) and the repo's
`bench_bundle.npz`.  Without a card it exits 1 and prints no result.
Phases, one JSON line each; any failure makes the exit code 1:

  device     the card's name, count and nvidia-smi name / power limit
  build      nvcc of every kernel source (registers, shared memory, spills)
  blend_fwd  the blend kernel against its plain PyTorch version in all
             three modes on the bundle's real instances at 960x544
  serve      EvalRenderer.render_one at 960x544 and 1920x1088: finite
             outputs, exactly 5 kernel launches per view, PSNR vs gt
  timing     kernel / plain / serving times (CUDA events), peak memory,
             device busy share of a served view (torch.profiler)
  kernels    each kernel with its launches on the serving path

then the nvidia-smi line and, last, {"ok": true, "device": {...}}.
"""
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
TOL_ABS, TOL_REL = 1e-5, 1e-5      # float outputs, kernel vs plain
INT_MISMATCH_SHARE = 1e-4          # integer outputs, share of pixels
SERVE_REPEATS = 7                  # timed serving calls per size
HBM_BYTES_S = 3.35e12              # H100 SXM device memory rate
FP32_FLOP_S = 67e12                # H100 SXM float32 rate outside tensor cores
# float ops that every walked (pixel, instance) pair needs, counted from
# the kernel body: offsets 2, power 9, clamp + exp + opacity + clamp 4,
# gate 2.  Pairs walked = sum of n_contrib (positions up to each pixel's
# last contributor), so pairs x OPS_PER_PAIR is a lower bound on the work.
OPS_PER_PAIR = 17
MODE_NAMES = {0: "color", 1: "render_geo", 2: "depth_only"}
FIELDS = ("color", "normal", "final_t", "n_contrib", "buf_depth",
          "buf_weight", "buf_contrib")


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


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
    import torch
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_profile(fn, step_ms, top=8):
    """Device busy time of one call of fn (torch.profiler, CUPTI), its
    share of `step_ms` (the same call timed without the profiler), and the
    kernels that take most of it.  Only the device's own events (kernels,
    copies) are summed: a host op's entry repeats its kernels' time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:          # CUPTI unavailable: not measured
        return {"error": str(e)[:200]}
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not events:
        return {"error": "the profiler recorded no device time"}
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / step_ms),
            "device_launches": sum(e.count for e in events),
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in events[:top]]}


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
    from ibgs_tpu_torch.ops import _cuda, blend
    from ibgs_tpu_torch.ops.rasterize import RasterConfig, prepare
    from ibgs_tpu_torch.renderer import render_depth_view

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
    t0 = time.time()
    logs = _cuda.build()
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "kernels": {name: parse_ptxas(log) for name, log in logs.items()}})

    # ---- inputs ----------------------------------------------------------
    d = dict(np.load(BUNDLE))
    opt, pipe = OptimizationParams(), PipelineParams()
    rcfg = RasterConfig(buffer_len=opt.buffer_length,
                        depth_error_threshold=opt.depth_error_threshold,
                        staircase_cull=pipe.staircase_cull,
                        row_cap=pipe.row_cap)
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

    # ---- blend_fwd: kernel vs plain at 960x544 -----------------------------
    wh = SIZES[0]
    pr, cam = preps[wh], scenes[wh]["cam"]
    lengths = (pr.bins.tile_stop - pr.bins.tile_start).long()
    rec = {"phase": "blend_fwd", "size": f"{wh[0]}x{wh[1]}",
           "n_instances": pr.bins.n_instances, "n_rows": pr.bins.n_rows,
           "num_tiles": int(lengths.numel()),
           "longest_tile_range": int(lengths.max()), "modes": {}}
    max_abs_err = 0.0
    pairs = {}
    for mode in (0, 1, 2):
        args = blend_args(pr, cam, mode)
        k_out = blend.blend_fwd_cuda(*args)
        p_out = blend.blend_plain(*args)
        torch.cuda.synchronize()
        m = {}
        n_pix = pr.Wp * pr.Hp
        for f in FIELDS:
            a, b = getattr(k_out, f), getattr(p_out, f)
            if a.dtype == torch.int32:
                bad = int((a != b).reshape(n_pix, -1).any(-1).sum())
                m[f + "_mismatch_pixels"] = bad
                if bad > INT_MISMATCH_SHARE * n_pix:
                    failures.append(f"blend_fwd {MODE_NAMES[mode]} {f}: "
                                    f"{bad} mismatching pixels")
            else:
                err = (a - b).abs()
                e = float(err.max()) if err.numel() else 0.0
                m[f + "_max_abs_err"] = e
                max_abs_err = max(max_abs_err, e)
                if not bool((err <= TOL_ABS + TOL_REL * b.abs()).all()) \
                        or not bool(torch.isfinite(a).all()):
                    failures.append(f"blend_fwd {MODE_NAMES[mode]} {f}: "
                                    f"max abs err {e}")
        pairs[(wh, mode)] = int(p_out.n_contrib.long().sum())
        rec["modes"][MODE_NAMES[mode]] = m
    emit(rec)

    # ---- serve: the main path, counted ------------------------------------
    net = init_fusion_net(ColorFusionResidualNet(
        32, opt.feat_aggregate_mode), torch.Generator().manual_seed(0))
    renderers = {wh: EvalRenderer(
        sc["model"], net, sc["images"], sc["w2v"], sc["centers"],
        sc["train_cameras"], opt, rcfg, device=dev)
        for wh, sc in scenes.items()}
    nearest = list(range(scenes[SIZES[0]]["count"]))
    outs, per_view = {}, {}
    for k in blend.LAUNCHES:
        blend.LAUNCHES[k] = 0
    for wh in SIZES:
        before = blend.LAUNCHES["blend_fwd"]
        outs[wh] = renderers[wh].render_one(scenes[wh]["cam"], nearest)
        torch.cuda.synchronize()
        per_view[wh] = blend.LAUNCHES["blend_fwd"] - before
    launches = dict(blend.LAUNCHES)
    for wh in SIZES:
        sc, out = scenes[wh], outs[wh]
        finite = all(bool(torch.isfinite(v).all()) for v in out.values()
                     if torch.is_tensor(v) and v.is_floating_point())
        if not finite:
            failures.append(f"serve {wh}: non-finite output")
        if per_view[wh] != 5:
            failures.append(f"serve {wh}: {per_view[wh]} kernel launches, "
                            f"expected 5")

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
              "n_instances": out["n_instances"], "n_rows": out["n_rows"],
              "psnr_render": round(psnr(out["render"]), 4),
              "psnr_aggregate": round(psnr(out["aggregate"]), 4),
              "src_depth_agree_1pct": [round(a, 4) for a in agree]})

    # ---- timing ------------------------------------------------------------
    cases = []
    for wh in SIZES:
        pr, cam = preps[wh], scenes[wh]["cam"]
        B = rcfg.buffer_len
        n_pix = pr.Wp * pr.Hp
        nbytes = (pr.feats_inst.numel() * 4 + 2 * pr.bins.tile_start.numel() * 4
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
            cases.append({"size": f"{wh[0]}x{wh[1]}", "mode": MODE_NAMES[mode],
                          "ms": k_ms, "plain_ms": p_ms,
                          "bound_ms": max(t_bytes, t_ops) * 1e3,
                          "bound_by": "bytes" if t_bytes >= t_ops
                          else "operations",
                          "bytes": nbytes, "pairs": pairs[(wh, mode)]})
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
            "profile": device_profile(serve_one, med)}
    emit({"phase": "timing", "blend_fwd": cases, "serve": serve_ms})

    # ---- kernels -----------------------------------------------------------
    main_case = next(c for c in cases if c["mode"] == "render_geo"
                     and c["size"] == f"{SIZES[0][0]}x{SIZES[0][1]}")
    emit({"phase": "kernels", "launches": launches})
    if launches["blend_fwd"] == 0:
        failures.append("blend_fwd was not launched on the serving path")

    if failures:
        for f in failures:
            print("chip_smoke FAILED: " + f, file=sys.stderr)
        return 1
    emit({"kernels": [{
        "name": "blend_fwd", "route": "cuda",
        "source": "ibgs_tpu_torch/ops/csrc/blend_fwd.cu",
        "replaces": "ibgs_tpu/ops/blend_pallas.py:165",
        "launches": launches["blend_fwd"], "max_abs_err": max_abs_err,
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None, "cases": cases}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
