#!/usr/bin/env python3
"""Drive the PyTorch port (ibgs_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA device, `nvcc` (CUDA_HOME or /usr/local/cuda) and the repo's
`bench_bundle.npz`.  Without a card it exits 1 and prints no result.
Phases, one JSON line each; any failure makes the exit code 1:

  device     the card's name, count and nvidia-smi name / power limit
  build      nvcc of every kernel source (registers, shared memory, spills)
  blend_fwd  the forward kernel against its plain PyTorch version in all
             three modes on the bundle's real instances at 960x544
  blend_bwd  the backward kernel against its plain version at 960x544 in
             modes render_geo and colour, with the cotangents of one real
             backward of the training objective and one seeded random
             set; two kernel runs bit-identical
  serve      EvalRenderer.render_one at 960x544 and 1920x1088: finite
             outputs, exactly 5 forward and 0 backward launches per view
  train      10 IBGS training steps at 960x544 (render_geo + aggregation,
             iteration 13000), 1 launch of each kernel per step, finite,
             loss falling; then 1 colour-only step (iteration 5000)
  timing     kernel / plain / serving / train-step times (CUDA events and
             host clock), peak memory, device busy share (torch.profiler)
  kernels    each kernel with its launches on the serving and train paths

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
MODE_NAMES = {0: "color", 1: "render_geo", 2: "depth_only"}
FIELDS = ("color", "normal", "final_t", "n_contrib", "buf_depth",
          "buf_weight", "buf_contrib")
GRAD_COLUMNS = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c",
                "opacity", "r", "g", "b", "normal_x", "normal_y",
                "normal_z", "dist", "abs_mean_x", "abs_mean_y")
TRAIN_AUX = ("loss", "image_loss", "normal_loss", "photo_loss", "agg_loss",
             "l1", "psnr")


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


def host_ms(fn):
    """Host clock around one call that ends in a device synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


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


def median_range(xs):
    xs = sorted(xs)
    return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1]}


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
    from ibgs_tpu_torch.renderer import (render_depth_view,
                                         source_views_from_stacks)
    from ibgs_tpu_torch.train import trainer

    # reference semantics: full float32 matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    failures = []

    def reset_launches():
        for k in blend.LAUNCHES:
            blend.LAUNCHES[k] = 0

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
    fwd_max_abs_err = 0.0
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
                fwd_max_abs_err = max(fwd_max_abs_err, e)
                if not bool((err <= TOL_ABS + TOL_REL * b.abs()).all()) \
                        or not bool(torch.isfinite(a).all()):
                    failures.append(f"blend_fwd {MODE_NAMES[mode]} {f}: "
                                    f"max abs err {e}")
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
        training objective (loss_and_grads) in `mode`."""
        sc = scenes[wh]
        state, src = train_in[wh]
        rec_args = []
        kernel = blend.blend_bwd_cuda

        def recorder(*a):
            rec_args.append(a)
            return kernel(*a)
        blend.blend_bwd_cuda = recorder
        try:
            trainer.loss_and_grads(opt, rcfg, state.net, phases[mode], state,
                                   sc["cam"], 0, sc["gt"], src, iters[mode],
                                   bg, False, 1.0)
        finally:
            blend.blend_bwd_cuda = kernel
        torch.cuda.synchronize()
        feats, start, stop, *geom, saved, cts, row0 = rec_args[0]
        saved = type(saved)(*(getattr(saved, f).detach() for f in FIELDS))
        return (feats.detach(), start, stop, *geom, saved,
                tuple(c.detach() for c in cts), row0)

    bwd_args = {(wh, mode): captured_bwd_args(wh, mode)
                for wh in SIZES for mode in (1, 0)}

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
            err = (k1 - p).abs().amax(0)[:15]
            scale = p.abs().amax(0)[:15]
            ok = bool((err <= BWD_TOL_REL * scale + BWD_TOL_ABS).all())
            finite = bool(torch.isfinite(k1).all())
            same = torch.equal(k1, k2)
            bwd_max_abs_err = max(bwd_max_abs_err, float(err.max()))
            m[name] = {
                "max_abs_err": dict(zip(GRAD_COLUMNS, err.tolist())),
                "max_abs_plain": dict(zip(GRAD_COLUMNS, scale.tolist())),
                "nonzero_rows": int((k1.abs().sum(1) > 0).sum()),
                "rows": int(k1.shape[0]), "finite": finite,
                "bit_identical_repeat": same}
            if not (ok and finite and same):
                failures.append(f"blend_bwd {MODE_NAMES[mode]} {name}: "
                                f"within tolerance {ok}, finite {finite}, "
                                f"bit-identical {same}")
        rec["modes"][MODE_NAMES[mode]] = m
    emit(rec)

    # ---- serve: the serving path, counted ----------------------------------
    net = init_fusion_net(ColorFusionResidualNet(
        32, opt.feat_aggregate_mode), torch.Generator().manual_seed(0))
    renderers = {wh: EvalRenderer(
        sc["model"], net, sc["images"], sc["w2v"], sc["centers"],
        sc["train_cameras"], opt, rcfg, device=dev)
        for wh, sc in scenes.items()}
    outs, per_view = {}, {}
    reset_launches()
    for wh in SIZES:
        before = dict(blend.LAUNCHES)
        outs[wh] = renderers[wh].render_one(scenes[wh]["cam"], nearest)
        torch.cuda.synchronize()
        per_view[wh] = {k: blend.LAUNCHES[k] - before[k] for k in before}
    serve_launches = dict(blend.LAUNCHES)
    for wh in SIZES:
        sc, out = scenes[wh], outs[wh]
        finite = all(bool(torch.isfinite(v).all()) for v in out.values()
                     if torch.is_tensor(v) and v.is_floating_point())
        if not finite:
            failures.append(f"serve {wh}: non-finite output")
        if per_view[wh] != {"blend_fwd": 5, "blend_bwd": 0}:
            failures.append(f"serve {wh}: kernel launches {per_view[wh]}, "
                            f"expected 5 blend_fwd and 0 blend_bwd")

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

    # ---- train: the training path, counted ---------------------------------
    wh = SIZES[0]
    sc = scenes[wh]
    state, src = train_in[wh]
    steps = {mode: trainer.make_train_step(opt, rcfg, state.net, phases[mode])
             for mode in (1, 0)}

    def run_step(state, mode):
        before = dict(blend.LAUNCHES)
        state, aux = steps[mode](state, sc["cam"], 0, sc["gt"], src,
                                 iters[mode], bg, False, 1.0, NET_LR)
        torch.cuda.synchronize()
        row = {k: float(aux[k]) for k in TRAIN_AUX}
        row.update(nonfinite_grads=int(aux["nonfinite_grads"]),
                   n_instances=aux["n_instances"], n_rows=aux["n_rows"],
                   launches={k: blend.LAUNCHES[k] - before[k]
                             for k in before})
        if not all(math.isfinite(row[k]) for k in TRAIN_AUX):
            failures.append(f"train {MODE_NAMES[mode]}: non-finite {row}")
        if row["nonfinite_grads"]:
            failures.append(f"train {MODE_NAMES[mode]}: "
                            f"{row['nonfinite_grads']} non-finite gradients")
        if row["launches"] != {"blend_fwd": 1, "blend_bwd": 1}:
            failures.append(f"train {MODE_NAMES[mode]}: kernel launches "
                            f"{row['launches']}, expected 1 of each")
        return state, row

    reset_launches()
    geo_rows = []
    for _ in range(TRAIN_STEPS):
        state, row = run_step(state, 1)
        geo_rows.append(row)
    geo_launches = dict(blend.LAUNCHES)
    if not geo_rows[-1]["loss"] < geo_rows[0]["loss"]:
        failures.append(f"train: loss did not fall over {TRAIN_STEPS} steps "
                        f"({geo_rows[0]['loss']} -> {geo_rows[-1]['loss']})")
    reset_launches()
    state, color_row = run_step(state, 0)
    color_launches = dict(blend.LAUNCHES)
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
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "walked_pairs": walked,
                "contrib_pairs": contrib_pairs[(wh, mode)], "ops": ops})

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
            "profile": device_profile(train_one, times["median"])}
    emit({"phase": "timing", "blend_fwd": fwd_cases, "blend_bwd": bwd_cases,
          "serve": serve_ms, "train_step": train_ms})

    # ---- kernels -----------------------------------------------------------
    size0 = f"{SIZES[0][0]}x{SIZES[0][1]}"
    fwd_main = next(c for c in fwd_cases
                    if c["mode"] == "render_geo" and c["size"] == size0)
    bwd_main = next(c for c in bwd_cases
                    if c["mode"] == "render_geo" and c["size"] == size0)
    launches_by_path = {k: {"serve": serve_launches[k],
                            "train": train_launches[k]}
                        for k in blend.LAUNCHES}
    emit({"phase": "kernels", "launches": launches_by_path})
    for k, by_path in launches_by_path.items():
        if by_path["train"] == 0:
            failures.append(f"{k} was not launched on the training path")
    if serve_launches["blend_fwd"] == 0:
        failures.append("blend_fwd was not launched on the serving path")
    if color_launches["blend_bwd"] != 1:
        failures.append("the colour-only step did not launch blend_bwd")

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
                "cases": cases}

    emit({"kernels": [
        line("blend_fwd", "ibgs_tpu_torch/ops/csrc/blend_fwd.cu",
             "ibgs_tpu/ops/blend_pallas.py:165", fwd_main, fwd_max_abs_err,
             fwd_cases),
        line("blend_bwd", "ibgs_tpu_torch/ops/csrc/blend_bwd.cu",
             "ibgs_tpu/ops/blend_pallas.py:422", bwd_main, bwd_max_abs_err,
             bwd_cases)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
