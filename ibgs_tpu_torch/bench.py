"""Benchmark: pixels/s/chip of a full differentiable IBGS render step
(counterpart of bench.py; its environment variables are flags here).

    python -m ibgs_tpu_torch.bench [--iters 5] [--repeats 3] [--budget_s 420]
        [--stair 1] [--tile 16x32] [--mode train|render] [--n 100000]
        [--capacity C] [--ckpt bundle.npz] [--width W] [--height H]
        [--cap 0] [--rowcap 0] [--profile DIR] [--device cuda]

Measures the system's north-star metric (BASELINE.json): forward+backward
throughput of the plane-based rasterizer with the image-based warp.  The
default run measures the random 100k-splat scene and, when
`bench_bundle.npz` is at the repo root, the converged bundle, each at
960x544 and 1920x1088; the last config (the converged bundle at 1080p) is
the headline.  `--n` measures the random scene alone at n splats, `--ckpt`
a bundle alone, `--width` / `--height` one resolution; `--mode render`
times the forward-only serving path.  The config list is trimmed, never
reordered, once the run passes `--budget_s`.

One step is bench.py's: the loss dssim_l1(render, gt) + 0.1·mean|warped|
+ 1e-3·mean(median depth) with render_geo, no depth normals and a zero
background; the gradient of every Gaussian parameter at xyz + eps, summed
as Σ‖g‖² (in render mode, the forward's sum of the render, the median
depth and the warped images).  A chain of `--iters` steps carries
eps = acc·1e-30 + i·1e-7 on the device, so no step can be dropped or
reordered, and adds no host synchronise of its own (binning reads its two
list sizes, as every render of the port does).  It is timed with CUDA
events and one synchronise at its end, so the time is the host's whenever
the host is slower than the card; the first chain (`first_s`, the
kernels' build or load included) is reported apart, then the minimum over
`--repeats` chains.

The instance and row lists are sized exactly unless `--cap` / `--rowcap`
are given (then with the JAX package's prefix truncation), so each config
reports the measured `n_instances` / `n_rows`; bench.py's snug caps exist
because XLA needs static shapes.  Beside the wall time each config
reports one profiled step: the card's busy time, its idle share,
the device launches of the step and the blend and warp kernels' launches
of a chain, and the peak memory.  The last line printed is one JSON object in
bench.py's schema.  The run goes to the card unless `--device cpu` is
given; without a card it raises.  bench.py's BENCH_MIXP has no flag: the
JAX epilogue ignores mix_precision, so it changes nothing there either.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ibgs_tpu_torch import convert
from ibgs_tpu_torch.core.camera import look_at_camera, make_camera
from ibgs_tpu_torch.models.gaussians import (PARAM_FIELDS, GaussianModel,
                                             GaussianParams,
                                             init_from_points)
from ibgs_tpu_torch.ops import _cuda
from ibgs_tpu_torch.ops.epilogue import SourceViews
from ibgs_tpu_torch.ops.rasterize import RasterConfig
from ibgs_tpu_torch.renderer import render_view
from ibgs_tpu_torch.train import losses
from ibgs_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BUNDLE = os.path.join(REPO, "bench_bundle.npz")
# bench.py's baseline: the reference paper-era CUDA rasterizer trains
# ~10-15 it/s at 960x544-class resolution on a consumer GPU ≈ 6e6 px/s
# fwd+bwd (an estimate; BASELINE.md)
BASELINE_PIX_S = 6.0e6
S = 4                       # source views of the random scene
DEFAULT_N = 100_000
SIZES = [(960, 544), (1920, 1088)]
# the kernel launches a row reports, by group (keys of _cuda.LAUNCHES)
LAUNCH_GROUPS = {"blend": ("blend_fwd", "blend_bwd"),
                 "warp": ("rgb10_pack", "warp_fwd", "warp_bwd"),
                 "preprocess": ("preprocess_fwd", "preprocess_bwd")}


def round_up(x, m):
    return -(-int(x) // m) * m


def simple_camera(width=64, height=64, fov=0.8, dist=3.0, device="cuda"):
    """The look-at camera of the JAX package's tests/utils.simple_camera."""
    return look_at_camera(eye=[0.0, 0.0, -dist], target=[0.0, 0.0, 0.0],
                          up=[0.0, -1.0, 0.0], fovx=fov, fovy=fov,
                          width=width, height=height, device=device)


def random_model(n: int, capacity: int, device="cuda") -> GaussianModel:
    """bench.py's random scene: n points in [-1, 1]² x [-0.3, 0.3] with
    random colours (default_rng(0)), SH degree 2, through init_from_points
    at `capacity`."""
    r = np.random.default_rng(0)
    pts = (r.random((n, 3)) * 2.0 - 1.0).astype(np.float32)
    pts[:, 2] *= 0.3
    cols = r.random((n, 3)).astype(np.float32)
    return init_from_points(pts, cols, max_sh_degree=2, capacity=capacity,
                            device=device)


def model_from_raw(raw, capacity: int, device="cuda") -> GaussianModel:
    """bench.py's `_model_from_raw`: a bundle's n splats in the first n of
    `capacity` zero-padded slots, alive below n, every SH degree active."""
    n = raw["xyz"].shape[0]
    k_rest = raw["sh_rest"].shape[1]
    deg = {0: 0, 3: 1, 8: 2, 15: 3}[k_rest]
    trail = {"xyz": (3,), "sh_dc": (1, 3), "sh_rest": (k_rest, 3),
             "log_scale": (3,), "quat": (4,), "opacity_logit": (1,),
             "normal": (3,), "offset": (1,)}

    def fill(k):
        out = np.zeros((capacity,) + trail[k], np.float32)
        out[:n] = np.asarray(raw[k], np.float32).reshape((n,) + trail[k])
        return torch.as_tensor(out).to(device)

    return GaussianModel(
        params=GaussianParams(**{k: fill(k) for k in PARAM_FIELDS}),
        alive=torch.arange(capacity, device=device) < n,
        active_sh_degree=deg, max_sh_degree=deg)


def random_draws(rng, W: int, H: int):
    """The random scene's float64 draws from the shared `rng`, in
    bench.py's order: S source images, their centres, the ground truth."""
    images = rng.random((S, H, W, 3))
    cam_pos = rng.random((S, 3)) * 0.1
    return images, cam_pos, rng.random((H, W, 3))


def make_inputs(rng, bundle, W: int, H: int, device="cuda"):
    """bench.py's `make_inputs`: (camera, sources, ground truth).  The
    random scene draws its S source images, their centres and the ground
    truth from the shared `rng`, in that order (identity ref_to_src, depth
    3.0); a bundle gives its own camera, sources and ground truth, resized
    when the size differs."""
    if bundle is not None:
        cam = make_camera(bundle["cam_R"], bundle["cam_t"],
                          float(bundle["fovx"]), float(bundle["fovy"]), W,
                          H, device)
        # bilinear with half-pixel centres: for the bundle's upsampling
        # to 1920x1088 this is bench.py's jax.image.resize
        src = SourceViews(
            images=convert._resize(bundle["src_images"], H, W, device),
            depths=convert._resize(
                np.asarray(bundle["src_depths"])[..., None], H, W,
                device)[..., 0],
            ref_to_src=torch.as_tensor(np.asarray(
                bundle["src_ref_to_src"], np.float32)).to(device),
            cam_pos=torch.as_tensor(np.asarray(
                bundle["src_cam_pos"], np.float32)).to(device),
            count=int(bundle["src_count"]))
        return cam, src, convert._resize(bundle["gt"], H, W, device)

    images, cam_pos, gt = (torch.as_tensor(x.astype(np.float32)).to(device)
                           for x in random_draws(rng, W, H))
    cam = simple_camera(W, H, device=device)
    src = SourceViews(
        images=images,
        depths=torch.full((S, H, W), 3.0, device=device),
        ref_to_src=torch.eye(4, device=device)[None].repeat(S, 1, 1),
        cam_pos=cam_pos, count=S)
    return cam, src, gt


def bench_loss(res, gt) -> torch.Tensor:
    """bench.py's loss (:246-255)."""
    return (losses.dssim_l1(res.render, gt)
            + 0.1 * res.ibr.warped_image.abs().mean()
            + 1e-3 * res.median_depth.mean())


def step_value(model: GaussianModel, cam, cfg: RasterConfig, src, gt, eps,
               mode: str = "train"):
    """One bench step at xyz + eps: (Σ‖g‖² over every parameter's
    gradient, or in render mode the forward sum; the render result; the
    loss or None)."""
    bg = torch.zeros(3, device=model.alive.device)
    if mode == "render":
        with torch.no_grad():
            m = dataclasses.replace(model, params=dataclasses.replace(
                model.params, xyz=model.params.xyz + eps))
            res, _ = render_view(m, cam, cfg, bg, src=src, render_geo=True,
                                 return_depth_normal=False)
            return (res.render.sum() + res.median_depth.sum()
                    + res.ibr.warped_image.sum()), res, None
    leaves = GaussianParams(**{
        k: getattr(model.params, k).detach().requires_grad_(True)
        for k in PARAM_FIELDS})
    m = dataclasses.replace(model, params=dataclasses.replace(
        leaves, xyz=leaves.xyz + eps))
    res, _ = render_view(m, cam, cfg, bg, src=src, render_geo=True,
                         return_depth_normal=False)
    loss = bench_loss(res, gt)
    g = torch.autograd.grad(loss, [getattr(leaves, k) for k in PARAM_FIELDS],
                            allow_unused=True)
    return (sum((x * x).sum() for x in g if x is not None), res,
            loss.detach())


def chain(model, cam, cfg, src, gt, k: int, mode: str = "train"):
    """k chained steps (bench.py :273-280): step i runs at eps = acc·1e-30
    + i·1e-7, acc the running sum on the device; each step is labelled
    "bench_step" in a trace.  Returns (acc, the last step's render
    result)."""
    acc = torch.zeros((), dtype=torch.float32, device=model.alive.device)
    res = None
    for i in range(k):
        with profiling.annotate("bench_step"):
            eps = acc * 1e-30 + float(np.float32(i) * np.float32(1e-7))
            v, res, _ = step_value(model, cam, cfg, src, gt, eps, mode)
            acc = acc + v
    return acc, res


def smi_line() -> str:
    """nvidia-smi's name and power limit of the card ("" where it cannot
    run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def device_info(dev) -> dict:
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None, "nvidia_smi": None}
    smi = smi_line()
    return {"name": torch.cuda.get_device_name(dev),
            "power_limit": smi.split(",")[-1].strip() if smi else None,
            "nvidia_smi": smi or None}


def resolve_device(name: str) -> torch.device:
    """The torch device of a run; a card that is not there raises, naming
    `--device cpu` (there is no silent fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    return dev


def build_parser():
    p = argparse.ArgumentParser(description="ibgs_tpu_torch benchmark: "
                                            "pixels/s/chip")
    p.add_argument("--iters", type=int, default=5, help="steps per chain")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed chains (the minimum is kept)")
    p.add_argument("--budget_s", type=float, default=420.0,
                   help="no new config starts past this many seconds")
    p.add_argument("--stair", type=int, default=1,
                   help="1: staircase binning")
    p.add_argument("--tile", default="16x32", help="tile HxW")
    p.add_argument("--mode", default="train", choices=("train", "render"))
    p.add_argument("--n", type=int, default=None,
                   help="random-scene splats (given: the random scene "
                        "alone; default 100000)")
    p.add_argument("--capacity", type=int, default=None,
                   help="model capacity (default 1.31 x splats, rounded "
                        "up to 1024)")
    p.add_argument("--ckpt", default="", help="measure only this bundle")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--cap", type=int, default=0,
                   help="instance cap (0: sized exactly)")
    p.add_argument("--rowcap", type=int, default=0,
                   help="staircase row cap (0: sized exactly, or cap / 2 "
                        "under --cap)")
    p.add_argument("--profile", default="",
                   help="write a Chrome trace (with Python frames) of one "
                        "chain per config here")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    return p


def run_config(args, dev, rng, model, bundle, n_splats, label, W, H):
    """Time one config; returns its row of `detail.configs`."""
    th, tw = (int(x) for x in args.tile.split("x"))
    cfg = RasterConfig(tile_h=th, tile_w=tw, instance_cap=args.cap,
                       staircase_cull=bool(args.stair), row_cap=args.rowcap)
    if bundle is None and args.cap == 0 and not (
            args.n in (None, DEFAULT_N) and (th, tw) == (16, 32)
            and (W, H) in SIZES):
        # bench.py's snug-cap count pass draws one set of inputs first
        random_draws(rng, W, H)
    cam, src, gt = make_inputs(rng, bundle, W, H, dev)
    k = args.iters

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    v, res = chain(model, cam, cfg, src, gt, k, args.mode)
    v = float(v)
    first_s = time.perf_counter() - t0
    if not np.isfinite(v):
        raise FloatingPointError(f"{label} {W}x{H}: non-finite bench value "
                                 f"{v}")
    if args.profile:
        with profiling.trace(os.path.join(args.profile, f"{label}_{W}x{H}"),
                             with_stack=True):
            chain(model, cam, cfg, src, gt, k, args.mode)
            sync()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    best = float("inf")
    for r in range(args.repeats):
        before = dict(_cuda.LAUNCHES)
        best = min(best, profiling.wall_ms(
            lambda: chain(model, cam, cfg, src, gt, k, args.mode),
            device=dev) / 1e3)
        if r == 0:
            chain_launches = {n: _cuda.LAUNCHES[n] - before[n]
                              for n in before}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    dt = best / k
    prof = profiling.idle_share(profiling.device_time(
        lambda: chain(model, cam, cfg, src, gt, 1, args.mode), dev), dt * 1e3)
    row = {
        "config": label, "resolution": f"{W}x{H}", "splats": n_splats,
        "step_ms": round(dt * 1e3, 2),
        "mpix_s": round(H * W / dt / 1e6, 3),
        "vs_baseline": round(H * W / dt / BASELINE_PIX_S, 4),
        "first_s": round(first_s, 1),
        "n_instances": res.n_instances, "n_rows": res.n_rows,
        "value": v,
        "device_busy_ms": prof.get("device_busy_ms"),
        "idle_share": prof["idle_share"],
        "launches": prof.get("device_launches"),
        **{f"{group}_launches": {n: chain_launches[n] for n in names}
           for group, names in LAUNCH_GROUPS.items()},
        "chain_iters": k,
        "max_memory_allocated": peak,
    }
    if "error" in prof:
        row["profile_error"] = prof["error"]
    return row


def run(args) -> dict:
    """The config list of bench.py (:309-348) → the result dict."""
    dev = resolve_device(args.device)
    n = DEFAULT_N if args.n is None else args.n
    if args.width or args.height:
        res_list = [(args.width or 960, args.height or 544)]
    else:
        res_list = list(SIZES)
    ckpt = args.ckpt
    jobs = []               # (kind, W, H); the last is the headline
    if ckpt:
        jobs += [("ckpt", W, H) for W, H in res_list]
    else:
        jobs += [("random", W, H) for W, H in res_list]
        if os.path.exists(DEFAULT_BUNDLE) and args.n is None:
            ckpt = DEFAULT_BUNDLE
            jobs += [("ckpt", W, H) for W, H in res_list]
    bundle = dict(np.load(ckpt)) if ckpt else None
    rng = np.random.default_rng(0)
    models = {}

    def get_model(kind):
        if kind not in models:
            m = bundle["xyz"].shape[0] if kind == "ckpt" else n
            cap = args.capacity or round_up(1.31 * m, 1024)
            models[kind] = ((model_from_raw(bundle, cap, dev), m)
                            if kind == "ckpt"
                            else (random_model(n, cap, dev), m))
        return models[kind]

    t_start = time.perf_counter()
    results, skipped = [], []
    for kind, W, H in jobs:
        if results and time.perf_counter() - t_start > args.budget_s:
            skipped.append(f"{kind}@{W}x{H}")
            continue
        model, n_splats = get_model(kind)
        label = "converged" if kind == "ckpt" else "random"
        results.append(run_config(args, dev, rng, model,
                                  bundle if kind == "ckpt" else None,
                                  n_splats, label, W, H))

    head = results[-1]
    kind = "render-only" if args.mode == "render" else "fwd+bwd"
    scene = "%s %dk splats" % (head["config"], head["splats"] // 1000)
    out = {
        "metric": "%s pixels/s/chip (IBGS geo render, %s, %s)"
                  % (kind, head["resolution"], scene),
        "value": round(head["mpix_s"] * 1e6, 1),
        "unit": "pixels/s",
        "vs_baseline": head["vs_baseline"],
        "detail": {"configs": results, "chain_iters": args.iters,
                   "repeats": args.repeats,
                   "backend": "cuda" if dev.type == "cuda" else "plain",
                   "mode": args.mode,
                   "ckpt": os.path.basename(ckpt) if ckpt else None,
                   "device": device_info(dev)},
    }
    if skipped:
        out["detail"]["skipped_over_budget"] = skipped
    return out


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
