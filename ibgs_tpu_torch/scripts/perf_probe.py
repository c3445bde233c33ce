"""Per-stage performance probe of the render pipeline (counterpart of the
stage probes of scripts/perf_probe.py; its environment variables are
flags here).

    python -m ibgs_tpu_torch.scripts.perf_probe [--width 960] [--height 544]
        [--n 100000] [--cap 2097152] [--iters 5] [--device cuda]

At the JAX probe's configuration (960x544, n random splats from
default_rng(0), 8x16 tiles, AABB binning under `--cap`, S = 4 sources) it
runs each stage `--iters` times in a host loop, each call depending on the
last through a scalar carried on the device:

  A   stage_pre_bin_pack_fwd      preprocess + binning + pack_rows
  A2  stage_pre_bin_pack_fwd_bwd  the same and the gradient of every
                                  Gaussian parameter through it
  B   stage_blend_fwd             the blend forward (render_geo, B = 4)
  C   stage_blend_fwd_bwd         the blend forward and backward
  D   stage_epilogue_fwd          the IBR epilogue
  E   stage_epilogue_fwd_bwd      the epilogue and its gradient w.r.t. the
                                  median buffer's depths and weights

One JSON line per stage: `ms`, the wall time per call (CUDA events around
the loop after one warm-up call); `device_busy_ms` and `device_launches`
of one call (torch.profiler); `host_ms` = ms - device_busy_ms, the time
the card waits for the host; `profile_error` where the profiler lost a
launch's device event or counted more busy time than `ms`.  On the CPU
only `ms` is measured.  The JAX probe's gather cost model (its part 1)
has no counterpart: it measures XLA gather layouts on the TPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from ibgs_tpu_torch.bench import S, resolve_device, simple_camera
from ibgs_tpu_torch.models.gaussians import (PARAM_FIELDS, GaussianParams,
                                             init_from_points)
from ibgs_tpu_torch.ops import blend
from ibgs_tpu_torch.ops.blend_common import BlendConfig
from ibgs_tpu_torch.ops.epilogue import SourceViews, ibr_epilogue
from ibgs_tpu_torch.ops.rasterize import RasterConfig, prepare
from ibgs_tpu_torch.utils import profiling

STAGES = ("stage_pre_bin_pack_fwd", "stage_pre_bin_pack_fwd_bwd",
          "stage_blend_fwd", "stage_blend_fwd_bwd", "stage_epilogue_fwd",
          "stage_epilogue_fwd_bwd")
TILE_H, TILE_W = 8, 16


def run(W=960, H=544, n=100_000, cap=1 << 21, iters=5, device="cuda",
        emit=None) -> list:
    """Every stage's record (also passed to `emit`)."""
    dev = torch.device(device)
    records = []

    def out(rec):
        records.append(rec)
        if emit is not None:
            emit(rec)

    rng = np.random.default_rng(0)
    pts = (rng.random((n, 3)) * 2.0 - 1.0).astype(np.float32)
    pts[:, 2] *= 0.3
    cols = rng.random((n, 3)).astype(np.float32)
    model = init_from_points(pts, cols, max_sh_degree=2, device=dev)
    cam = simple_camera(W, H, device=dev)
    rcfg = RasterConfig(tile_h=TILE_H, tile_w=TILE_W, instance_cap=cap)
    cfg = BlendConfig(tile_h=TILE_H, tile_w=TILE_W, buffer_len=4,
                      render_geo=True, depth_only=False)

    def front(params: GaussianParams):
        m = dataclasses.replace(model, params=params)
        nw, off = m.oriented_normal(cam.cam_pos, learnt=True)
        return prepare(xyz=params.xyz, scale=m.scale, quat=m.quat_unit,
                       opacity=m.opacity, sh_coeffs=m.sh_coeffs,
                       active_sh_degree=m.active_sh_degree, normal_world=nw,
                       plane_offset=off, cam=cam, cfg=rcfg, alive=m.alive)

    def shifted(params, c):
        return dataclasses.replace(params, xyz=params.xyz + c * 1e-9)

    def leaves():
        return GaussianParams(**{
            k: getattr(model.params, k).detach().requires_grad_(True)
            for k in PARAM_FIELDS})

    def stage_a(c):
        with torch.no_grad():
            pr = front(shifted(model.params, c))
        return pr.feats_inst[:, 0].sum() * 1e-30

    def stage_a2(c):
        p = leaves()
        pr = front(shifted(p, c))
        g = torch.autograd.grad((pr.feats_inst * 1e-6).sum(),
                                [getattr(p, k) for k in PARAM_FIELDS],
                                allow_unused=True)
        return g[0].sum() * 1e-30

    with torch.no_grad():
        pr = front(model.params)
    feats, bins = pr.feats_inst.detach(), pr.bins
    out({"probe": "scene", "n_instances": bins.n_instances, "cap": cap,
         "device": str(dev)})

    def blend_fwd(f):
        return blend.blend_packed(f, bins, pr.Wp, pr.Hp, cam.fx, cam.fy,
                                  cam.cx, cam.cy, cfg)

    def moved(c):
        f = feats.clone()
        f[0, 0] += c * 1e-9
        return f

    def stage_b(c):
        with torch.no_grad():
            o = blend_fwd(moved(c))
        return o.color.sum() * 1e-30

    def stage_c(c):
        f = moved(c).requires_grad_(True)
        o = blend_fwd(f)
        v = (o.color.sum() + o.normal.sum() + o.final_t.sum()
             + o.buf_depth.sum() + o.buf_weight.sum())
        g, = torch.autograd.grad(v, f)
        return g[:, 0].sum() * 1e-30

    with torch.no_grad():
        crop = blend_fwd(feats).crop(H, W)
    src = SourceViews(
        images=torch.as_tensor(rng.random((S, H, W, 3)).astype(np.float32)
                               ).to(dev),
        depths=torch.full((S, H, W), 3.0, device=dev),
        ref_to_src=torch.eye(4, device=dev)[None].repeat(S, 1, 1),
        cam_pos=torch.as_tensor((rng.random((S, 3)) * 0.1).astype(
            np.float32)).to(dev), count=S)

    def stage_d(c):
        with torch.no_grad():
            b2 = dataclasses.replace(crop, buf_depth=crop.buf_depth + c * 1e-9)
            ibr = ibr_epilogue(b2, cam, src, 0.01)
        return (ibr.warped_image.sum() + ibr.median_depth.sum()) * 1e-30

    def stage_e(c):
        bd = (crop.buf_depth + c * 1e-9).requires_grad_(True)
        bw = crop.buf_weight.clone().requires_grad_(True)
        ibr = ibr_epilogue(dataclasses.replace(crop, buf_depth=bd,
                                               buf_weight=bw), cam, src, 0.01)
        g1, g2 = torch.autograd.grad(
            ibr.warped_image.sum() + ibr.median_depth.sum(), [bd, bw])
        return (g1.sum() + g2.sum()) * 1e-30

    for name, body in zip(STAGES, (stage_a, stage_a2, stage_b, stage_c,
                                   stage_d, stage_e)):
        carry = {"c": torch.zeros((), device=dev)}

        def call():
            carry["c"] = body(carry["c"]).detach()

        ms = profiling.wall_ms(call, iters, warmup=1, device=dev)
        prof = profiling.idle_share(profiling.device_time(call, dev), ms)
        rec = {"probe": name, "ms": ms,
               "device_busy_ms": prof.get("device_busy_ms"),
               "device_launches": prof.get("device_launches"),
               "host_ms": (ms - prof["device_busy_ms"]
                           if "device_busy_ms" in prof else None),
               "iters": iters}
        if "error" in prof:
            rec["profile_error"] = prof["error"]
        if not bool(torch.isfinite(carry["c"])):
            raise FloatingPointError(f"{name}: non-finite carry")
        out(rec)
    out({"probe": "done"})
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ibgs_tpu_torch stage probe")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=544)
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--cap", type=int, default=1 << 21,
                   help="instance cap (0: sized exactly)")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    run(a.width, a.height, a.n, a.cap, a.iters, resolve_device(a.device),
        emit=lambda r: print(json.dumps(r), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
