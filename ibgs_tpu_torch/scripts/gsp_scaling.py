"""Gaussian-sharded rendering's work-scaling sweep (counterpart of
scripts/gsp_scaling.py).

    python -m ibgs_tpu_torch.scripts.gsp_scaling --device cpu [--time]
    python -m ibgs_tpu_torch.scripts.gsp_scaling --device cuda [--time]

For gs in 1, 2, 4, 8 it spawns gs ranks (`parallel/_spawn`: gloo on the
CPU, NCCL with one card per rank) on a 1 x gs ("dp", "gs") mesh and
renders the JAX sweep's scene (64x128, 2,000 random points from
default_rng(0), capacity 2048, SH degree 1, instance cap 65,536) through
`gsp_render`, with caps that shrink as the mesh grows (ceil(65536 / gs)
local instances, ceil(65536 / gs²) exchanged rows per pair).  One JSON
line per mesh size: the Gaussians per rank, both caps, the scene's
instances, the overflow, the largest error against the replicated render,
and whether that is within 1e-5 (`exact`).  `--time` adds the wall time
of a render (the mean of 10 after 2 warm-ups), rays/s and the efficiency
against one rank.  NCCL puts no two ranks on one card, so on cards a mesh
larger than the card count raises before anything runs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

W, H, N_POINTS, CAPACITY, CAP = 64, 128, 2000, 2048, 65536
GS = (1, 2, 4, 8)
RANK_FN = "ibgs_tpu_torch.scripts.gsp_scaling:rank_row"
TIMED_RENDERS = 10


def caps(gs: int):
    """(local instance cap, exchanged rows per pair) at gs shards."""
    return -(-CAP // gs), -(-CAP // (gs * gs))


def rank_row(gs: int, device: str, do_time: bool) -> dict:
    """One rank of a 1 x gs mesh: the sweep's row (the same on every
    rank).  Call inside an initialised process group of gs ranks."""
    from ibgs_tpu_torch.bench import simple_camera
    from ibgs_tpu_torch.models.gaussians import init_from_points
    from ibgs_tpu_torch.ops import preprocess as pp
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    from ibgs_tpu_torch.parallel.gsp import gsp_render, make_gsp_render
    from ibgs_tpu_torch.parallel.sharding import make_mesh
    from ibgs_tpu_torch.renderer import render_view

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    pts = (rng.random((N_POINTS, 3)) * 1.2 - 0.6).astype(np.float32)
    model = init_from_points(pts, rng.random((N_POINTS, 3)).astype(
        np.float32), max_sh_degree=1, capacity=CAPACITY, device=dev)
    cam = simple_camera(W, H, device=dev)
    cfg = RasterConfig(instance_cap=CAP)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        ref, _ = render_view(model, cam, cfg, bg, render_geo=False,
                             return_depth_normal=False)
        nw, off = model.oriented_normal(cam.cam_pos, learnt=True)
        sp = pp.preprocess(model.params.xyz, model.scale, model.quat_unit,
                           model.opacity, model.sh_coeffs,
                           model.active_sh_degree, nw, off, cam, cfg.tile_h,
                           cfg.tile_w, alive=model.alive)
        total_inst = int(torch.clamp(sp.n_tiles, min=0).sum())
        mesh = make_mesh(1, gs, device=dev, axis_names=("dp", "gs"))
        cap_local, cap_e = caps(gs)
        img, ovf = gsp_render(model, cam, cfg, mesh, cap_local=cap_local,
                              exchange_cap=cap_e, bg=bg)
    err = float((img - ref.render).abs().max())
    row = {"gs": gs, "gaussians_per_device": model.capacity // gs,
           "instances_binned_per_device_cap": cap_local,
           "exchange_rows_per_pair_cap": cap_e,
           "total_scene_instances": total_inst, "overflow": int(ovf),
           "max_err_vs_replicated": err, "exact": bool(err < 1e-5)}
    if do_time:
        rfn = make_gsp_render(W, H, cfg, mesh, cap_local=cap_local,
                              exchange_cap=cap_e)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        with torch.no_grad():
            for _ in range(2):
                rfn(model, cam, bg)
            sync()
            t0 = time.perf_counter()
            for _ in range(TIMED_RENDERS):
                rfn(model, cam, bg)
            sync()
        dt = (time.perf_counter() - t0) / TIMED_RENDERS
        row.update(wall_ms=dt * 1e3, rays_per_s=W * H / dt)
    return row


def sweep(sizes=GS, device="cpu", do_time=False, workdir=None, emit=None):
    """One row per mesh size, each from a spawn of gs ranks."""
    from ibgs_tpu_torch.parallel import _spawn

    dev = torch.device(device)
    if dev.type == "cuda" and max(sizes) > torch.cuda.device_count():
        raise RuntimeError(
            f"a {max(sizes)}-rank mesh needs {max(sizes)} cards, this host "
            f"has {torch.cuda.device_count()} (NCCL puts no two ranks on "
            f"one card): pass --device cpu to sweep on gloo ranks")
    rows, t_base = [], None
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        for gs in sizes:
            row = _spawn.run(RANK_FN, gs, os.path.join(tmp, f"gs{gs}"), gs,
                             str(dev), do_time, device=str(dev))[0]
            if do_time:
                t_base = t_base or row["wall_ms"]
                row["efficiency_vs_1dev"] = t_base / row["wall_ms"]
            rows.append(row)
            if emit is not None:
                emit(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ibgs_tpu_torch GSP scaling "
                                            "sweep")
    p.add_argument("--time", action="store_true",
                   help="also time a render per mesh size")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    from ibgs_tpu_torch.bench import resolve_device
    sweep(GS, resolve_device(a.device), a.time,
          emit=lambda r: print(json.dumps(r), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
