"""The Gaussian-sharded step's cost on one card (counterpart of
scripts/gsp_tax.py; its environment variables are flags here).

    python -m ibgs_tpu_torch.scripts.gsp_tax [--width 960] [--height 544]
        [--n 100000] [--cap 629000] [--rowcap 301000] [--capacity 131072]
        [--iters 5] [--repeats 3] [--tile 16x32] [--generic]
        [--profile DIR] [--device cuda]

Times the full-objective training step at the bench scene (n random
splats, S = 4 sources, the fusion net on) two ways in one process:

  unsharded  train/trainer.make_train_step (the single-card trainer)
  gsp_1x1    parallel/gsp.gsp_full_train_step on a 1 x 1 ("dp", "gs")
             mesh; with `--generic` (gsp_1x1_generic) the exchange cap is
             cap - 1, which bypasses the identity fast path and drops
             nothing at the bench scene

The difference is the sharded machinery's single-card cost.  Each chain
runs `--iters` steps (iterations 100, 101, ...) from the same state; the
first chain (`first_s`) is reported apart, then the minimum over
`--repeats` chains (CUDA events).  Each variant's step is built, and the
model sharded, once before its chains, as in the JAX script.  One JSON line per variant, with the
first step's loss (the variants must agree), then the tax line.
`--profile DIR` instead writes a Chrome trace of one chain of the
unsharded step (for parse_trace.py) and stops.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ibgs_tpu_torch.bench import S, resolve_device, simple_camera
from ibgs_tpu_torch.config import OptimizationParams
from ibgs_tpu_torch.models.aggregation import (ColorFusionResidualNet,
                                               init_fusion_net)
from ibgs_tpu_torch.models.gaussians import init_from_points
from ibgs_tpu_torch.ops.epilogue import SourceViews
from ibgs_tpu_torch.ops.rasterize import RasterConfig
from ibgs_tpu_torch.train import trainer
from ibgs_tpu_torch.utils import profiling


def build_parser():
    p = argparse.ArgumentParser(description="ibgs_tpu_torch GSP tax")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=544)
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--cap", type=int, default=629_000)
    p.add_argument("--rowcap", type=int, default=301_000)
    p.add_argument("--capacity", type=int, default=131_072)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--tile", default="16x32")
    p.add_argument("--generic", action="store_true",
                   help="force the generic exchange (exchange cap = cap-1)")
    p.add_argument("--profile", default="",
                   help="trace one unsharded chain here and stop")
    p.add_argument("--device", default="cuda")
    return p


def run(args, emit=None) -> list:
    """The variants' records and the tax record (also passed to `emit`)."""
    import torch.distributed as dist

    from ibgs_tpu_torch.parallel import distributed, gsp, sharding

    dev = resolve_device(args.device)
    W, H, n, cap = args.width, args.height, args.n, args.cap
    records = []

    def out(rec):
        records.append(rec)
        if emit is not None:
            emit(rec)

    rng = np.random.default_rng(0)
    pts = (rng.random((n, 3)) * 2.0 - 1.0).astype(np.float32)
    pts[:, 2] *= 0.3
    model = init_from_points(pts, rng.random((n, 3)).astype(np.float32),
                             max_sh_degree=2, capacity=args.capacity,
                             device=dev)
    cam = simple_camera(W, H, device=dev)
    th, tw = (int(x) for x in args.tile.split("x"))
    rcfg = RasterConfig(instance_cap=cap, tile_h=th, tile_w=tw,
                        staircase_cull=True, row_cap=args.rowcap)
    opt = OptimizationParams(
        use_color_aggregation=True, number_src_frames=S,
        nb_visible_src_frames=3, single_view_weight_from_iter=0,
        multi_view_weight_from_iter=0, start_color_aggregation_iter=0,
        position_lr_max_steps=30_000)
    phase = trainer.StepPhase(render_geo=True, use_aggregation=True)
    net = init_fusion_net(ColorFusionResidualNet(
        32, opt.feat_aggregate_mode), torch.Generator().manual_seed(0)).to(dev)
    app_ab = torch.zeros(trainer.APP_CAPACITY, 2, device=dev)
    state = trainer.TrainState(
        model=model, app_ab=app_ab,
        app_opt=trainer.SideOptState.init([app_ab]), net=net,
        net_opt=trainer.SideOptState.init(list(net.parameters())),
        spatial_lr_scale=1.0)

    def t(x):
        return torch.as_tensor(x.astype(np.float32)).to(dev)

    src = SourceViews(
        images=t(rng.random((S, H, W, 3))),
        depths=torch.full((S, H, W), 3.0, device=dev),
        ref_to_src=torch.eye(4, device=dev)[None].repeat(S, 1, 1),
        cam_pos=t(rng.random((S, 3)) * 0.1), count=S)
    gt = t(rng.random((H, W, 3)))
    common = (torch.zeros(3, device=dev), True, 1.0, 1e-3)

    net_init = copy.deepcopy(net.state_dict())

    def start(st_init):
        """A copy of `st_init` whose net is `net` at its initial weights:
        both steps are built once over `net` and update it in place."""
        net.load_state_dict(net_init)
        return dataclasses.replace(copy.deepcopy(st_init), net=net)

    def time_chain(step, st_init, label):
        """Chains of `iters` steps of the built `step`, each from
        `start(st_init)`, made before the chain is timed."""
        def chain(st):
            losses = []
            for i in range(args.iters):
                st, aux = step(st, 100 + i)
                losses.append(aux["loss"])
            return st, losses

        st0 = start(st_init)
        t0 = time.perf_counter()
        st, losses = chain(st0)
        v = float(st.model.params.xyz.sum())
        first_s = time.perf_counter() - t0
        if not np.isfinite(v):
            raise FloatingPointError(f"{label}: non-finite parameters")
        best = float("inf")
        for _ in range(args.repeats):
            st0 = start(st_init)
            best = min(best, profiling.wall_ms(lambda: chain(st0),
                                               device=dev))
        rec = {"variant": label, "step_ms": best / args.iters,
               "first_s": first_s, "loss": float(losses[0]),
               "last_loss": float(losses[-1])}
        out(rec)
        return rec

    ustep = trainer.make_train_step(opt, rcfg, net, phase)

    def unsharded(s, it):
        return ustep(s, cam, 0, gt, src, it, *common)

    u = time_chain(unsharded, state, "unsharded")
    if args.profile:
        st = start(state)
        with profiling.trace(args.profile):
            for i in range(args.iters):
                st, _ = unsharded(st, 100 + i)
            float(st.model.params.xyz.sum())
        out({"profile": args.profile, "chain_iters": args.iters})
        return records

    opened = not dist.is_initialized()
    mesh = distributed.global_mesh(1, 1, ("dp", "gs"), dev)
    try:
        cam_arrays = sharding._cam_stack([cam])
        srcs = sharding.stack_sources([src])

        gstate = dataclasses.replace(
            state, model=gsp.shard_model(state.model, mesh))
        gstep = gsp.gsp_full_train_step(
            opt, rcfg, net, phase, mesh, W, H, cap_local=cap,
            exchange_cap=cap - 1 if args.generic else cap)

        def gsp1(s, it):
            return gstep(s, cam_arrays, [0], gt[None], srcs, it, *common)

        g = time_chain(gsp1, gstate, "gsp_1x1_generic" if args.generic
                       else "gsp_1x1")
    finally:
        if opened:
            dist.destroy_process_group()
    ms_u, ms_g = u["step_ms"], g["step_ms"]
    out({"metric": "GSP tax at bench scene"
                   + (" (generic exchange forced)" if args.generic else ""),
         "unsharded_ms": ms_u, "gsp_1x1_ms": ms_g, "tax_ms": ms_g - ms_u,
         "tax_pct": 100 * (ms_g - ms_u) / ms_u})
    return records


def main(argv=None) -> int:
    run(build_parser().parse_args(argv),
        emit=lambda r: print(json.dumps(r), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
