"""Production training runs of the port on the synthetic scene
(counterparts of the JAX package's scripts/tpu_prod_run.py,
tpu_ref30k_run.py and tpu_train_validation.py; their environment
variables are flags here).

    python -m ibgs_tpu_torch.scripts.train_runs prod [out] [resume_ckpt] \\
        [--iters 5000] [--width 960] [--height 544] [--gt 150000] \\
        [--seed_pts 20000] [--grad_th 2e-4] [--abs_th 4e-4] \\
        [--cap 524288] [--rowcap 0] [--init_capacity 0] [--debug 0] \\
        [--log_every 100] [--bundle out.npz]
    python -m ibgs_tpu_torch.scripts.train_runs ref30k [out] [resume_ckpt] \\
        [--iters 30000] [--debug 1] [--cap 524288] [--eval_cap 2097152] \\
        [--bundle build/train_runs/ref30k_bundle.npz]
    python -m ibgs_tpu_torch.scripts.train_runs validation [out] [resume]

* `prod`: 960x544, 16 views, 150k ground-truth points, 20k seed splats;
  densify from 500 every 100 until 70% of the run, geometry losses from
  700, aggregation from 1500; an evaluation and a checkpoint every 1,000
  iterations.  The aggressive thresholds (`--grad_th 8e-5 --abs_th
  1.6e-4`) grow the splat count and the capacity on the card.
* `ref30k`: the shipped `OptimizationParams` defaults (the reference's
  30k schedule), the debug trip wire armed, then the test split's base
  and aggregate PSNR through `EvalRenderer.render_one`, and a bench
  bundle (under build/ unless `--bundle` says otherwise).
* `validation`: the 128x128 run through every phase switch.

Every run ends with one JSON line: wall time, it/s, the final point
count, the logged PSNR trajectory, the evaluations' PSNR and, on the
card, `torch.cuda.max_memory_allocated` / `max_memory_reserved`.  To
cut a run short in process, change the fields of the `Plan` that
`plan(argv)` returns (`opt`, `pipe`, `train`) before `run(plan)`.  The
run goes to the card unless `--device cpu` is given; a failed bundle
write raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ibgs_tpu_torch.config import (ModelParams, OptimizationParams,
                                   PipelineParams)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD = os.path.join(REPO, "build", "train_runs")


@dataclasses.dataclass
class Plan:
    """One run: what the JAX script passes to make_synthetic_scene and
    train, and the run's own settings."""
    cmd: str
    out: str
    start_checkpoint: Optional[str]
    scene: dict                 # make_synthetic_scene keyword arguments
    mp: ModelParams
    opt: OptimizationParams
    pipe: PipelineParams
    train: dict                 # the event lists, log_every, quiet
    bundle: str = ""            # bench bundle path ("" = none)
    eval_cap: int = 0           # base-vs-aggregate renders' cap (0 = none)
    device: str = "cuda"


def build_parser():
    p = argparse.ArgumentParser(description="ibgs_tpu_torch training runs")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, out, iters, log_every, debug, cap, bundle):
        sp.add_argument("out", nargs="?", default=os.path.join(BUILD, out))
        sp.add_argument("resume", nargs="?", default=None,
                        help="a chkpnt<N>.npz to resume from")
        sp.add_argument("--iters", type=int, default=iters)
        sp.add_argument("--log_every", type=int, default=log_every)
        sp.add_argument("--debug", type=int, default=debug,
                        help="1: per-step non-finite check (trip wire)")
        sp.add_argument("--cap", type=int, default=cap,
                        help="instance_cap (grows on overflow)")
        sp.add_argument("--bundle", default=bundle,
                        help="write a bench bundle here after the run")
        sp.add_argument("--device", default="cuda",
                        help="torch device of the run (default cuda)")

    def scene_flags(sp):
        sp.add_argument("--width", type=int, default=960)
        sp.add_argument("--height", type=int, default=544)
        sp.add_argument("--gt", type=int, default=150_000)
        sp.add_argument("--seed_pts", type=int, default=20_000)

    pr = sub.add_parser("prod", help="bench-scale run (tpu_prod_run.py)")
    common(pr, "prod", 5000, 100, 0, 1 << 19, "")
    scene_flags(pr)
    pr.add_argument("--grad_th", type=float, default=2e-4)
    pr.add_argument("--abs_th", type=float, default=4e-4)
    pr.add_argument("--rowcap", type=int, default=0)
    pr.add_argument("--init_capacity", type=int, default=0)

    rf = sub.add_parser("ref30k", help="the reference's 30k schedule "
                                       "(tpu_ref30k_run.py)")
    common(rf, "ref30k", 30_000, 100, 1, 1 << 19,
           os.path.join(BUILD, "ref30k_bundle.npz"))
    scene_flags(rf)
    rf.add_argument("--views", type=int, default=16)
    rf.add_argument("--eval_cap", type=int, default=1 << 21)

    va = sub.add_parser("validation", help="128x128 full-cadence run "
                                           "(tpu_train_validation.py)")
    common(va, "validation", 3000, 200, 0, 1 << 17, "")
    va.add_argument("--no_eval", action="store_true")
    return p


def plan(argv=None) -> Plan:
    """The run a command line asks for, without building anything."""
    a = build_parser().parse_args(argv)
    it = a.iters
    if a.cmd == "prod":
        scene = dict(n_views=16, width=a.width, height=a.height, n_gt=a.gt,
                     n_seed=a.seed_pts, eval_every=8)
        opt = dict(
            iterations=it, densify_from_iter=500, densification_interval=100,
            densify_until_iter=int(it * 0.7), opacity_reset_interval=3000,
            densify_grad_threshold=a.grad_th,
            densify_abs_grad_threshold=a.abs_th,
            single_view_weight_from_iter=700,
            multi_view_weight_from_iter=700,
            use_color_aggregation=True, start_color_aggregation_iter=1500,
            color_aggregate_burnin_steps=500, number_src_frames=4,
            nb_visible_src_frames=3, position_lr_max_steps=it)
        pipe = PipelineParams(instance_cap=a.cap, row_cap=a.rowcap,
                              staircase_cull=True, debug=a.debug == 1)
        mp = ModelParams(sh_degree=2, init_capacity=a.init_capacity)
        train = dict(save_iterations=(it,),
                     test_iterations=tuple(range(1000, it + 1, 1000)),
                     checkpoint_iterations=tuple(range(1000, it, 1000)),
                     log_every=a.log_every, quiet=False)
    elif a.cmd == "ref30k":
        scene = dict(n_views=a.views, width=a.width, height=a.height,
                     n_gt=a.gt, n_seed=a.seed_pts, eval_every=8)
        opt = dict(iterations=it, position_lr_max_steps=it)
        pipe = PipelineParams(instance_cap=a.cap, staircase_cull=True,
                              debug=a.debug == 1)
        mp = ModelParams(sh_degree=2)
        train = dict(
            save_iterations=tuple(x for x in (15000, it) if x <= it),
            test_iterations=tuple(
                x for x in (1000, 2500, 5000, 10000, 15000, 20000, 25000, it)
                if x <= it),
            checkpoint_iterations=tuple(range(5000, it, 5000)),
            log_every=a.log_every, quiet=False)
    else:
        scene = dict(n_views=16, width=128, height=128, n_gt=4000,
                     n_seed=1200, eval_every=8)
        opt = dict(
            iterations=it, densify_from_iter=500, densification_interval=100,
            densify_until_iter=1500, opacity_reset_interval=3000,
            single_view_weight_from_iter=700,
            multi_view_weight_from_iter=700,
            use_color_aggregation=True, start_color_aggregation_iter=1200,
            color_aggregate_burnin_steps=400, number_src_frames=4,
            nb_visible_src_frames=3, position_lr_max_steps=3000)
        pipe = PipelineParams(instance_cap=a.cap, debug=a.debug == 1)
        mp = ModelParams(sh_degree=2)
        train = dict(save_iterations=(it,),
                     test_iterations=(() if a.no_eval
                                      else (1000, 2000, 3000)),
                     checkpoint_iterations=(500, 1000, 1500, 2000, 2500),
                     log_every=a.log_every, quiet=True)
    return Plan(cmd=a.cmd, out=a.out, start_checkpoint=a.resume,
                scene=scene, mp=mp, opt=OptimizationParams(**opt), pipe=pipe,
                train=train, bundle=a.bundle,
                eval_cap=getattr(a, "eval_cap", 0), device=a.device)


def build_scene(pl: Plan):
    from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
    t0 = time.time()
    scene = make_synthetic_scene(**pl.scene, device=pl.device)
    print(f"scene built in {time.time() - t0:.0f}s "
          f"({scene.n_train} train views)", flush=True)
    return scene


@torch.no_grad()
def base_vs_aggregate(state, scene, opt, eval_cap, device):
    """Mean test PSNR of the render and of the fused image
    (`EvalRenderer.render_one` per test view)."""
    from ibgs_tpu_torch.eval.render_driver import EvalRenderer
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    from ibgs_tpu_torch.train import losses

    rcfg = RasterConfig(
        instance_cap=eval_cap, buffer_len=opt.buffer_length, max_src=5,
        depth_error_threshold=opt.depth_error_threshold, staircase_cull=True,
        row_cap=eval_cap // 2)
    ev = EvalRenderer.from_scene(state.model, state.net, scene, opt, rcfg,
                                 device)
    base, agg = [], []
    for k, cam in enumerate(scene.test_cameras):
        o = ev.render_one(cam, scene.test_nearest_ids[k])
        gt = torch.as_tensor(scene.test_images[k]).to(device)
        base.append(float(losses.psnr(torch.clamp(o["render"], 0, 1), gt)))
        agg.append(float(losses.psnr(
            torch.clamp(o.get("aggregate", o["render"]), 0, 1), gt)))
    return {"test_psnr_base": round(float(np.mean(base)), 3),
            "test_psnr_aggregate": round(float(np.mean(agg)), 3)}


def run(pl: Plan, scene=None):
    """Train `pl` (building its scene unless given), then the run's
    evaluations and bundle.  Returns (result, state, stacks, scene)."""
    from ibgs_tpu_torch.train.loop import train

    if scene is None:
        scene = build_scene(pl)
    cuda = torch.device(pl.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state, stacks = train(scene, pl.mp, pl.opt, pl.pipe, pl.out,
                          start_checkpoint=pl.start_checkpoint,
                          device=pl.device, **pl.train)
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    iters = pl.opt.iterations
    done = iters - (0 if pl.start_checkpoint is None else int(
        os.path.basename(pl.start_checkpoint)[6:-4]))

    def read(name):
        path = os.path.join(pl.out, name)
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(ln) for ln in f]

    log, events = read("train_log.jsonl"), read("events.jsonl")
    every = {"ref30k": 20}.get(pl.cmd, 12)
    res = {"metric": {"prod": "prod-scale training",
                      "ref30k": "30k reference-cadence training",
                      "validation": "128x128 training validation"}[pl.cmd],
           "resolution": [pl.scene["width"], pl.scene["height"]],
           "iterations": iters, "wall_s": round(wall, 1),
           "it_per_s": round(done / wall, 2),
           "points_final": log[-1]["points"],
           "first_train_psnr": round(log[0]["psnr"], 2),
           "final_train_psnr": round(log[-1]["psnr"], 2),
           "psnr_trajectory": [(m["iter"], round(m["psnr"], 2))
                               for m in log[:: max(len(log) // every, 1)]],
           "nonfinite_logged": sum(1 for m in log if m["nonfinite_grads"]),
           "evaluations": [[e["iter"], e["split"], round(e["psnr"], 2)]
                           for e in events if e["event"] == "eval"],
           "events": [e for e in events if e["event"] != "eval"],
           "densify": read("densify_log.jsonl")}
    if pl.eval_cap:
        res.update(base_vs_aggregate(state, scene, pl.opt, pl.eval_cap,
                                     pl.device))
        print("base-vs-aggregate:", json.dumps(
            {k: res[k] for k in ("test_psnr_base", "test_psnr_aggregate")}),
            flush=True)
    if pl.bundle:
        os.makedirs(os.path.dirname(os.path.abspath(pl.bundle)),
                    exist_ok=True)
        from ibgs_tpu_torch.scripts.make_bench_bundle import write_bundle
        write_bundle(pl.bundle, state.model, scene, stacks["depths"], 0,
                     pl.opt)
        res["bundle"] = pl.bundle
    if cuda:
        res.update(device=torch.cuda.get_device_name(),
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   max_memory_reserved=torch.cuda.max_memory_reserved())
    print(json.dumps(res), flush=True)
    return res, state, stacks, scene


def main(argv=None):
    run(plan(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
