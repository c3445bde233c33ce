"""The training driver (counterpart of ibgs_tpu/train/loop.py).

From a scene's seed cloud to a trained model: KNN-scaled initialisation,
the step schedule (colour-only steps, then geometry rendering with the
warp, then colour aggregation), densify / prune with capacity growth,
opacity reset and decay, the per-view depth cache that feeds the warp,
evaluation, PLY snapshots, checkpoints and resume, and the live SIBR
viewer (`viewer_port`: one pending viewer message served per iteration).

The host holds only schedule state (Python ints and numpy): the camera
order and background come from `np.random.default_rng(seed)` with the JAX
package's calls, so both packages visit the same cameras in the same
order; densify noise comes from a `torch.Generator` on the device seeded
with `seed`.  Device values are read at a densify event (the alive
count), at a log line (the losses and `nonfinite_grads`) and, in debug
mode, after every step.  Each step's instance and row counts are host
ints already (binning sizes its lists exactly).

With `mesh` (a ("dp", "gs") DeviceMesh of parallel/distributed, one
process per rank) the same driver trains Gaussian-sharded: each rank holds
its shard of the model (after a one-time `gsp_interleave`), a step is
`gsp_full_train_step` on dp cameras drawn identically on every rank, each
dp camera's median depth goes into the depth cache, densification runs
shard-local (`gsp_densify_fn`, a generator per shard), a capacity growth
re-interleaves, and evaluation, PLY snapshots and checkpoints use the
gathered model; rank 0 writes the files and the log.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ibgs_tpu_torch.config import (ModelParams, OptimizationParams,
                                   PipelineParams)
from ibgs_tpu_torch.data.dataset import SceneData, write_multiview_json
from ibgs_tpu_torch.models.aggregation import (ColorFusionResidualNet,
                                               init_fusion_net)
from ibgs_tpu_torch.models.gaussians import (DensifyConfig, decay_opacity,
                                             init_from_points,
                                             oneup_sh_degree, reset_opacity)
from ibgs_tpu_torch.ops.rasterize import RasterConfig
from ibgs_tpu_torch.parallel import collectives, distributed, gsp, sharding
from ibgs_tpu_torch.renderer import (render_depth_view, render_view,
                                     source_views_from_stacks)
from ibgs_tpu_torch.train import checkpoint as ckpt
from ibgs_tpu_torch.train import losses
from ibgs_tpu_torch.train.logging import TrainLogger, colorize_depth
from ibgs_tpu_torch.train.trainer import (APP_CAPACITY, SideOptState,
                                          StepPhase, TrainState,
                                          densify_step, make_train_step,
                                          maybe_grow)
from ibgs_tpu_torch.utils import profiling

LOSS_KEYS = ("image_loss", "normal_loss", "photo_loss", "agg_loss", "psnr")


def _grown_cap(n: int) -> int:
    return 1 << int(np.ceil(np.log2(n * 1.25)))


def train(
    scene: SceneData,
    mp: ModelParams,
    opt: OptimizationParams,
    pipe: PipelineParams,
    model_path: str,
    save_iterations=(30_000,),
    test_iterations=(7_000, 15_000, 30_000),
    checkpoint_iterations=(),
    start_checkpoint: Optional[str] = None,
    quiet: bool = False,
    seed: int = 24,
    log_every: int = 200,
    viewer_port: Optional[int] = None,
    device="cuda",
    mesh=None,
    gsp_cap_local: Optional[int] = None,
    gsp_exchange_cap: Optional[int] = None,
):
    """Train `scene` into `model_path`; returns (state, stacks), stacks
    holding the train images, the depth cache, the world → view matrices
    and the camera centres.  Writes train_log.jsonl (one record per logged
    iteration), densify_log.jsonl (one per densify event: its ms, the
    alive count before and after, the capacity), events.jsonl (one per
    growth of the instance cap, the row cap or the capacity, and one per
    evaluated split with its PSNR), multi_view.json, the
    PLY snapshots of `save_iterations` and the checkpoints of
    `checkpoint_iterations`.  Under `mesh` the exchange's caps default as
    in the JAX package when `pipe.instance_cap` is set, else to 0 (no cap);
    the returned state holds this rank's shard."""
    dev = torch.device(device)
    main = mesh is None or distributed.rank() == 0
    os.makedirs(model_path, exist_ok=True)
    if main:
        write_multiview_json(scene, model_path)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    H, W = scene.images.shape[1:3]
    n_train = scene.n_train
    rcfg = RasterConfig(
        instance_cap=pipe.instance_cap, buffer_len=opt.buffer_length,
        max_src=5, depth_error_threshold=opt.depth_error_threshold,
        staircase_cull=pipe.staircase_cull, row_cap=pipe.row_cap)

    model = init_from_points(scene.points, scene.colors, mp.sh_degree,
                             capacity=mp.init_capacity or None, device=dev)
    net = net_opt = None
    if opt.use_color_aggregation:
        net = init_fusion_net(
            ColorFusionResidualNet(32, opt.feat_aggregate_mode),
            torch.Generator().manual_seed(0)).to(dev)
        net_opt = SideOptState.init(list(net.parameters()))
    app_ab = torch.zeros(APP_CAPACITY, 2, device=dev)
    state = TrainState(model=model, app_ab=app_ab,
                       app_opt=SideOptState.init([app_ab]), net=net,
                       net_opt=net_opt,
                       spatial_lr_scale=float(scene.cameras_extent))

    w2v, centers, _rays = scene.poses_stack()
    stacks = {
        "images": torch.as_tensor(scene.images).to(dev),
        "depths": torch.zeros(n_train, H, W, device=dev),
        "w2v": w2v.to(dev),
        "centers": centers.to(dev),
    }

    first_iter = 1
    if start_checkpoint:
        state, first_iter = ckpt.load_state(state, start_checkpoint)
        first_iter += 1

    n_dp, n_gs = 1, 0
    if mesh is not None:
        n_dp, n_gs = (collectives.axis_size(mesh, a)
                      for a in mesh.mesh_dim_names)
        if H % (n_gs * rcfg.tile_h):
            raise ValueError(f"height {H} does not split into {n_gs} bands "
                             f"of whole {rcfg.tile_h}-row tiles")
        if gsp_cap_local is None:
            gsp_cap_local = (max(-(-pipe.instance_cap // n_gs) * 2, 4096)
                             if pipe.instance_cap else 0)
        if gsp_exchange_cap is None:
            gsp_exchange_cap = (max(-(-gsp_cap_local // n_gs) * 2, 2048)
                                if gsp_cap_local else 0)
        # spread alive rows and free slots over the shards; keep this
        # rank's
        state = dataclasses.replace(state, model=gsp.shard_model(
            gsp.gsp_interleave(state.model, n_gs), mesh))
        gen = gsp.shard_generator(seed, mesh, dev)
    dens_fns = {}

    def full_model():
        """The whole model (gathered over the shards under a mesh: every
        rank calls it)."""
        if mesh is None:
            return state.model
        return gsp.gather_model(state.model, mesh)

    def n_alive() -> int:
        if mesh is None:
            return int(state.model.alive.sum())
        return int(collectives.psum(state.model.alive.sum().reshape(1),
                                    mesh, "gs")[0])

    dcfg = DensifyConfig(
        grad_threshold=opt.densify_grad_threshold,
        abs_grad_threshold=opt.densify_abs_grad_threshold,
        opacity_cull=opt.opacity_cull_threshold,
        percent_dense=opt.percent_dense,
        abs_split_radii2d_threshold=opt.abs_split_radii2D_threshold,
        max_abs_split=opt.max_abs_split_points)
    extent = float(scene.cameras_extent)
    bg_fixed = (torch.ones(3, device=dev) if scene.white_background
                else torch.zeros(3, device=dev))
    geo_from = opt.single_view_weight_from_iter - 2 * n_train
    steps = {}

    def get_step(it):
        phase = StepPhase(
            render_geo=it > geo_from,
            use_aggregation=bool(opt.use_color_aggregation
                                 and it > opt.start_color_aggregation_iter))
        if phase not in steps:
            steps[phase] = (make_train_step(opt, rcfg, state.net, phase)
                            if mesh is None else gsp.gsp_full_train_step(
                                opt, rcfg, state.net, phase, mesh, W, H,
                                gsp_cap_local, gsp_exchange_cap))
        return steps[phase], phase

    logger = TrainLogger(model_path) if main else None

    def log_event(it, event, **fields):
        if main:
            with open(os.path.join(model_path, "events.jsonl"), "a") as f:
                f.write(json.dumps(dict(iter=it, event=event, **fields))
                        + "\n")

    def gather_src(idx, count, cam):
        return source_views_from_stacks(
            stacks["images"], stacks["depths"], stacks["w2v"],
            stacks["centers"], torch.as_tensor(idx).to(dev), count, cam)

    @torch.no_grad()
    def eval_render(model, cam, src):
        res, _ = render_view(model, cam, rcfg, bg_fixed, src=src,
                             learnt_normal=opt.learnt_normal,
                             render_geo=True, return_depth_normal=False)
        return res.render, res.median_depth, res.normal

    def run_eval(it, model):
        """PSNR of `model` over the test split and a sample of 5 train
        views."""
        sample = [i % n_train for i in range(5, 30, 5)]
        configs = [("test", scene.test_cameras, scene.test_images,
                    scene.test_nearest_ids),
                   ("train", [scene.train_cameras[i] for i in sample],
                    scene.images[sample],
                    [scene.nearest_ids[i] for i in sample])]
        for name, cams_e, gts_e, nbrs_e in configs:
            if not cams_e:
                continue
            tot = 0.0
            for k, cam_e in enumerate(cams_e):
                nb = nbrs_e[k][: opt.number_src_frames]
                idx2 = np.zeros((rcfg.max_src,), np.int64)
                idx2[: len(nb)] = nb
                img, dep, nrm = eval_render(model, cam_e,
                                            gather_src(idx2, len(nb), cam_e))
                gt_e = torch.as_tensor(gts_e[k]).to(dev)
                tot += float(losses.psnr(torch.clamp(img, 0, 1), gt_e))
                if k < 3:
                    logger.image(it, f"{name}_view_{k}/render", img)
                    logger.image(it, f"{name}_view_{k}/depth",
                                 colorize_depth(dep))
                    logger.image(it, f"{name}_view_{k}/normal",
                                 (nrm.cpu().numpy() + 1) / 2)
            mean_psnr = tot / len(cams_e)
            print(f"\n[ITER {it}] Evaluating {name}: PSNR {mean_psnr:.2f}")
            log_event(it, "eval", split=name, psnr=mean_psnr)
            logger.scalars(it, {f"{name}/psnr": mean_psnr})
        alive = model.alive.cpu().numpy()
        logger.histogram(it, "scene/opacity_histogram",
                         model.opacity.cpu().numpy()[alive])
        logger.scalars(it, {"total_points": int(alive.sum())})

    # on resume past the geometry threshold, rebuild the per-view depth
    # cache with a no-grad depth sweep
    if start_checkpoint and first_iter > geo_from:
        model = full_model()
        with torch.no_grad():
            for ci, cam_i in enumerate(scene.train_cameras):
                stacks["depths"][ci] = render_depth_view(
                    model, cam_i, rcfg, learnt_normal=opt.learnt_normal)
        if main:
            print(f"[resume] depth cache rebuilt for {n_train} views")

    def check_caps(n_inst, n_rows, it):
        """Grow a cap the user set when a step's counts pass it: binning
        drops the deepest splats past a cap, so a late reaction silently
        degrades training.  Caps of 0 (exact-size lists) never grow."""
        nonlocal rcfg
        grew = False
        if rcfg.instance_cap and n_inst > rcfg.instance_cap:
            newcap = _grown_cap(n_inst)
            print(f"[it {it}] WARNING: tile instances {n_inst} exceed "
                  f"instance_cap {rcfg.instance_cap} (deepest splats "
                  f"dropped); growing cap -> {newcap}")
            log_event(it, "instance_cap", count=n_inst,
                      old=rcfg.instance_cap, new=newcap)
            rcfg = dataclasses.replace(rcfg, instance_cap=newcap)
            grew = True
        row_eff = rcfg.row_cap or rcfg.instance_cap // 2
        if rcfg.staircase_cull and row_eff and n_rows > row_eff:
            newrows = _grown_cap(n_rows)
            print(f"[it {it}] WARNING: staircase rows {n_rows} exceed "
                  f"row_cap {row_eff}; growing -> {newrows}")
            log_event(it, "row_cap", count=n_rows, old=row_eff, new=newrows)
            rcfg = dataclasses.replace(rcfg, row_cap=newrows)
            grew = True
        if grew:
            steps.clear()

    def grow(it, tag=""):
        nonlocal state
        full = full_model()
        model, newcap = maybe_grow(full, opt.max_all_points)
        if newcap is not None:
            log_event(it, "capacity", old=full.capacity, new=newcap,
                      pre_densify=bool(tag))
            if mesh is not None:
                # the new free slots pad the end: deal them out again
                model = gsp.shard_model(gsp.gsp_interleave(model, n_gs), mesh)
            state = dataclasses.replace(state, model=model)
            if main:
                print(f"[it {it}] capacity -> {newcap}{tag}", flush=True)

    if viewer_port is not None:
        from ibgs_tpu_torch.eval import viewer as _viewer
        if main:                 # rank 0 serves; every rank gathers
            _viewer.init(port=viewer_port)

        def viewer_render(model, cam):
            # a plain Gaussian render at the viewer's resolution: sources
            # off (count 0, so no warp input is read)
            src = gather_src(np.zeros(rcfg.max_src, np.int64), 0, cam)
            return eval_render(model, cam, src)[0]

    stack_order = []
    net_lr = 1e-3
    t_start = time.time()
    profile_dir = pipe.profile_dir or os.path.join(model_path, "trace")
    if mesh is not None:
        profile_dir = os.path.join(profile_dir, f"rank{distributed.rank()}")
    profiler = contextlib.ExitStack()
    profiling_now = False

    for it in range(first_iter, opt.iterations + 1):
        if pipe.profile_num_steps:
            if it == pipe.profile_from_iter:
                profiler.enter_context(profiling.trace(profile_dir))
                profiling_now = True
            elif profiling_now and it == (pipe.profile_from_iter
                                          + pipe.profile_num_steps):
                profiler.close()
                profiling_now = False
                print(f"[it {it}] profiler trace written to {profile_dir}")
        if viewer_port is not None:
            model = full_model()
            if main:
                _viewer.serve_once(
                    lambda cam, msg: viewer_render(model, cam), device=dev)
        if it == opt.single_view_weight_from_iter:
            # seed the learnt normals from the smallest covariance axis
            m = state.model
            state = dataclasses.replace(state, model=dataclasses.replace(
                m, params=dataclasses.replace(
                    m.params, normal=m.smallest_axis().detach())))
        if (opt.use_color_aggregation
                and it in opt.color_aggregation_reduce_lr_iter):
            net_lr *= 0.5
        if it % 1000 == 0:
            state = dataclasses.replace(state,
                                        model=oneup_sh_degree(state.model))
        # dp cameras per step (1 without a mesh), drawn identically on
        # every rank
        cam_idxs = []
        for _ in range(n_dp):
            if not stack_order:
                stack_order = list(range(n_train))
            cam_idxs.append(int(stack_order.pop(
                rng.integers(len(stack_order)))))
        cam_idx = cam_idxs[0]
        cam = scene.train_cameras[cam_idx]
        gt = stacks["images"][cam_idx]
        step_fn, phase = get_step(it)

        def build_src(ci):
            pool = scene.nearest_ids[ci]
            if (opt.shuffle_source_frame
                    and len(pool) > opt.number_src_frames):
                nbrs = list(rng.choice(pool, size=opt.number_src_frames,
                                       replace=False))
            else:
                nbrs = pool[: opt.number_src_frames]
            sidx = np.zeros((rcfg.max_src,), np.int64)
            sidx[: len(nbrs)] = nbrs
            return sidx, gather_src(sidx, len(nbrs), scene.train_cameras[ci])

        src_packs = [build_src(ci) for ci in cam_idxs]
        idx, src = src_packs[0]

        bg = (torch.as_tensor(rng.random(3), dtype=torch.float32).to(dev)
              if opt.random_background else bg_fixed)
        use_app = bool(opt.exposure_compensation and it > 1000)
        burn = np.clip((it - opt.start_color_aggregation_iter)
                       / max(opt.color_aggregate_burnin_steps, 1), 0.0, 1.0)
        burned_in = float(np.float32((burn + 1.0) / 2.0))

        prev_state = state     # kept one step for the debug dump below
        with profiling.step_annotation("train_step", it, dev):
            if mesh is None:
                state, aux = step_fn(state, cam, cam_idx, gt, src, it, bg,
                                     use_app, burned_in, net_lr)
            else:
                state, aux = step_fn(
                    state, sharding._cam_stack(
                        [scene.train_cameras[ci] for ci in cam_idxs]),
                    cam_idxs, stacks["images"][cam_idxs],
                    sharding.stack_sources([s for _, s in src_packs]), it,
                    bg, use_app, burned_in, net_lr)

        # debug mode: a per-step check of the losses and gradients; the
        # first non-finite step dumps its inputs to snapshot_fw.npz (the
        # depth half of the source pack is the evolving cache, which
        # cannot be rebuilt offline) and raises
        if pipe.debug and (
                int(aux["nonfinite_grads"]) > 0
                or not all(np.isfinite(float(aux[k])) for k in LOSS_KEYS[:4])):
            snap = os.path.join(model_path, "snapshot_fw.npz")
            prev = (prev_state.model if mesh is None
                    else gsp.gather_model(prev_state.model, mesh))
            p = prev.params
            np.savez(snap, iter=it, cam_idx=cam_idx, src_idx=idx,
                     alive=prev.alive.cpu().numpy(),
                     gt=gt.cpu().numpy(), bg=bg.cpu().numpy(),
                     src_images=src.images.cpu().numpy(),
                     src_depths=src.depths.cpu().numpy(),
                     src_ref_to_src=src.ref_to_src.cpu().numpy(),
                     src_cam_pos=src.cam_pos.cpu().numpy(),
                     src_count=src.count, burned_in=burned_in,
                     use_app=use_app,
                     nonfinite_grads=int(aux["nonfinite_grads"]),
                     **{k: getattr(p, k).detach().cpu().numpy()
                        for k in ("xyz", "log_scale", "quat",
                                  "opacity_logit", "normal", "offset",
                                  "sh_dc", "sh_rest")})
            raise FloatingPointError(
                f"[it {it}] non-finite step (nonfinite_grads="
                f"{int(aux['nonfinite_grads'])}); inputs dumped to {snap}")

        if phase.render_geo:
            if mesh is None:
                stacks["depths"][cam_idx] = aux["median_depth"]
            else:
                for j, ci in enumerate(cam_idxs):
                    stacks["depths"][ci] = aux["median_depth"][j]

        check_caps(aux["n_instances"], aux.get("n_rows", 0), it)

        # maintenance cadence
        if it < opt.densify_until_iter:
            if (it > opt.densify_from_iter
                    and it % opt.densification_interval == 0):
                max_screen = (20.0 if it > opt.opacity_reset_interval
                              else None)
                # grow before the densify when occupancy is already near
                # capacity, so that clone / split are not slot-starved
                grow(it, " (pre-densify)")
                t0 = time.perf_counter()
                n_before = n_alive()
                if mesh is None:
                    model = densify_step(state.model, gen, dcfg, extent,
                                         max_screen=max_screen)
                else:
                    if max_screen not in dens_fns:
                        dens_fns[max_screen] = gsp.gsp_densify_fn(
                            mesh, dcfg, max_screen=max_screen)
                    model = dens_fns[max_screen](state.model, gen, extent)
                state = dataclasses.replace(state, model=model)
                n_after = n_alive()
                ms = (time.perf_counter() - t0) * 1e3
                grow(it)
                rec = dict(iter=it, ms=ms, n_alive_before=n_before,
                           n_alive_after=n_after,
                           capacity=state.model.capacity * max(n_gs, 1))
                if mesh is not None:
                    rec["gsp_shards"] = n_gs
                if main:
                    with open(os.path.join(model_path, "densify_log.jsonl"),
                              "a") as f:
                        f.write(json.dumps(rec) + "\n")
            if it % opt.opacity_reset_interval == 0 or (
                    scene.white_background and it == opt.densify_from_iter):
                state = dataclasses.replace(
                    state, model=reset_opacity(state.model))
            if (0 < opt.opacity_decay < 1
                    and it % opt.opacity_decay_interval == 0
                    and it > opt.densify_from_iter):
                state = dataclasses.replace(state, model=decay_opacity(
                    state.model, opt.opacity_decay))

        if it % log_every == 0 or it == first_iter:
            m = {k: float(aux[k]) for k in LOSS_KEYS}
            m.update(iter=it, points=n_alive(),
                     n_instances=aux["n_instances"],
                     nonfinite_grads=int(aux["nonfinite_grads"]),
                     elapsed=time.time() - t_start)
            if mesh is not None and int(aux["n_overflow"]) > 0:
                m["n_overflow"] = int(aux["n_overflow"])
                if main:
                    print(f"[it {it}] WARNING: GSP exchange dropped "
                          f"{m['n_overflow']} instances (raise "
                          f"gsp_exchange_cap)")
            if main:
                if not quiet:
                    print(f"[it {it}] loss {m['image_loss']:.4f} "
                          f"psnr {m['psnr']:.2f} pts {m['points']} "
                          f"inst {m['n_instances']} t {m['elapsed']:.0f}s",
                          flush=True)
                with open(os.path.join(model_path, "train_log.jsonl"),
                          "a") as f:
                    f.write(json.dumps(m) + "\n")
                logger.scalars(it, {
                    "train_loss_patches/l1_loss": float(aux["l1"]),
                    "train_loss_patches/total_loss": m["image_loss"],
                    "train/psnr": m["psnr"],
                })

        if (it in test_iterations or it in save_iterations
                or it in checkpoint_iterations):
            model = full_model()
            if main and it in test_iterations:
                run_eval(it, model)
            if main and it in save_iterations:
                pc_dir = os.path.join(model_path, "point_cloud",
                                      f"iteration_{it}")
                os.makedirs(pc_dir, exist_ok=True)
                ckpt.save_ply_snapshot(
                    model, os.path.join(pc_dir, "point_cloud.ply"))
            if main and it in checkpoint_iterations:
                ckpt.save_state(dataclasses.replace(state, model=model), it,
                                os.path.join(model_path, f"chkpnt{it}.npz"))

    profiler.close()
    if main:
        logger.close()
        if viewer_port is not None:
            _viewer.shutdown()
    return state, stacks
