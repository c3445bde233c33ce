"""Rank bodies of tests/test_torch_parallel.py.

Each function runs on every rank of a process group that
`ibgs_tpu_torch.parallel._spawn.run` opened (gloo, the CPU) and returns
what the test compares; inputs arrive as numpy arrays.  This module
imports neither jax nor the JAX package, so the spawned ranks never load
them.
"""
import copy
import dataclasses
import os

import numpy as np
import torch

from ibgs_tpu_torch import convert
from ibgs_tpu_torch.config import OptimizationParams
from ibgs_tpu_torch.core.camera import look_at_camera
from ibgs_tpu_torch.models import gaussians as tg
from ibgs_tpu_torch.ops.epilogue import SourceViews
from ibgs_tpu_torch.ops.rasterize import RasterConfig
from ibgs_tpu_torch.parallel import collectives as C
from ibgs_tpu_torch.parallel import distributed, gsp, sharding
from ibgs_tpu_torch.train import trainer

FIELDS = tg.PARAM_FIELDS


def camera(W, H):
    """tests/utils.simple_camera on the CPU."""
    return look_at_camera([0.0, 0.0, -3.0], [0.0, 0.0, 0.0],
                          [0.0, -1.0, 0.0], 0.8, 0.8, W, H, device="cpu")


def model_from(a: dict) -> tg.GaussianModel:
    """A port model from the arrays of a JAX model (tests/
    test_torch_parallel._arrays)."""
    def t(x):
        return torch.as_tensor(np.array(x))

    def tree(d):
        return tg.GaussianParams(**{k: t(d[k]) for k in FIELDS})

    return tg.GaussianModel(
        params=tree(a["params"]), alive=t(a["alive"]),
        active_sh_degree=int(a["active_sh_degree"]),
        max_sh_degree=int(a["max_sh_degree"]), mu=tree(a["mu"]),
        nu=tree(a["nu"]), step=int(a["step"]),
        **{k: t(a[k]) for k in tg.STAT_FIELDS})


def arrays(m: tg.GaussianModel) -> dict:
    """The numpy arrays of a port model (params, moments, alive, stats)."""
    out = {tree: {k: getattr(getattr(m, tree), k).detach().numpy()
                  for k in FIELDS} for tree in ("params", "mu", "nu")}
    out["alive"] = m.alive.numpy()
    for k in tg.STAT_FIELDS:
        out[k] = getattr(m, k).numpy()
    return out


def _sources(dp, S, H, W, eye=False):
    r2s = torch.eye(4).expand(dp, S, 4, 4).clone() if eye \
        else torch.zeros(dp, S, 4, 4)
    return SourceViews(images=torch.zeros(dp, S, H, W, 3),
                       depths=torch.zeros(dp, S, H, W), ref_to_src=r2s,
                       cam_pos=torch.zeros(dp, S, 3), count=[0] * dp)


def _gts(dp, H, W):
    g = torch.linspace(0, 1, H * W * 3).reshape(1, H, W, 3)
    return g.expand(dp, H, W, 3).contiguous()


def session4(a: dict) -> dict:
    """World 4: the row-band render (1 x 4) and steps (2 x 2), the
    Gaussian-sharded render (1 x 4) and step (2 x 2)."""
    out = {}
    H, W = 64, 32
    cam = camera(W, H)
    cfg = RasterConfig()
    mesh = sharding.make_mesh(1, 4, "cpu")
    out["sharded_render"] = sharding.sharded_render(
        model_from(a["render_model"]), [cam], cfg, torch.zeros(3), mesh)[0]

    mesh = sharding.make_mesh(2, 2, "cpu")
    model = model_from(a["train_model"])
    ca = sharding._cam_stack([cam, cam])
    srcs, gts = _sources(2, 2, H, W), _gts(2, H, W)
    m, loss = sharding.sharded_train_step(None, cfg, mesh, W, H)(
        model, ca, gts, srcs, 1)
    out["sharded_train"] = (float(loss), m.params.xyz.numpy())
    axes = ("dp", "tp")
    shard = dataclasses.replace(model, **{
        tree: tg.GaussianParams(**{
            k: sharding.shard_rows(getattr(getattr(model, tree), k), mesh,
                                   axes) for k in FIELDS})
        for tree in ("params", "mu", "nu")})
    m, loss = sharding.fsdp_train_step(None, cfg, mesh, W, H)(
        shard, ca, gts, srcs, 1)
    assert m.alive.shape == model.alive.shape
    out["fsdp_train"] = (float(loss),
                         C.all_gather(m.params.xyz, mesh, axes).numpy())

    gmesh = distributed.global_mesh(1, 4, ("dp", "gs"), "cpu")
    gcam = camera(32, 128)
    for stair in (False, True):
        img, ovf = gsp.gsp_render(
            model_from(a["gsp_model"]), gcam,
            RasterConfig(staircase_cull=stair, row_cap=1024), gmesh,
            cap_local=1024, exchange_cap=512,
            bg=torch.tensor([0.2, 0.3, 0.4]))
        out[f"gsp_render_stair{int(stair)}"] = (img.numpy(), int(ovf))

    gmesh = distributed.global_mesh(2, 2, ("dp", "gs"), "cpu")
    H, W = 128, 32
    step = gsp.gsp_train_step(cfg, gmesh, W, H, cap_local=2048,
                              exchange_cap=1024)
    ca = sharding._cam_stack([gcam, gcam])
    srcs, gts = _sources(2, 2, H, W, eye=True), _gts(2, H, W)
    m = gsp.shard_model(model_from(a["gsp_train_model"]), gmesh)
    m, l0, ovf = step(m, ca, gts, srcs, 1)
    full = gsp.gather_model(m, gmesh)
    losses = [float(l0)]
    for i in range(2, 6):
        m, loss, _ = step(m, ca, gts, srcs, i)
        losses.append(float(loss))
    out["gsp_train"] = dict(loss=losses, n_overflow=int(ovf),
                            xyz=full.params.xyz.numpy(),
                            normal=full.params.normal.numpy())
    return out if distributed.rank() == 0 else None


def full_step_inputs(a: dict):
    """The inputs of tests/test_gsp.py's full-objective test, in the port:
    a 60-splat model at 128x32, S = 3 sources whose cached depth is this
    view's own render (so the warp is valid), the fusion net of a Flax
    parameter tree."""
    H, W, S = 128, 32, 3
    opt = OptimizationParams(
        use_color_aggregation=True, number_src_frames=S,
        nb_visible_src_frames=2, single_view_weight_from_iter=0,
        multi_view_weight_from_iter=0, start_color_aggregation_iter=0,
        position_lr_max_steps=100)
    cam = camera(W, H)
    model = model_from(a["model"])
    net = convert.fusion_net_from_flax(a["net"], opt.feat_aggregate_mode,
                                       device="cpu")
    app = torch.zeros(trainer.APP_CAPACITY, 2)
    state = trainer.TrainState(
        model=model, app_ab=app, app_opt=trainer.SideOptState.init([app]),
        net=net, net_opt=trainer.SideOptState.init(list(net.parameters())),
        spatial_lr_scale=1.0)
    src = SourceViews(images=torch.as_tensor(a["src_images"]),
                      depths=torch.as_tensor(a["depth"])[None].repeat(S, 1, 1),
                      ref_to_src=torch.eye(4).repeat(S, 1, 1),
                      cam_pos=torch.as_tensor(a["src_cam_pos"]), count=S)
    return opt, cam, state, src, torch.as_tensor(a["gt"])


def _step_out(state, aux):
    return dict(aux={k: float(v) for k, v in aux.items()
                     if k not in ("median_depth", "radii")},
                median=aux["median_depth"].numpy(),
                model=arrays(state.model), app_ab=state.app_ab.numpy(),
                net={k: v.numpy().copy()
                     for k, v in state.net.state_dict().items()})


def full2(a: dict) -> dict:
    """World 2: the full objective under sharding (1 x 2) and on one
    rank."""
    out = {}
    mesh = distributed.global_mesh(1, 2, ("dp", "gs"), "cpu")
    opt, cam, state, src, gt = full_step_inputs(a)
    phase = trainer.StepPhase(render_geo=True, use_aggregation=True)
    args = (5, torch.zeros(3), True, 1.0, 1e-4)
    if distributed.rank() == 0:
        s1 = copy.deepcopy(state)
        single = trainer.make_train_step(opt, RasterConfig(), s1.net, phase)
        out["single"] = _step_out(*single(s1, cam, 0, gt, src, *args))
    s2 = copy.deepcopy(state)
    s2 = dataclasses.replace(s2, model=gsp.shard_model(s2.model, mesh))
    step = gsp.gsp_full_train_step(opt, RasterConfig(), s2.net, phase, mesh,
                                   cam.width, cam.height, cap_local=2048,
                                   exchange_cap=1024)
    s2, aux = step(s2, sharding._cam_stack([cam]), [0], gt[None],
                   sharding.stack_sources([src]), *args)
    s2 = dataclasses.replace(s2, model=gsp.gather_model(s2.model, mesh))
    aux["median_depth"] = aux["median_depth"][0]
    out["sharded"] = _step_out(s2, aux)
    return out if distributed.rank() == 0 else None


def session2(a: dict) -> dict:
    """World 2: the Gaussian-sharded render (1 x 2), also with the exact
    tile cull, the overflow count at a tiny exchange cap, ties in the
    merge, shard-local densify with given noise."""
    out = {}
    mesh = distributed.global_mesh(1, 2, ("dp", "gs"), "cpu")
    gcam = camera(32, 128)
    for stair in (False, True):
        img, ovf = gsp.gsp_render(
            model_from(a["gsp_model"]), gcam,
            RasterConfig(staircase_cull=stair, row_cap=1024), mesh,
            cap_local=1024, exchange_cap=512,
            bg=torch.tensor([0.2, 0.3, 0.4]))
        out[f"gsp_render_stair{int(stair)}"] = (img.numpy(), int(ovf))

    img, ovf = gsp.gsp_render(
        model_from(a["overflow_model"]), gcam,
        RasterConfig(tile_h=16, tile_w=16), mesh, cap_local=1024,
        exchange_cap=a["overflow_cap"])
    out["overflow"] = (img.numpy(), int(ovf))

    # the exact tile / ellipse cull without the staircase: retagged
    # instances never enter the exchange
    exact = RasterConfig(exact_tile_cull=True, row_cap=1024)
    img, ovf = gsp.gsp_render(model_from(a["gsp_model"]), gcam, exact, mesh,
                              cap_local=1024, exchange_cap=512,
                              bg=torch.tensor([0.2, 0.3, 0.4]))
    out["gsp_render_exact"] = (img.numpy(), int(ovf))
    img, ovf = gsp.gsp_render(
        model_from(a["overflow_model"]), gcam,
        dataclasses.replace(exact, tile_h=16, tile_w=16), mesh,
        cap_local=1024, exchange_cap=a["overflow_cap"])
    out["overflow_exact"] = (img.numpy(), int(ovf))

    img, ovf = gsp.gsp_render(model_from(a["tie_model"]), gcam,
                              RasterConfig(), mesh, cap_local=1024,
                              exchange_cap=512)
    out["ties"] = (img.numpy(), int(ovf))

    dens = gsp.gsp_densify_fn(mesh, tg.DensifyConfig(grad_threshold=1e-9,
                                                     percent_dense=10.0))
    k = C.axis_index(mesh, "gs")
    local = gsp.shard_model(model_from(a["densify_model"]), mesh)
    local = dens(local, None, 1.0,
                 noise=torch.as_tensor(a["densify_noise"][k]))
    out["densify"] = arrays(gsp.gather_model(local, mesh))

    x = (torch.arange(6.0).reshape(2, 3) + 10 * k).requires_grad_(True)
    w = torch.arange(12.0).reshape(4, 3) * (k + 1)
    y = C.all_gather(x, mesh, "gs")
    (g,) = torch.autograd.grad((y * w).sum(), [x])
    z = C.all_to_all(x, mesh, "gs")
    (gz,) = torch.autograd.grad((z * (k + 1.0)).sum(), [x])
    out["collectives"] = dict(
        all_gather=y.detach().numpy(), all_gather_grad=g.numpy(),
        psum=C.psum(x.detach(), mesh, "gs").numpy(),
        psum_scatter=C.psum_scatter(x.detach(), mesh, "gs").numpy(),
        all_to_all=z.detach().numpy(), all_to_all_grad=gz.numpy())
    return out if distributed.rank() == 0 else None


def session1(a: dict) -> dict:
    """World 1: the identity fast path against the generic exchange, the
    rendered image and the gradient of a loss of it."""
    mesh = distributed.global_mesh(1, 1, ("dp", "gs"), "cpu")
    cam = camera(32, 128)
    model = model_from(a["model"])
    out = {}
    for name, cap_local, cap_e in (("fast", 1024, 1024),
                                   ("generic", 1024, 512),
                                   ("exact", 0, 0), ("exact_generic", 0, 300)):
        render = gsp.make_gsp_render(cam.width, cam.height, RasterConfig(),
                                     mesh, cap_local, cap_e)
        leaves = tg.GaussianParams(**{
            k: getattr(model.params, k).detach().requires_grad_(True)
            for k in FIELDS})
        img, ovf = render(dataclasses.replace(model, params=leaves), cam)
        loss = (img * torch.arange(3.0)[None, None]).sum()
        grads = torch.autograd.grad(loss, [getattr(leaves, k)
                                           for k in FIELDS], allow_unused=True)
        out[name] = dict(img=img.detach().numpy(), ovf=int(ovf), grads=[
            None if g is None else g.numpy() for g in grads])
    return out


def loop2(a: dict) -> dict:
    """World 2: the training driver on a 1 x 2 mesh through a densify
    event, with a checkpoint; then a resume from it."""
    from ibgs_tpu_torch.config import ModelParams, PipelineParams
    from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
    from ibgs_tpu_torch.train import checkpoint as ckpt
    from ibgs_tpu_torch.train.loop import train

    mesh = distributed.global_mesh(1, 2, ("dp", "gs"), "cpu")
    scene = make_synthetic_scene(**a["scene"], device="cpu")
    opt = OptimizationParams(**a["opt"])
    path = a["model_path"]
    it = opt.iterations
    state, _ = train(
        scene, ModelParams(sh_degree=1), opt, PipelineParams(), path,
        save_iterations=(it,), test_iterations=(it,),
        checkpoint_iterations=(it,), log_every=1, quiet=True, device="cpu",
        mesh=mesh)
    full = gsp.gather_model(state.model, mesh)
    out = dict(model=arrays(full), step=full.step)
    if distributed.rank() == 0:
        out["checkpoint"] = ckpt.state_arrays(
            ckpt.load_state(state, os.path.join(path, f"chkpnt{it}.npz"))[0])
    opt2 = dataclasses.replace(opt, iterations=it + 2)
    state2, _ = train(
        scene, ModelParams(sh_degree=1), opt2, PipelineParams(),
        os.path.join(path, "resumed"), save_iterations=(),
        test_iterations=(), log_every=1, quiet=True, device="cpu",
        start_checkpoint=os.path.join(path, f"chkpnt{it}.npz"), mesh=mesh)
    out["resumed_step"] = state2.model.step
    return out
