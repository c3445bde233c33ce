"""Training step and maintenance (counterpart of
ibgs_tpu/train/trainer.py).

One step: render with the image-based warp → the full IBGS objective →
backward through every hand-written VJP (blend, pack_rows, warp) → per-group
Adam on the Gaussians, Adam on the exposure table and the fusion net →
densification statistics.  The phase flags that change the computation
(geometry rendering on, aggregation on) select the step variant, as in
the JAX package.  `densify_step` and `maybe_grow` are the maintenance the
training loop (train/loop.py) runs between steps.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ibgs_tpu_torch import renderer
from ibgs_tpu_torch.config import OptimizationParams
from ibgs_tpu_torch.core.camera import Camera
from ibgs_tpu_torch.models import aggregation
from ibgs_tpu_torch.models import gaussians
from ibgs_tpu_torch.models.gaussians import (PARAM_FIELDS, GaussianModel,
                                             GaussianParams, LRConfig,
                                             accumulate_stats, adam_step,
                                             bias_corrections, lr_tree)
from ibgs_tpu_torch.ops import optim
from ibgs_tpu_torch.ops.epilogue import SourceViews
from ibgs_tpu_torch.ops.rasterize import RasterConfig
from ibgs_tpu_torch.train import losses
from ibgs_tpu_torch.utils import profiling

APP_CAPACITY = 1600     # fixed image capacity of the exposure table


@dataclasses.dataclass
class SideOptState:
    """Adam state of a side parameter list (exposure table, fusion net)."""
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    step: int = 0

    @classmethod
    def init(cls, params) -> "SideOptState":
        return cls(mu=[torch.zeros_like(p) for p in params],
                   nu=[torch.zeros_like(p) for p in params])


@torch.no_grad()
def side_adam(params, opt: SideOptState, grads, lr, b1=0.9, b2=0.999,
              eps=1e-8, into: Optional[optim.OptimPass] = None,
              in_place: bool = False):
    """Adam on a list of tensors.  Returns (new params, new state); the
    inputs are left as they are, but for `in_place`, where the new values
    are written into `params` (and returned).  The updates are segments of
    `into` (an optim.OptimPass; its `run` computes them on CUDA tensors),
    else of a pass of their own, run here."""
    op = (optim.OptimPass(params[0].device if params else "cpu")
          if into is None else into)
    step = opt.step + 1
    bc = bias_corrections(step, b1, b2)
    out = [op.adam(p, m, v, g, lr, bc, b1, b2, eps, in_place=in_place)
           for p, m, v, g in zip(params, opt.mu, opt.nu, grads)]
    if into is None:
        op.run()
    return [o[0] for o in out], SideOptState(
        mu=[o[1] for o in out], nu=[o[2] for o in out], step=step)


@dataclasses.dataclass
class TrainState:
    model: GaussianModel
    app_ab: torch.Tensor                 # (APP_CAPACITY, 2)
    app_opt: SideOptState
    net: Optional[aggregation.ColorFusionResidualNet]
    net_opt: Optional[SideOptState]      # moments in net.parameters() order
    spatial_lr_scale: float              # scene extent


@dataclasses.dataclass(frozen=True)
class StepPhase:
    """Flags selecting the step variant."""
    render_geo: bool
    use_aggregation: bool


def make_lr_config(opt: OptimizationParams) -> LRConfig:
    return LRConfig(
        position_lr_init=opt.position_lr_init,
        position_lr_final=opt.position_lr_final,
        position_lr_delay_mult=opt.position_lr_delay_mult,
        position_lr_max_steps=opt.position_lr_max_steps,
        feature_lr=opt.feature_lr, opacity_lr=opt.opacity_lr,
        scaling_lr=opt.scaling_lr, rotation_lr=opt.rotation_lr,
        normal_lr=opt.normal_lr)


def ibgs_objective(opt: OptimizationParams, phase: StepPhase, net,
                   app_ab, cam_uid: int, image, rendered_normal, dnormal,
                   ibr, gt, iteration: int, use_app: bool,
                   burned_in: float):
    """The full IBGS training objective: L1+DSSIM image loss with the
    exposure switch, single-view normal consistency, multi-view
    photometric, and the colour-aggregation loss with its burn-in gating.
    Image inputs are full-frame (H, W, ...); `ibr` is an IBROutputs (or
    None when phase.render_geo is False).  Returns (total, aux scalars)."""
    with profiling.annotate("objective"):
        dev = image.device
        ssim_loss = 1.0 - losses.ssim(image, gt)
        app_image = renderer.apply_exposure(image, app_ab, cam_uid)
        l1_plain = losses.l1(image, gt)
        l1_app = losses.l1(app_image, gt)
        Ll1 = torch.where(torch.tensor(bool(use_app), device=dev)
                          & (ssim_loss < 0.5), l1_app, l1_plain)
        image_loss = (1.0 - opt.lambda_dssim) * Ll1 + \
            opt.lambda_dssim * ssim_loss

        zero = torch.zeros((), dtype=torch.float32, device=dev)
        normal_loss = photo_loss = agg_loss = zero
        use_agg_now = torch.zeros((), dtype=torch.bool, device=dev)
        if phase.render_geo:
            gate_n = float(iteration > opt.single_view_weight_from_iter)
            normal_loss = gate_n * losses.normal_consistency(
                rendered_normal, dnormal, opt.single_view_weight)

            gate_p = float(iteration > opt.multi_view_weight_from_iter)
            warped = ibr.warped_image[:opt.nb_visible_src_frames]
            feat = ibr.cam_feat[:opt.nb_visible_src_frames]
            valid = feat.sum(-1) > 0.0
            photo_loss = gate_p * losses.multi_view_photometric(
                gt, warped, valid, opt.photo_ssim_weight, opt.photo_weight)

            if phase.use_aggregation:
                fusion = aggregation.fuse_color(
                    net, image, ibr.warped_image, ibr.cam_feat, ibr.camera_ray,
                    ibr.min_depth_diff, ibr.use_first_src_mask, burned_in,
                    opt.nb_visible_src_frames, opt.enable_exposure_correction,
                    opt.residual_resolution_scale, opt.enable_mix_precision)
                pred = fusion["image_pred"]
                agg_ssim = 1.0 - losses.ssim(pred, gt)
                agg_l1 = losses.l1(pred, gt)
                agg_loss = (1.0 - opt.lambda_dssim) * agg_l1 + \
                    opt.lambda_dssim * agg_ssim
                use_agg_now = fusion["any_valid"]

        total = normal_loss + photo_loss + torch.where(
            use_agg_now, 0.5 * (image_loss + agg_loss), image_loss)
        aux = dict(image_loss=image_loss, normal_loss=normal_loss,
                   photo_loss=photo_loss, agg_loss=agg_loss, l1=Ll1,
                   psnr=losses.psnr(torch.clamp(image, 0, 1), gt))
        return total, aux


@dataclasses.dataclass
class Grads:
    """Gradients of one step's loss."""
    params: GaussianParams
    app_ab: torch.Tensor
    net: List[torch.Tensor]        # in net.parameters() order
    screen: torch.Tensor           # (P, 2) w.r.t. screen_dummy
    screen_abs: torch.Tensor       # (P, 2) w.r.t. screen_dummy_abs

    def tensors(self) -> list:
        return [*(getattr(self.params, k) for k in PARAM_FIELDS),
                self.app_ab, *self.net, self.screen, self.screen_abs]


def loss_and_grads(opt: OptimizationParams, rcfg: RasterConfig, net,
                   phase: StepPhase, state: TrainState, cam: Camera,
                   cam_uid: int, gt: torch.Tensor,
                   src: Optional[SourceViews], iteration: int,
                   bg: torch.Tensor, use_app: bool, burned_in: float):
    """The step's loss, its aux scalars (plus radii, median depth and the
    instance / row counts) and the gradients of the Gaussian parameters,
    the exposure table, the net and both screen dummies."""
    model = state.model
    P = model.capacity
    dev = model.alive.device
    leaves = GaussianParams(**{
        k: getattr(model.params, k).detach().requires_grad_(True)
        for k in PARAM_FIELDS})
    app_ab = state.app_ab.detach().requires_grad_(True)
    sdum = torch.zeros(P, 2, device=dev, requires_grad=True)
    sdum_abs = torch.zeros(P, 2, device=dev, requires_grad=True)
    net_params = list(net.parameters()) if net is not None else []

    res, dnormal = renderer.render_view(
        dataclasses.replace(model, params=leaves), cam, rcfg, bg, src=src,
        learnt_normal=opt.learnt_normal, render_geo=phase.render_geo,
        return_depth_normal=phase.render_geo, screen_dummy=sdum,
        screen_dummy_abs=sdum_abs)
    total, aux = ibgs_objective(
        opt, phase, net, app_ab, cam_uid, res.render, res.normal, dnormal,
        res.ibr, gt, iteration, use_app, burned_in)
    inputs = [*(getattr(leaves, k) for k in PARAM_FIELDS), app_ab,
              *net_params, sdum, sdum_abs]
    with profiling.annotate("backward"):
        g = torch.autograd.grad(total, inputs, allow_unused=True)
        g = [torch.zeros_like(x) if gx is None else gx
             for x, gx in zip(inputs, g)]
    nf = len(PARAM_FIELDS)
    grads = Grads(params=GaussianParams(**dict(zip(PARAM_FIELDS, g[:nf]))),
                  app_ab=g[nf], net=g[nf + 1:-2], screen=g[-2],
                  screen_abs=g[-1])
    aux.update(radii=res.radii, median_depth=res.median_depth.detach(),
               n_instances=res.n_instances, n_rows=res.n_rows)
    aux = {k: v.detach() if torch.is_tensor(v) else v
           for k, v in aux.items()}
    return total.detach(), aux, grads


def apply_grads(state: TrainState, g: Grads, radii, width: int,
                height: int, lrs: GaussianParams, net, phase: StepPhase,
                net_lr: float):
    """The step's optimizer, one launch on the card (ops/optim.py): the
    count of non-finite gradients, Adam on the Gaussians (learning rates
    `lrs`), the exposure table and, with aggregation, the net (in place),
    and the densification statistics of a width x height view.  Returns
    (the new state, the count as a 0-dim int64)."""
    op = optim.OptimPass(state.model.alive.device)
    # a reverse-only NaN (0·inf through a masked chain) poisons the moments
    # while every loss stays finite: count it
    count = op.nonfinite(g.tensors())
    model = adam_step(state.model, g.params, lrs, into=op)
    model = accumulate_stats(model, g.screen, g.screen_abs, radii, width,
                             height, op)
    (app_ab,), app_opt = side_adam([state.app_ab], state.app_opt,
                                   [g.app_ab], lr=1e-3, b2=0.99, into=op)
    net_opt = state.net_opt
    if phase.use_aggregation:
        _, net_opt = side_adam(list(net.parameters()), state.net_opt, g.net,
                               lr=net_lr, into=op, in_place=True)
    op.run()
    return dataclasses.replace(state, model=model, app_ab=app_ab,
                               app_opt=app_opt, net_opt=net_opt), count


def make_train_step(opt: OptimizationParams, rcfg: RasterConfig,
                    net: Optional[aggregation.ColorFusionResidualNet],
                    phase: StepPhase):
    """step(state, cam, cam_uid, gt, src, iteration, bg, use_app,
    burned_in, net_lr) -> (state, aux).  `net` is the state's fusion net;
    its weights are updated in place (under no_grad), everything else
    comes back as new tensors.  aux holds the loss terms, `loss` (the
    total), `nonfinite_grads`, the median depth and the instance / row
    counts."""
    lrcfg = make_lr_config(opt)

    def step(state: TrainState, cam: Camera, cam_uid: int, gt, src,
             iteration: int, bg, use_app: bool, burned_in: float,
             net_lr: float):
        with profiling.annotate("train_step", iteration):
            total, aux, g = loss_and_grads(
                opt, rcfg, net, phase, state, cam, cam_uid, gt, src,
                iteration, bg, use_app, burned_in)
            aux["loss"] = total
            with profiling.annotate("optimizer"):
                state, aux["nonfinite_grads"] = apply_grads(
                    state, g, aux.pop("radii"), cam.width, cam.height,
                    lr_tree(lrcfg, iteration, state.spatial_lr_scale), net,
                    phase, net_lr)
        return state, aux

    return step


# ------------------------------------------------------------ maintenance

def densify_step(model: GaussianModel, gen: torch.Generator,
                 cfg: gaussians.DensifyConfig, extent: float,
                 max_screen: Optional[float] = None) -> GaussianModel:
    """densify_and_prune with the event's noise drawn from `gen`."""
    noise = gaussians.densify_noise(gen, model.capacity, model.alive.device)
    return gaussians.densify_and_prune(model, noise, cfg, extent,
                                       max_screen_size=max_screen)


def maybe_grow(model: GaussianModel, max_all_points: int):
    """Double the capacity when more than 90% of the slots are alive and
    the capacity is below `max_all_points` (capped at the power of two
    above it).  Reads the alive count from the device.  Returns (model,
    new capacity or None)."""
    cap = model.capacity
    if int(model.alive.sum()) > 0.9 * cap and cap < max_all_points:
        newcap = min(cap * 2, 1 << int(np.ceil(np.log2(max_all_points))))
        return gaussians.grow_capacity(model, newcap), newcap
    return model, None
