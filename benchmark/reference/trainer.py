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

import torch

from benchmark.reference import renderer
from benchmark.reference.config import OptimizationParams
from benchmark.reference.camera import Camera
from benchmark.reference import aggregation
from benchmark.reference.gaussians import (PARAM_FIELDS, GaussianModel,
                                             GaussianParams, LRConfig,
                                             accumulate_stats, adam_step,
                                             bias_corrections, lr_tree)
from benchmark.reference.epilogue import SourceViews
from benchmark.reference.rasterize import RasterConfig
from benchmark.reference import losses

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
              eps=1e-8):
    """Adam on a list of tensors.  Returns (new params, new state); the
    inputs are left as they are."""
    step = opt.step + 1
    bc1, bc2 = bias_corrections(step, b1, b2)
    new_p, new_m, new_v = [], [], []
    for p, m, v, g in zip(params, opt.mu, opt.nu, grads):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        new_p.append(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        new_m.append(m)
        new_v.append(v)
    return new_p, SideOptState(mu=new_m, nu=new_v, step=step)


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
        total, aux, g = loss_and_grads(
            opt, rcfg, net, phase, state, cam, cam_uid, gt, src, iteration,
            bg, use_app, burned_in)
        aux["loss"] = total
        # a reverse-only NaN (0·inf through a masked chain) poisons the
        # moments while every loss stays finite: count it
        aux["nonfinite_grads"] = sum((~torch.isfinite(x)).sum()
                                     for x in g.tensors())

        lrs = lr_tree(lrcfg, iteration, state.spatial_lr_scale)
        model = adam_step(state.model, g.params, lrs)
        model = accumulate_stats(model, g.screen, g.screen_abs,
                                 aux.pop("radii"), cam.width, cam.height)
        (app_ab,), app_opt = side_adam([state.app_ab], state.app_opt,
                                       [g.app_ab], lr=1e-3, b2=0.99)
        net_opt = state.net_opt
        if phase.use_aggregation:
            params = list(net.parameters())
            new, net_opt = side_adam(params, state.net_opt, g.net, lr=net_lr)
            with torch.no_grad():
                for p, q in zip(params, new):
                    p.copy_(q)
        return dataclasses.replace(state, model=model, app_ab=app_ab,
                                   app_opt=app_opt, net_opt=net_opt), aux

    return step


# ------------------------------------------------------------ maintenance



