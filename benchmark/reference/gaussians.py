"""Gaussian scene model (counterpart of ibgs_tpu/models/gaussians.py):
parameters, activations, plane normals, initialisation from a point cloud
with KNN scales, the optimiser state, per-group Adam with its
learning-rate schedules, the densification statistics, densify / prune,
opacity reset and decay, and capacity growth.

The state keeps the JAX package's fixed-capacity layout: arrays of length
P plus an `alive` mask.  Clone, split and prune are array surgery on the
model's device (rank-based slot allocation and scatters into dead slots);
capacity changes only when the training loop grows it.  The step counter
is a host int, so no device value is read to schedule a step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from benchmark.reference import transforms as tf


@dataclasses.dataclass
class GaussianParams:
    xyz: torch.Tensor            # (P, 3)
    sh_dc: torch.Tensor          # (P, 1, 3)
    sh_rest: torch.Tensor        # (P, K-1, 3)
    log_scale: torch.Tensor      # (P, 3)
    quat: torch.Tensor           # (P, 4) unnormalised
    opacity_logit: torch.Tensor  # (P, 1)
    normal: torch.Tensor         # (P, 3) learnable plane normal
    offset: torch.Tensor         # (P, 1) learnable plane offset


PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianParams))


@dataclasses.dataclass
class GaussianModel:
    params: GaussianParams
    alive: torch.Tensor          # (P,) bool
    active_sh_degree: int
    max_sh_degree: int
    # training state (None for a serving-only model; see with_train_state)
    mu: Optional[GaussianParams] = None   # Adam first moments
    nu: Optional[GaussianParams] = None   # Adam second moments
    step: int = 0                         # optimiser step
    max_radii2d: Optional[torch.Tensor] = None    # (P,) float32
    grad_accum: Optional[torch.Tensor] = None     # (P,)
    grad_accum_abs: Optional[torch.Tensor] = None  # (P,)
    denom: Optional[torch.Tensor] = None          # (P,)
    denom_abs: Optional[torch.Tensor] = None      # (P,)

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    # ---- activations -----------------------------------------------------
    @property
    def scale(self) -> torch.Tensor:
        return torch.exp(self.params.log_scale)

    @property
    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity_logit[:, 0])

    @property
    def quat_unit(self) -> torch.Tensor:
        # eps keeps dead (zero-padded) slots NaN-free
        return tf.normalize(self.params.quat, eps=1e-12)

    @property
    def sh_coeffs(self) -> torch.Tensor:
        return torch.cat([self.params.sh_dc, self.params.sh_rest], dim=1)

    def smallest_axis(self) -> torch.Tensor:
        """Principal axis with the smallest scale."""
        R = tf.quat_to_rotmat(self.quat_unit)
        idx = torch.argmin(self.params.log_scale, dim=-1)
        return torch.take_along_dim(
            R, idx[:, None, None].expand(-1, 3, 1), dim=2)[..., 0]

    def oriented_normal(self, cam_pos: torch.Tensor, learnt: bool = True):
        """Camera-facing plane normal and signed plane offset."""
        if learnt:
            n = tf.normalize(self.params.normal, eps=1e-12)
            off = self.params.offset[:, 0]
        else:
            n = self.smallest_axis()
            off = torch.zeros_like(self.params.offset[:, 0])
        to_cam = cam_pos - self.params.xyz
        flip = torch.where((n * to_cam).sum(-1) < 0.0, -1.0, 1.0)
        return n * flip[:, None], off * flip


def with_train_state(model: GaussianModel,
                     mu: Optional[GaussianParams] = None,
                     nu: Optional[GaussianParams] = None,
                     step: int = 0) -> GaussianModel:
    """The model with Adam moments (zeros unless given), the step count
    and zeroed densification statistics."""
    def zeros_like_params():
        return GaussianParams(**{k: torch.zeros_like(getattr(model.params, k))
                                 for k in PARAM_FIELDS})

    def z():
        return torch.zeros(model.capacity, dtype=torch.float32,
                           device=model.alive.device)

    return dataclasses.replace(
        model, mu=zeros_like_params() if mu is None else mu,
        nu=zeros_like_params() if nu is None else nu, step=int(step),
        max_radii2d=z(), grad_accum=z(), grad_accum_abs=z(), denom=z(),
        denom_abs=z())


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------











# --------------------------------------------------------------------------
# optimiser (per-group Adam, eps 1e-15)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LRConfig:
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.025
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    normal_lr: float = 1e-3


def expon_lr(step, lr_init, lr_final, max_steps, delay_mult=0.01,
             delay_steps=0) -> float:
    """Log-linear LR interpolation, computed on the host in float32 as the
    JAX package computes it on the device; returns a Python float."""
    f = np.float32
    t = np.clip(f(step) / f(max_steps), f(0), f(1))
    log_lerp = np.exp(np.log(f(lr_init)) * (f(1) - t)
                      + np.log(f(lr_final)) * t)
    delay = f(1)
    if delay_steps > 0:
        delay = f(delay_mult) + (f(1) - f(delay_mult)) * np.sin(
            f(0.5 * np.pi) * np.clip(f(step) / f(delay_steps), f(0), f(1)))
    return float(f(delay * log_lerp))


def lr_tree(cfg: LRConfig, step, spatial_lr_scale) -> GaussianParams:
    """Per-group learning rates at `step` (Python floats): xyz and the
    plane offset decay log-linearly, the others are constant."""
    s = np.float32(spatial_lr_scale)
    xyz_lr = expon_lr(step, np.float32(cfg.position_lr_init) * s,
                      np.float32(cfg.position_lr_final) * s,
                      cfg.position_lr_max_steps, cfg.position_lr_delay_mult)
    off_lr = expon_lr(step, np.float32(cfg.position_lr_init) * s
                      * np.float32(0.5),
                      np.float32(cfg.position_lr_final) * s
                      * np.float32(0.5),
                      cfg.position_lr_max_steps, cfg.position_lr_delay_mult)
    return GaussianParams(
        xyz=xyz_lr, sh_dc=cfg.feature_lr, sh_rest=cfg.feature_lr / 20.0,
        log_scale=cfg.scaling_lr, quat=cfg.rotation_lr,
        opacity_logit=cfg.opacity_lr, normal=cfg.normal_lr, offset=off_lr)


def bias_corrections(step: int, b1: float, b2: float):
    """Adam's 1 - b^step for both moments, in float32, as Python floats."""
    f = np.float32
    return (float(f(1) - f(b1) ** f(step)), float(f(1) - f(b2) ** f(step)))


@torch.no_grad()
def adam_step(model: GaussianModel, grads: GaussianParams,
              lrs: GaussianParams, b1=0.9, b2=0.999,
              eps=1e-15) -> GaussianModel:
    """One Adam update of every parameter group with its own learning
    rate.  Gradients of dead slots are zeroed first (their reverse-mode
    values can be 0·nan).  Written out, not torch.optim, so that it can be
    held to the JAX package exactly; it returns new tensors and leaves the
    inputs as they are."""
    step = model.step + 1
    bc1, bc2 = bias_corrections(step, b1, b2)
    alive = model.alive

    def upd(p, m, v, g, lr):
        g = torch.where(alive.reshape((-1,) + (1,) * (g.dim() - 1)), g, 0.0)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        return p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps), m, v

    out = {k: upd(getattr(model.params, k), getattr(model.mu, k),
                  getattr(model.nu, k), getattr(grads, k), getattr(lrs, k))
           for k in PARAM_FIELDS}
    return dataclasses.replace(
        model, params=GaussianParams(**{k: o[0] for k, o in out.items()}),
        mu=GaussianParams(**{k: o[1] for k, o in out.items()}),
        nu=GaussianParams(**{k: o[2] for k, o in out.items()}), step=step)


# --------------------------------------------------------------------------
# densification statistics
# --------------------------------------------------------------------------

@torch.no_grad()
def accumulate_stats(model: GaussianModel, screen_grad, screen_grad_abs,
                     radii, width: int, height: int) -> GaussianModel:
    """screen_grad[_abs]: (P, 2) pixel-unit screen-space gradients from the
    rasterizer's dummy inputs, rescaled to the NDC convention (x 0.5·W/H)
    whose thresholds densification uses.  Visible Gaussians (radius > 0)
    accumulate the norms and their counts and raise max_radii2d."""
    vis = radii > 0
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                         device=screen_grad.device)
    sgrad = screen_grad * scale
    sabs = screen_grad_abs * scale
    visf = vis.to(torch.float32)
    return dataclasses.replace(
        model,
        max_radii2d=torch.where(vis, torch.maximum(
            model.max_radii2d, radii.to(torch.float32)), model.max_radii2d),
        grad_accum=model.grad_accum + torch.where(
            vis, torch.linalg.vector_norm(sgrad, dim=-1), 0.0),
        grad_accum_abs=model.grad_accum_abs + torch.where(
            vis, torch.linalg.vector_norm(sabs, dim=-1), 0.0),
        denom=model.denom + visf, denom_abs=model.denom_abs + visf)


# --------------------------------------------------------------------------
# densify / prune
# --------------------------------------------------------------------------























