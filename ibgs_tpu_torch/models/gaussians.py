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

from ibgs_tpu_torch.core import sh as shlib
from ibgs_tpu_torch.core import transforms as tf
from ibgs_tpu_torch.core.knn import initial_log_scales
from ibgs_tpu_torch.ops import optim


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

STAT_FIELDS = ("max_radii2d", "grad_accum", "grad_accum_abs", "denom",
               "denom_abs")
NATIVE_KNN_MIN_POINTS = 200_000


def _map_params(fn, *trees: GaussianParams) -> GaussianParams:
    return GaussianParams(**{k: fn(*(getattr(t, k) for t in trees))
                             for k in PARAM_FIELDS})


def _grow(x: torch.Tensor, cap: int) -> torch.Tensor:
    """Zero-pad the leading axis of x to `cap` rows."""
    pad = torch.zeros((cap - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def init_from_points(points: np.ndarray, colors: np.ndarray,
                     max_sh_degree: int = 2, capacity: Optional[int] = None,
                     device="cuda") -> GaussianModel:
    """A model with train state from a seed cloud: one Gaussian per point
    at capacity `capacity` (default max(4096, 4n rounded up to a power of
    two)), isotropic scales from the mean squared distance to the 3
    nearest neighbours, SH DC from the colours, opacity 0.1, identity
    rotation, plane normal (0, 0, 1).  Clouds of more than 200k points
    take the native host KNN (exact, Morton order and box culling), the
    others the device KNN of core/knn."""
    n = points.shape[0]
    if capacity is None:
        capacity = max(4096, 1 << int(np.ceil(np.log2(4 * n))))
    dev = torch.device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32)).to(dev)
    K = shlib.num_coeffs(max_sh_degree)
    if n > NATIVE_KNN_MIN_POINTS:
        from ibgs_tpu_torch.utils import native

        d2 = np.clip(native.knn_mean_sq_dist_3(np.asarray(points)), 1e-7,
                     None)
        log_scales = torch.as_tensor(np.repeat(
            np.log(np.sqrt(d2))[:, None], 3, axis=1).astype(np.float32)
        ).to(dev)
    else:
        log_scales = initial_log_scales(pts)

    def rows(v):
        return torch.tensor([v], dtype=torch.float32, device=dev).repeat(n, 1)

    sh0 = shlib.rgb_to_sh0(torch.as_tensor(np.asarray(colors, np.float32))
                           .to(dev))
    params = GaussianParams(
        xyz=_grow(pts, capacity),
        sh_dc=_grow(sh0[:, None, :], capacity),
        sh_rest=torch.zeros(capacity, K - 1, 3, dtype=torch.float32,
                            device=dev),
        log_scale=_grow(log_scales, capacity),
        quat=_grow(rows([1.0, 0.0, 0.0, 0.0]), capacity),
        opacity_logit=_grow(rows([float(np.log(0.1 / 0.9))]), capacity),
        normal=_grow(rows([0.0, 0.0, 1.0]), capacity),
        offset=torch.zeros(capacity, 1, dtype=torch.float32, device=dev))
    model = GaussianModel(params=params,
                          alive=torch.arange(capacity, device=dev) < n,
                          active_sh_degree=0, max_sh_degree=max_sh_degree)
    return with_train_state(model)


def grow_capacity(model: GaussianModel, new_capacity: int) -> GaussianModel:
    """The model zero-padded to `new_capacity` slots (the new slots dead,
    their moments and statistics zero)."""
    def g(x):
        return _grow(x, new_capacity)

    return dataclasses.replace(
        model, params=_map_params(g, model.params),
        mu=_map_params(g, model.mu), nu=_map_params(g, model.nu),
        alive=g(model.alive),
        **{k: g(getattr(model, k)) for k in STAT_FIELDS})


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
              lrs: GaussianParams, b1=0.9, b2=0.999, eps=1e-15,
              into: Optional[optim.OptimPass] = None) -> GaussianModel:
    """One Adam update of every parameter group with its own learning
    rate.  Gradients of dead slots are zeroed first (their reverse-mode
    values can be 0·nan).  Written out, not torch.optim, so that it can be
    held to the JAX package exactly; it returns new tensors and leaves the
    inputs as they are.  The updates are segments of `into` (an
    optim.OptimPass; its `run` computes them on CUDA tensors), else of a
    pass of their own, run here."""
    op = optim.OptimPass(model.alive.device) if into is None else into
    step = model.step + 1
    bc = bias_corrections(step, b1, b2)
    out = {k: op.adam(getattr(model.params, k), getattr(model.mu, k),
                      getattr(model.nu, k), getattr(grads, k),
                      getattr(lrs, k), bc, b1, b2, eps, alive=model.alive)
           for k in PARAM_FIELDS}
    if into is None:
        op.run()
    return dataclasses.replace(
        model, params=GaussianParams(**{k: o[0] for k, o in out.items()}),
        mu=GaussianParams(**{k: o[1] for k, o in out.items()}),
        nu=GaussianParams(**{k: o[2] for k, o in out.items()}), step=step)


# --------------------------------------------------------------------------
# densification statistics
# --------------------------------------------------------------------------

@torch.no_grad()
def accumulate_stats(model: GaussianModel, screen_grad, screen_grad_abs,
                     radii, width: int, height: int,
                     into: Optional[optim.OptimPass] = None
                     ) -> GaussianModel:
    """screen_grad[_abs]: (P, 2) pixel-unit screen-space gradients from the
    rasterizer's dummy inputs, rescaled to the NDC convention (x 0.5·W/H)
    whose thresholds densification uses.  Visible Gaussians (radius > 0)
    accumulate the norms and their counts and raise max_radii2d
    (optim.stats_plain).  A segment of `into`, else of a pass of its own,
    run here."""
    op = optim.OptimPass(model.alive.device) if into is None else into
    new = op.stats(tuple(getattr(model, k) for k in STAT_FIELDS),
                   screen_grad, screen_grad_abs, radii, width, height)
    if into is None:
        op.run()
    return dataclasses.replace(model, **dict(zip(STAT_FIELDS, new)))


# --------------------------------------------------------------------------
# densify / prune
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 2e-4
    abs_grad_threshold: float = 8e-4
    opacity_cull: float = 0.05
    percent_dense: float = 0.001
    abs_split_radii2d_threshold: float = 20.0
    max_abs_split: int = 50_000
    split_scale_shrink: float = 1.6    # children at scale / (0.8·N), N=2


def densify_noise(gen: torch.Generator, capacity: int, device
                  ) -> torch.Tensor:
    """The standard-normal draws of one densify event, (3, P, 3) float32:
    the clone, split child A and split child B samples, from `gen`."""
    return torch.randn((3, capacity, 3), generator=gen, dtype=torch.float32,
                       device=device)


def _f32_product(a: float, b: float) -> float:
    """a·b rounded as a float32 product, as the JAX package's threshold
    of a float times a float32 scene extent is."""
    return float(np.float32(a) * np.float32(b))


def _rank(priority: torch.Tensor) -> torch.Tensor:
    """Each slot's place in the order of decreasing priority, ties by slot
    index: the inverse permutation of a stable sort."""
    order = torch.sort(-priority, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return rank


def _allocate_slots(alive: torch.Tensor, want: torch.Tensor,
                    priority: torch.Tensor):
    """Rank-based dead-slot allocation: the wanted slots in order of
    decreasing priority take the dead slots in index order, as far as they
    go.  Returns (target slot per slot, granted mask)."""
    P = alive.shape[0]
    dead_order = torch.sort(alive.to(torch.int32), stable=True).indices
    n_free = P - alive.sum()
    rank = _rank(torch.where(want, priority, -torch.inf))
    granted = want & (rank < n_free)
    return dead_order[rank.clamp(0, P - 1)], granted


def _scatter_from(model: GaussianModel, src: GaussianParams,
                  target: torch.Tensor, granted: torch.Tensor
                  ) -> GaussianModel:
    """Copy the granted rows of `src` into their target slots, alive, with
    zero moments.  Granted targets are distinct, so no write is lost.  The
    copy is a gather by each slot's source row, so no row count is read
    back to the host."""
    P = model.capacity
    dev = model.alive.device
    # each slot's source row (-1 for none); refused rows write to slot P,
    # which is cut off
    src_of = torch.full((P + 1,), -1, dtype=torch.int64, device=dev)
    src_of[torch.where(granted, target, P)] = torch.arange(P, device=dev)
    src_of = src_of[:P]
    hit = src_of >= 0
    rows = src_of.clamp(min=0)

    def mask(x):
        return hit.reshape((-1,) + (1,) * (x.dim() - 1))

    def put(d, s):
        return torch.where(mask(d), s[rows], d)

    def zero(m):
        return torch.where(mask(m), 0.0, m)

    return dataclasses.replace(
        model, params=_map_params(put, model.params, src),
        mu=_map_params(zero, model.mu), nu=_map_params(zero, model.nu),
        alive=model.alive | hit)


def _sampled_positions(model: GaussianModel, eps: torch.Tensor
                       ) -> torch.Tensor:
    """Positions inside each Gaussian: mean + R·(eps ⊙ scale)."""
    R = tf.quat_to_rotmat(model.quat_unit)
    return model.params.xyz + torch.einsum("pij,pj->pi", R,
                                           eps * model.scale)


@torch.no_grad()
def densify_and_prune(model: GaussianModel, noise: torch.Tensor,
                      cfg: DensifyConfig, scene_extent: float,
                      max_screen_size: Optional[float] = None):
    """Clone → split → prune, then zero the statistics.  `noise` is
    `densify_noise`'s (3, P, 3) draws.  Returns (the model, the event's
    counts): a (3,) int64 tensor on the model's device of the clones and
    splits granted and the alive slots pruned, read by no host sync.

    Clone: small alive splats with a high mean gradient get a copy at a
    position sampled inside them.  Split: large ones with a high gradient,
    or a high absolute gradient and a large screen radius (that path
    budgeted to `max_abs_split`), get child B in a free slot and are
    replaced in place by child A, both at scale / 1.6 and sampled
    positions; where B gets no slot the parent stays.  When free slots run
    short, the highest-gradient candidates win.  Prune: low opacity, and
    with `max_screen_size` too large on screen or in the world."""
    alive = model.alive
    g = model.grad_accum / torch.clamp(model.denom, min=1.0)
    g_abs = model.grad_accum_abs / torch.clamp(model.denom_abs, min=1.0)
    g = torch.where(alive, torch.nan_to_num(g), 0.0)
    g_abs = torch.where(alive, torch.nan_to_num(g_abs), 0.0)
    small = model.scale.amax(-1) <= _f32_product(cfg.percent_dense,
                                                 scene_extent)

    # clone: small splats with a high gradient → a sampled copy
    want_clone = alive & (g >= cfg.grad_threshold) & small
    clone_src = dataclasses.replace(
        model.params, xyz=_sampled_positions(model, noise[0]))
    tgt, got = _allocate_slots(alive, want_clone, g)
    model = _scatter_from(model, clone_src, tgt, got)
    n_clone = got.sum()

    # split: large splats with a high (or a high absolute) gradient
    big = ~small & model.alive
    want_split = big & (g >= cfg.grad_threshold)
    abs_ok = (big & ~want_split
              & (model.max_radii2d > cfg.abs_split_radii2d_threshold)
              & (g_abs >= cfg.abs_grad_threshold))
    abs_ok = abs_ok & (_rank(torch.where(abs_ok, g_abs, -torch.inf))
                       < cfg.max_abs_split)
    want_split = want_split | abs_ok

    shrink = float(np.log(cfg.split_scale_shrink))
    child_a = dataclasses.replace(
        model.params, xyz=_sampled_positions(model, noise[1]),
        log_scale=model.params.log_scale - shrink)
    child_b = dataclasses.replace(
        model.params, xyz=_sampled_positions(model, noise[2]),
        log_scale=model.params.log_scale - shrink)
    tgt, got = _allocate_slots(model.alive, want_split,
                               torch.maximum(g, g_abs))
    model = _scatter_from(model, child_b, tgt, got)
    n_split = got.sum()

    def rows(x):
        return got.reshape((-1,) + (1,) * (x.dim() - 1))

    model = dataclasses.replace(
        model,
        params=_map_params(lambda d, s: torch.where(rows(d), s, d),
                           model.params, child_a),
        mu=_map_params(lambda m: torch.where(rows(m), 0.0, m), model.mu),
        nu=_map_params(lambda m: torch.where(rows(m), 0.0, m), model.nu))

    # prune
    prune = model.opacity < cfg.opacity_cull
    if max_screen_size is not None:
        prune = prune | (model.max_radii2d > max_screen_size)
        prune = prune | (model.scale.amax(-1)
                         > _f32_product(0.1, scene_extent))
    prune = model.alive & prune
    zeros = torch.zeros_like(model.grad_accum)
    counts = torch.stack([n_clone, n_split, prune.sum()])
    return dataclasses.replace(model, alive=model.alive & ~prune,
                               **{k: zeros for k in STAT_FIELDS}), counts


def _with_opacity(model: GaussianModel, op: torch.Tensor) -> GaussianModel:
    """The model with opacities `op` and zero opacity moments."""
    logit = torch.log(op) - torch.log1p(-op)
    z = torch.zeros_like(logit)
    return dataclasses.replace(
        model, params=dataclasses.replace(model.params, opacity_logit=logit),
        mu=dataclasses.replace(model.mu, opacity_logit=z),
        nu=dataclasses.replace(model.nu, opacity_logit=z.clone()))


@torch.no_grad()
def reset_opacity(model: GaussianModel, ceiling: float = 0.01
                  ) -> GaussianModel:
    """Clamp opacities to at most `ceiling`; zero the opacity moments."""
    return _with_opacity(model, torch.clamp(
        torch.sigmoid(model.params.opacity_logit), max=ceiling))


@torch.no_grad()
def decay_opacity(model: GaussianModel, factor: float) -> GaussianModel:
    """Scale opacities by `factor`; zero the opacity moments."""
    return _with_opacity(model,
                         torch.sigmoid(model.params.opacity_logit) * factor)


def oneup_sh_degree(model: GaussianModel) -> GaussianModel:
    return dataclasses.replace(model, active_sh_degree=min(
        model.active_sh_degree + 1, model.max_sh_degree))
