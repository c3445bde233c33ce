"""Density control between train steps (the maintenance cadence of
ibgs_tpu/train/loop.py): the one function that the training loop
(train/loop.py) and the benchmark's densify cell call after every step.

`maintain(state, it, opt, gen, extent)` runs, before `densify_until_iter`:

1. at a densify event (`densify_due`: after `densify_from_iter`, every
   `densification_interval`) a capacity growth when more than 90% of the
   slots are alive, so that clone and split are not slot-starved; then
   `trainer.densify_step` (`max_screen` 20 after the first opacity
   reset); then a growth again;
2. the opacity reset every `opacity_reset_interval` (and at
   `densify_from_iter` on a white background);
3. the opacity decay every `opacity_decay_interval` after
   `densify_from_iter`, when `opacity_decay` lies in (0, 1).

An event reads the device twice: the alive count before it, which decides
the first growth, and in one transfer the alive count after it with its
clone, split and prune counts, which decides the second.  `Pool` is the
slot pool the event works on: the whole model on one device or, under a
("dp", "gs") mesh, this rank's shard (counts summed over the shards, a
growth dealt out again by `gsp_interleave`).

Spans (`utils/profiling.annotate`): `maintenance` around whatever runs,
`densify` and `grow` inside it.  COUNTERS keeps running totals of the
events, the growths and the slots cloned, split and pruned, as
`ops/_cuda.LAUNCHES` keeps the launches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ibgs_tpu_torch.config import OptimizationParams
from ibgs_tpu_torch.models.gaussians import (DensifyConfig, GaussianModel,
                                             decay_opacity, grow_capacity,
                                             reset_opacity)
from ibgs_tpu_torch.train.trainer import (TrainState, densify_step,
                                          grown_capacity, maybe_grow)
from ibgs_tpu_torch.utils import profiling

COUNTERS = dict.fromkeys(("events", "grows", "cloned", "split", "pruned"),
                         0)
SCREEN_PRUNE = 20.0     # max screen radius pruned after the first reset


def densify_config(opt: OptimizationParams) -> DensifyConfig:
    return DensifyConfig(
        grad_threshold=opt.densify_grad_threshold,
        abs_grad_threshold=opt.densify_abs_grad_threshold,
        opacity_cull=opt.opacity_cull_threshold,
        percent_dense=opt.percent_dense,
        abs_split_radii2d_threshold=opt.abs_split_radii2D_threshold,
        max_abs_split=opt.max_abs_split_points)


def densify_due(opt: OptimizationParams, it: int) -> bool:
    """Whether iteration `it` ends with a densify event."""
    return (opt.densify_from_iter < it < opt.densify_until_iter
            and it % opt.densification_interval == 0)


class Pool:
    """The slots an event works on: the whole model (no `mesh`), or this
    rank's shard of a Gaussian-sharded model over the mesh's "gs" axis."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.shards = 1
        self._densify = {}
        if mesh is not None:
            from ibgs_tpu_torch.parallel import collectives
            self.shards = collectives.axis_size(mesh, "gs")

    def capacity(self, model: GaussianModel) -> int:
        return model.capacity * self.shards

    def read(self, counts: torch.Tensor) -> list:
        """A (k,) int64 device vector summed over the shards, as host
        ints: one transfer."""
        if self.mesh is not None:
            from ibgs_tpu_torch.parallel import collectives
            counts = collectives.psum(counts, self.mesh, "gs")
        return [int(x) for x in counts.tolist()]

    def densify(self, model, gen, dcfg: DensifyConfig, extent: float,
                max_screen):
        if self.mesh is None:
            return densify_step(model, gen, dcfg, extent,
                                max_screen=max_screen)
        if (dcfg, max_screen) not in self._densify:
            from ibgs_tpu_torch.parallel import gsp
            self._densify[dcfg, max_screen] = gsp.gsp_densify_fn(
                self.mesh, dcfg, max_screen=max_screen)
        return self._densify[dcfg, max_screen](model, gen, extent)

    def grow(self, model: GaussianModel, n_alive: int,
             max_all_points: int):
        """`trainer.maybe_grow` of the pool with `n_alive` of its slots
        alive: (model, new capacity in all or None).  Every rank calls it;
        a shard is gathered only to grow."""
        if self.mesh is None:
            return maybe_grow(model, max_all_points, n_alive)
        newcap = grown_capacity(self.capacity(model), n_alive,
                                max_all_points)
        if newcap is None:
            return model, None
        from ibgs_tpu_torch.parallel import gsp
        full = grow_capacity(gsp.gather_model(model, self.mesh), newcap)
        # the new free slots pad the end: deal them out again
        return gsp.shard_model(gsp.gsp_interleave(full, self.shards),
                               self.mesh), newcap


def maintain(state: TrainState, it: int, opt: OptimizationParams,
             gen: torch.Generator, extent: float,
             white_background: bool = False, pool: Optional[Pool] = None):
    """The maintenance after the step of iteration `it`.  Returns (the
    state, the densify event's record or None when no event ran).  The
    record: `iter`, `ms` (host ms from the first count to the counts read
    back), `n_alive_before`, `n_alive_after`, `cloned`, `split`,
    `pruned`, `capacity_before`, `capacity` (after the event), `grows`
    ([{old, new, pre_densify}], one a growth) and, under a mesh,
    `gsp_shards`.  `gen` draws the densify noise (a `shard_generator`
    under a mesh)."""
    pool = Pool() if pool is None else pool
    if it >= opt.densify_until_iter:
        return state, None
    densify = densify_due(opt, it)
    reset = it % opt.opacity_reset_interval == 0 or (
        white_background and it == opt.densify_from_iter)
    decay = (0 < opt.opacity_decay < 1
             and it % opt.opacity_decay_interval == 0
             and it > opt.densify_from_iter)
    if not (densify or reset or decay):
        return state, None
    rec = None
    with profiling.annotate("maintenance"):
        if densify:
            state, rec = _densify_event(state, it, opt, gen, extent, pool)
        model = state.model
        if reset:
            model = reset_opacity(model)
        if decay:
            model = decay_opacity(model, opt.opacity_decay)
        state = dataclasses.replace(state, model=model)
    return state, rec


def _densify_event(state, it, opt, gen, extent, pool):
    t0 = time.perf_counter()
    model = state.model
    cap0 = pool.capacity(model)
    grows = []

    def grow(model, n_alive, pre):
        cap = pool.capacity(model)
        with profiling.annotate("grow"):
            model, newcap = pool.grow(model, n_alive, opt.max_all_points)
        if newcap is not None:
            grows.append(dict(old=cap, new=newcap, pre_densify=pre))
            COUNTERS["grows"] += 1
        return model

    (n_before,) = pool.read(model.alive.sum().reshape(1))
    model = grow(model, n_before, True)
    max_screen = SCREEN_PRUNE if it > opt.opacity_reset_interval else None
    with profiling.annotate("densify"):
        model, counts = pool.densify(model, gen, densify_config(opt),
                                     extent, max_screen)
        n_after, cloned, split, pruned = pool.read(
            torch.cat([model.alive.sum().reshape(1), counts]))
    ms = (time.perf_counter() - t0) * 1e3
    model = grow(model, n_after, False)
    rec = dict(iter=it, ms=ms, n_alive_before=n_before, n_alive_after=n_after,
               cloned=cloned, split=split, pruned=pruned,
               capacity_before=cap0, capacity=pool.capacity(model),
               grows=grows)
    if pool.mesh is not None:
        rec["gsp_shards"] = pool.shards
    for k, v in (("events", 1), ("cloned", cloned), ("split", split),
                 ("pruned", pruned)):
        COUNTERS[k] += v
    return dataclasses.replace(state, model=model), rec
