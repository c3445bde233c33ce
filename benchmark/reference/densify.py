"""Density control, plain: one densify event of IBGS (clone → split →
prune), the rank-based allocation of dead slots, the abs-split budget,
the capacity doubling above 90% occupancy and the opacity reset, written
from the IBGS semantics of the JAX package (`ibgs_tpu/models/gaussians.py`
`densify_and_prune`, `grow_capacity`, `reset_opacity`, and its loop's
cadence) in float32 torch on plain tensors.  It imports nothing of
`ibgs_tpu_torch`, `ibgs_tpu` or `jax`.

A state is a dict: "params", "mu", "nu" (each a dict of the eight fields
below, (P, ...) float32), "alive" ((P,) bool) and the five statistics of
STATS, (P,) float32.  Functions return new dicts and leave their inputs
as they are.

Departures from the JAX package, each where the semantics allow it:

* the noise is an input, `draw(P)` → the (3, P, 3) standard normals of
  the clone, split child A and split child B (JAX splits a key), so that
  both sides of a comparison sample the same positions;
* slots are allocated by listing the candidates in order of decreasing
  priority (ties by slot index) and the dead slots in index order and
  pairing them, as far as the dead slots go, where JAX ranks every slot;
* split candidates are taken among the slots alive before the clone: a
  clone's slot was dead before it, so its gradient is 0 and it can be
  neither a split nor an abs-split candidate in the JAX package either;
* the products of a float threshold and the scene extent are formed in
  float32, as JAX forms them with a float32 extent.

Under `precision.lowered` (the control) every float of the state and the
noise entering an event is rounded to the lower precision first.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import precision

FIELDS = ("xyz", "sh_dc", "sh_rest", "log_scale", "quat", "opacity_logit",
          "normal", "offset")
STATS = ("max_radii2d", "grad_accum", "grad_accum_abs", "denom",
         "denom_abs")
TREES = ("params", "mu", "nu")
SPLIT_SHRINK = 1.6          # children at scale / (0.8·N), N = 2
OCCUPANCY = 0.9             # the pool doubles above this share alive
RESET_CEILING = 0.01


def _f32(a: float, b: float) -> torch.Tensor:
    return torch.tensor(a, dtype=torch.float32) * torch.tensor(
        b, dtype=torch.float32)


def _copy(state: dict) -> dict:
    out = {t: dict(state[t]) for t in TREES}
    out["alive"] = state["alive"]
    for k in STATS:
        out[k] = state[k]
    return out


def _lowered(state: dict) -> dict:
    out = {t: {k: precision.q(v) for k, v in state[t].items()}
           for t in TREES}
    out["alive"] = state["alive"]
    for k in STATS:
        out[k] = precision.q(state[k])
    return out


def _rotation(quat: torch.Tensor) -> torch.Tensor:
    """(P, 4) wxyz quaternions, normalised as q·rsqrt(|q|² + 1e-12) → (P,
    3, 3)."""
    q = quat * torch.rsqrt((quat * quat).sum(-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _sample(params: dict, rows: torch.Tensor, eps: torch.Tensor):
    """Positions inside the Gaussians of `rows`: mean + R·(eps ⊙ scale)."""
    R = _rotation(params["quat"][rows])
    local = eps[rows] * torch.exp(params["log_scale"][rows])
    return params["xyz"][rows] + (R * local[:, None, :]).sum(-1)


def _ranked(mask: torch.Tensor, priority: torch.Tensor) -> torch.Tensor:
    """The slots of `mask` in order of decreasing priority, ties by slot
    index."""
    idx = torch.nonzero(mask).squeeze(1)
    return idx[torch.argsort(-priority[idx], stable=True)]


def _place(state: dict, cand: torch.Tensor, rows: dict):
    """Put candidate i's new row (`rows`: field → (len(cand), ...)) into
    the i-th dead slot, as far as the dead slots go, alive and with zero
    moments.  Returns (state, the candidates granted a slot)."""
    dead = torch.nonzero(~state["alive"]).squeeze(1)
    n = min(len(cand), len(dead))
    dst = dead[:n]
    out = _copy(state)
    for t in TREES:
        for k in FIELDS:
            x = state[t][k].clone()
            x[dst] = rows[k][:n] if t == "params" else 0.0
            out[t][k] = x
    alive = state["alive"].clone()
    alive[dst] = True
    out["alive"] = alive
    return out, cand[:n]


def densify_and_prune(state: dict, noise: torch.Tensor, opt, extent: float,
                      max_screen=None):
    """One event's clone → split → prune on `state` with `noise` (3, P, 3)
    and the thresholds of `opt` (an OptimizationParams).  Returns (state,
    {"cloned", "split", "pruned"} as ints)."""
    state = _lowered(state)
    noise = precision.q(noise)
    alive0 = state["alive"]
    g = torch.nan_to_num(state["grad_accum"]
                         / torch.clamp(state["denom"], min=1.0))
    g_abs = torch.nan_to_num(state["grad_accum_abs"]
                             / torch.clamp(state["denom_abs"], min=1.0))
    g = torch.where(alive0, g, 0.0)
    g_abs = torch.where(alive0, g_abs, 0.0)
    p0 = state["params"]
    small = (torch.exp(p0["log_scale"]).amax(-1)
             <= _f32(opt.percent_dense, extent))

    # clone: small splats with a high mean gradient get a sampled copy
    cand = _ranked(alive0 & small & (g >= opt.densify_grad_threshold), g)
    rows = {k: p0[k][cand] for k in FIELDS}
    rows["xyz"] = _sample(p0, cand, noise[0])
    state, cloned = _place(state, cand, rows)

    # split: large splats with a high gradient, or with a high absolute
    # gradient and a large screen radius (at most max_abs_split of those)
    big = alive0 & ~small
    by_grad = big & (g >= opt.densify_grad_threshold)
    by_abs = (big & ~by_grad
              & (state["max_radii2d"] > opt.abs_split_radii2D_threshold)
              & (g_abs >= opt.densify_abs_grad_threshold))
    budget = _ranked(by_abs, g_abs)[:opt.max_abs_split_points]
    want = by_grad.clone()
    want[budget] = True
    cand = _ranked(want, torch.maximum(g, g_abs))
    p1 = state["params"]
    shrink = math.log(SPLIT_SHRINK)
    child_b = {k: p1[k][cand] for k in FIELDS}
    child_b["xyz"] = _sample(p1, cand, noise[2])
    child_b["log_scale"] = p1["log_scale"][cand] - shrink
    state, split = _place(state, cand, child_b)
    # child A replaces its parent in place where child B got a slot
    a_xyz = _sample(p1, split, noise[1])
    out = _copy(state)
    for t in TREES:
        for k in FIELDS:
            x = state[t][k].clone()
            if t != "params":
                x[split] = 0.0
            elif k == "xyz":
                x[split] = a_xyz
            elif k == "log_scale":
                x[split] = p1["log_scale"][split] - shrink
            out[t][k] = x
    state = out

    # prune
    p2 = state["params"]
    prune = (torch.sigmoid(p2["opacity_logit"][:, 0])
             < opt.opacity_cull_threshold)
    if max_screen is not None:
        prune = prune | (state["max_radii2d"] > max_screen)
        prune = prune | (torch.exp(p2["log_scale"]).amax(-1)
                         > _f32(0.1, extent))
    pruned = state["alive"] & prune
    state["alive"] = state["alive"] & ~pruned
    for k in STATS:
        state[k] = torch.zeros_like(state[k])
    return state, {"cloned": len(cloned), "split": len(split),
                   "pruned": int(pruned.sum())}


def grown(capacity: int, n_alive: int, max_all_points: int):
    """The doubled capacity when more than 90% of the slots are alive and
    the pool is below max_all_points (at most the power of two above
    it), else None."""
    if n_alive <= OCCUPANCY * capacity or capacity >= max_all_points:
        return None
    return min(2 * capacity, 2 ** math.ceil(math.log2(max_all_points)))


def grow(state: dict, capacity: int) -> dict:
    """The state with zero rows appended up to `capacity` (dead)."""
    def pad(x):
        return torch.cat([x, x.new_zeros((capacity - x.shape[0],)
                                         + tuple(x.shape[1:]))])

    out = {t: {k: pad(v) for k, v in state[t].items()} for t in TREES}
    out["alive"] = pad(state["alive"])
    for k in STATS:
        out[k] = pad(state[k])
    return out


def reset_opacity(state: dict) -> dict:
    """Opacities clamped to at most 0.01; their moments zeroed."""
    out = _copy(state)
    op = torch.clamp(torch.sigmoid(state["params"]["opacity_logit"]),
                     max=RESET_CEILING)
    out["params"]["opacity_logit"] = torch.log(op) - torch.log1p(-op)
    for t in ("mu", "nu"):
        out[t]["opacity_logit"] = torch.zeros_like(op)
    return out


def event(state: dict, it: int, opt, extent: float, draw):
    """The densify event after the step of iteration `it` as the loop's
    cadence runs it (growth, clone → split → prune with `max_screen` 20
    after the first opacity reset, growth), then the opacity reset when
    `it` is on its interval.  `draw(P)` gives the event's noise at the
    capacity it runs at.  Returns (state, record): the alive count before
    and after, the counts, the capacity before and after.  TF32 is
    switched off, as for every reference (the event has no matmul)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cap0 = state["alive"].shape[0]
    n0 = int(state["alive"].sum())
    cap = grown(cap0, n0, opt.max_all_points)
    if cap is not None:
        state = grow(state, cap)
    max_screen = 20.0 if it > opt.opacity_reset_interval else None
    state, counts = densify_and_prune(state, draw(state["alive"].shape[0]),
                                      opt, extent, max_screen)
    n1 = int(state["alive"].sum())
    cap = grown(state["alive"].shape[0], n1, opt.max_all_points)
    if cap is not None:
        state = grow(state, cap)
    if it % opt.opacity_reset_interval == 0:
        state = reset_opacity(state)
    return state, dict(n_alive_before=n0, n_alive_after=n1,
                       capacity_before=cap0,
                       capacity=state["alive"].shape[0], **counts)
