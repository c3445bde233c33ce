"""The numbers that decide `correct`, each the worst over its parts.

Training: `loss_gap`, the largest |program - reference| / |reference| of
the step's loss terms over the compared steps; `grad_gap`, the worst
leaf's gap between the program's and the reference's gradient norms (the
program's read back from its Adam state after one step, m / (1 - b1)),
over the larger of the reference's norm of that leaf and the median
leaf's; `step_gap`, the same for the norm of each leaf's change over the
compared steps.  Leaves whose reference gradient norm is under a
thousandth of the median leaf's move under Adam by round-off alone and
are left out of both (by that rule, not by name).

Serving: for each output, the relative L1 gap sum|p - r| / sum|r| over
the compared views, worst view; a non-finite value where the other side
is finite is a gap of inf.
"""
from __future__ import annotations

import math
import statistics

import torch

LOSS_TERMS = ("loss", "image_loss", "normal_loss", "photo_loss", "agg_loss")
B1 = 0.9


def leaf_norms(state, scale: float = 1.0, base=None) -> dict:
    """Norms of a train state's leaves: the Gaussian parameter fields, the
    exposure table and the net's parameters (by name).  With `base`
    (leaf → tensor) the norms of the differences from it."""
    out = {}
    m = state.model
    for k in base_fields(m):
        out[k] = getattr(m.params, k)
    out["app_ab"] = state.app_ab
    for name, p in state.net.named_parameters():
        out["net." + name] = p.detach()
    if base is not None:
        out = {k: v - base[k] for k, v in out.items()}
    return {k: torch.linalg.vector_norm(v.float()) * scale
            for k, v in out.items()}


def base_fields(model) -> tuple:
    import dataclasses
    return tuple(f.name for f in dataclasses.fields(model.params))


def grad_norms(state) -> dict:
    """The first step's gradient norms as the optimiser got them, from its
    first moments after one step: m = (1 - b1)·g."""
    m = state.model
    out = {k: torch.linalg.vector_norm(getattr(m.mu, k)) / (1 - B1)
           for k in base_fields(m)}
    out["app_ab"] = torch.linalg.vector_norm(state.app_opt.mu[0]) / (1 - B1)
    names = [n for n, _ in state.net.named_parameters()]
    for n, mu in zip(names, state.net_opt.mu):
        out["net." + n] = torch.linalg.vector_norm(mu) / (1 - B1)
    return out


def base_leaves(scene) -> dict:
    """The scene's initial leaves, keyed as `leaf_norms` keys them."""
    out = dict(scene.params)
    out["app_ab"] = scene.app_ab
    for k, v in scene.net.items():
        out["net." + k] = v
    return out


def floats(d: dict) -> dict:
    return {k: float(v) for k, v in d.items()}


def moved_leaves(ref_grads: dict) -> list:
    med = statistics.median(ref_grads.values())
    return sorted(k for k, v in ref_grads.items() if v >= 1e-3 * med)


def norm_gap(prog: dict, ref: dict, leaves: list):
    """(worst gap, its leaf) of |prog - ref| / max(ref, median ref)."""
    med = statistics.median(ref[k] for k in leaves)
    worst = (0.0, None)
    for k in leaves:
        p, r = prog[k], ref[k]
        gap = math.inf if not math.isfinite(p) else abs(p - r) / max(r, med)
        if gap > worst[0] or worst[1] is None:
            worst = (gap, k)
    return worst


def loss_gap(prog: list, ref: list):
    """prog, ref: per compared step, dicts of the loss terms."""
    worst = (0.0, None)
    for k, (p, r) in enumerate(zip(prog, ref)):
        for t in LOSS_TERMS:
            a, b = float(p[t]), float(r[t])
            gap = (math.inf if not math.isfinite(a)
                   else abs(a - b) / max(abs(b), 1e-12))
            if gap > worst[0] or worst[1] is None:
                worst = (gap, f"step{k + 1}.{t}")
    return worst


def rel_l1(p: torch.Tensor, r: torch.Tensor) -> float:
    p, r = p.float(), r.float()
    fp, fr = torch.isfinite(p), torch.isfinite(r)
    if bool((fp != fr).any()):
        return math.inf
    den = float(r[fr].abs().sum())
    num = float((p[fp] - r[fr]).abs().sum())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)
