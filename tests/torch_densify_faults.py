"""Planted faults in the port's densify event, for the checks of the
density-control cell (`benchmark/drivers/densify.py`): each rewrites one
line of `models/gaussians.densify_and_prune` (the line must be there, or
`planted` raises) or the clone's copy, and `planted(name)` swaps the
faulty function in for the duration of a `with`.  Imported by basename
(as tests/torch_bundle_inputs.py is); no JAX.

* `flipped_threshold`: the clone takes the splats under the gradient
  threshold;
* `no_split_shrink`: split children keep their parent's scale;
* `prune_ignores_screen`: the prune skips the screen-radius test;
* `clone_keeps_moments`: a granted clone copies its source's Adam
  moments instead of starting from zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import textwrap

import torch

from ibgs_tpu_torch.models import gaussians

FAULTS = {
    "flipped_threshold": (
        "want_clone = alive & (g >= cfg.grad_threshold) & small",
        "want_clone = alive & (g < cfg.grad_threshold) & small"),
    "no_split_shrink": (
        "shrink = float(np.log(cfg.split_scale_shrink))",
        "shrink = 0.0"),
    "prune_ignores_screen": (
        "prune = prune | (model.max_radii2d > max_screen_size)\n", ""),
    "clone_keeps_moments": (
        "model = _scatter_from(model, clone_src, tgt, got)",
        "model = _scatter_keep_moments(model, clone_src, tgt, got)"),
}


def _scatter_keep_moments(model, src, target, granted):
    """_scatter_from, with each target's moments its source row's."""
    out = gaussians._scatter_from(model, src, target, granted)
    P = model.capacity
    src_of = torch.full((P + 1,), -1, dtype=torch.int64,
                        device=model.alive.device)
    src_of[torch.where(granted, target, P)] = torch.arange(
        P, device=model.alive.device)
    src_of = src_of[:P]
    hit, rows = src_of >= 0, src_of.clamp(min=0)

    def keep(new, old):
        return torch.where(hit.reshape((-1,) + (1,) * (new.dim() - 1)),
                           old[rows], new)

    return dataclasses.replace(
        out, mu=gaussians._map_params(keep, out.mu, model.mu),
        nu=gaussians._map_params(keep, out.nu, model.nu))


def faulty(name: str):
    """densify_and_prune with the fault `name` planted."""
    old, new = FAULTS[name]
    src = textwrap.dedent(inspect.getsource(gaussians.densify_and_prune))
    if old not in src:
        raise ValueError(f"fault {name}: {old!r} is not in densify_and_prune")
    ns = dict(vars(gaussians), _scatter_keep_moments=_scatter_keep_moments)
    exec(compile(src.replace(old, new), gaussians.__file__, "exec"), ns)
    return ns["densify_and_prune"]


@contextlib.contextmanager
def planted(name: str):
    keep = gaussians.densify_and_prune
    gaussians.densify_and_prune = faulty(name)
    try:
        yield
    finally:
        gaussians.densify_and_prune = keep
