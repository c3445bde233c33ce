"""Checkpoints (counterpart of ibgs_tpu/train/checkpoint.py).

* `point_cloud/iteration_N/point_cloud.ply`: the alive Gaussians as a PLY
  (data/ply.py), the same bytes as the JAX package writes;
* `chkpnt<N>.npz`: the whole training state under named keys
  (`params.<field>`, `mu.<field>`, `nu.<field>`, `step`, `alive`, the five
  statistics, `active_sh_degree`, `max_sh_degree`, `app_ab`,
  `app_opt.{mu,nu}.<i>`, `app_opt.step`, `net.<state_dict key>`,
  `net_opt.{mu,nu}.<i>` in `net.parameters()` order, `net_opt.step`,
  `spatial_lr_scale`, `__iteration`), written compressed as the JAX
  package writes its own (`np.savez_compressed`); `load_state` reads
  compressed and uncompressed files.  A save and a load give back every
  tensor bit for bit.  `load_state` also reads a JAX
  package checkpoint (positional `leaf_i` keys) through
  `ibgs_tpu_torch.convert.train_state_from_jax_checkpoint`, so a JAX run
  resumes in the port (`--start_checkpoint`).
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ibgs_tpu_torch.data import ply
from ibgs_tpu_torch.models.gaussians import (PARAM_FIELDS, STAT_FIELDS,
                                             GaussianModel, GaussianParams)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_ply_snapshot(model: GaussianModel, path: str):
    """The alive rows of the model as a PLY."""
    alive = _np(model.alive)
    p = {k: _np(getattr(model.params, k))[alive] for k in PARAM_FIELDS}
    ply.save_gaussian_ply(path, p["xyz"], p["normal"], p["offset"],
                          p["sh_dc"], p["sh_rest"], p["opacity_logit"],
                          p["log_scale"], p["quat"])


def _side_arrays(prefix: str, opt) -> dict:
    out = {f"{prefix}.step": np.int64(opt.step)}
    for i, (m, v) in enumerate(zip(opt.mu, opt.nu)):
        out[f"{prefix}.mu.{i}"] = _np(m)
        out[f"{prefix}.nu.{i}"] = _np(v)
    return out


def state_arrays(state) -> dict:
    """The named numpy arrays of a TrainState (the checkpoint's keys)."""
    m = state.model
    out = {}
    for tree in ("params", "mu", "nu"):
        for k in PARAM_FIELDS:
            out[f"{tree}.{k}"] = _np(getattr(getattr(m, tree), k))
    out["step"] = np.int64(m.step)
    out["alive"] = _np(m.alive)
    for k in STAT_FIELDS:
        out[k] = _np(getattr(m, k))
    out["active_sh_degree"] = np.int64(m.active_sh_degree)
    out["max_sh_degree"] = np.int64(m.max_sh_degree)
    out["app_ab"] = _np(state.app_ab)
    out.update(_side_arrays("app_opt", state.app_opt))
    if state.net is not None:
        for name, t in state.net.state_dict().items():
            out[f"net.{name}"] = _np(t)
        out.update(_side_arrays("net_opt", state.net_opt))
    out["spatial_lr_scale"] = np.float64(state.spatial_lr_scale)
    return out


def save_state(state, iteration: int, path: str):
    np.savez_compressed(path, __iteration=np.int64(iteration),
                        **state_arrays(state))


def load_state(template, path: str):
    """(TrainState, iteration) from `path`, on the device of `template`'s
    model; a fusion net is a fresh copy of `template.net` holding the
    saved weights.  The template is left as it is.  A JAX package
    checkpoint (positional `leaf_i` keys) is read through
    `convert.train_state_from_jax_checkpoint`, so a JAX run resumes here."""
    from ibgs_tpu_torch.train.trainer import SideOptState

    dev = template.model.alive.device
    with np.load(path) as data:
        if "leaf_0" in data.files:
            from ibgs_tpu_torch.convert import train_state_from_jax_checkpoint
            return train_state_from_jax_checkpoint(path, template.net, dev)
        d = {k: data[k] for k in data.files}

    def t(key):
        return torch.from_numpy(d[key]).to(dev)

    def side(prefix, n):
        return SideOptState(mu=[t(f"{prefix}.mu.{i}") for i in range(n)],
                            nu=[t(f"{prefix}.nu.{i}") for i in range(n)],
                            step=int(d[f"{prefix}.step"]))

    model = GaussianModel(
        params=GaussianParams(**{k: t(f"params.{k}") for k in PARAM_FIELDS}),
        alive=t("alive"), active_sh_degree=int(d["active_sh_degree"]),
        max_sh_degree=int(d["max_sh_degree"]),
        mu=GaussianParams(**{k: t(f"mu.{k}") for k in PARAM_FIELDS}),
        nu=GaussianParams(**{k: t(f"nu.{k}") for k in PARAM_FIELDS}),
        step=int(d["step"]), **{k: t(k) for k in STAT_FIELDS})
    net, net_opt = None, None
    if template.net is not None:
        net = copy.deepcopy(template.net)
        net.load_state_dict({name: t(f"net.{name}")
                             for name in net.state_dict()})
        net_opt = side("net_opt", len(list(net.parameters())))
    state = dataclasses.replace(
        template, model=model, app_ab=t("app_ab"),
        app_opt=side("app_opt", 1), net=net, net_opt=net_opt,
        spatial_lr_scale=float(d["spatial_lr_scale"]))
    return state, int(d["__iteration"])
