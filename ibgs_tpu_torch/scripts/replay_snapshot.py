"""Replay a debug-mode snapshot and localise non-finite gradients
(counterpart of the JAX package's scripts/replay_snapshot.py): which loss
term, which parameter leaves, which Gaussian rows.

A snapshot (`snapshot_fw.npz`, written by either package's training loop
in debug mode; the keys agree) carries the poisoned step's inputs: the
pre-step parameters, the camera index into the deterministic synthetic
scene, the ground truth and the source pack with the evolved depth cache.
This rebuilds the render, takes the gradient of each loss term separately,
and reports the input health, per-leaf non-finite counts and the
offending rows' parameters.  On CUDA tensors the render goes through the
hand-written kernels; with `--device cpu` through their plain versions.

    python -m ibgs_tpu_torch.scripts.replay_snapshot run/snapshot_fw.npz \\
        [960x544] [--views 16] [--gt 150000] [--seed_pts 20000] \\
        [--cap 524288] [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ibgs_tpu_torch.core.sh import num_coeffs
from ibgs_tpu_torch.models.gaussians import (PARAM_FIELDS, GaussianModel,
                                             GaussianParams)
from ibgs_tpu_torch.ops.epilogue import SourceViews
from ibgs_tpu_torch.ops.rasterize import RasterConfig
from ibgs_tpu_torch.renderer import render_view
from ibgs_tpu_torch.train import losses

LEAVES = ("xyz", "sh_dc", "sh_rest", "log_scale", "quat", "opacity_logit",
          "normal", "offset")
TERMS = ("image", "normal", "photo")


def input_health(d) -> dict:
    """Per leaf: non-finite count, min and max over the alive rows (None
    when no element is finite)."""
    alive = np.asarray(d["alive"]).astype(bool)
    out = {}
    for name in ("xyz", "log_scale", "quat", "opacity_logit", "normal",
                 "offset", "sh_dc", "sh_rest"):
        a = np.asarray(d[name])[alive]
        ok = a.size and np.isfinite(a).any()
        out[name] = {"nonfinite": int((~np.isfinite(a)).sum()),
                     "min": float(np.nanmin(a)) if ok else None,
                     "max": float(np.nanmax(a)) if ok else None}
    return out


def replay(d, cam, device="cuda", cap: int = 1 << 19) -> dict:
    """Gradients of each loss term at the snapshot `d` (a dict of arrays)
    seen from `cam`.  Returns {"iter", "cam_idx", "input": input_health,
    "terms": {term: {"value", "leaves": {leaf: [count, rows]},
    "screen": {name: count}, "rows": offending row indices}}}."""
    dev = torch.device(device)

    def t(k):
        return torch.as_tensor(np.asarray(d[k], np.float32)).to(dev)

    it = int(d["iter"])
    alive = torch.as_tensor(np.asarray(d["alive"]).astype(bool)).to(dev)
    P = alive.shape[0]
    n_rest = np.asarray(d["sh_rest"]).shape[1]
    degree = next(k for k in range(4) if num_coeffs(k) - 1 == n_rest)
    base = GaussianModel(
        params=GaussianParams(**{k: t(k) for k in PARAM_FIELDS}),
        alive=alive, active_sh_degree=min(it // 1000, degree),
        max_sh_degree=degree)
    src = SourceViews(images=t("src_images"), depths=t("src_depths"),
                      ref_to_src=t("src_ref_to_src"), cam_pos=t("src_cam_pos"),
                      count=int(d["src_count"]))
    gt, bg = t("gt"), t("bg")
    rcfg = RasterConfig(instance_cap=cap, staircase_cull=True,
                        row_cap=cap // 2)

    def term(name, res, dnormal):
        if name == "image":
            return losses.dssim_l1(res.render, gt)
        if name == "normal":
            return losses.normal_consistency(res.normal, dnormal, 1.0)
        nb = 3
        warped = res.ibr.warped_image[:nb]
        valid = res.ibr.cam_feat[:nb].sum(-1) > 0.0
        return losses.multi_view_photometric(gt, warped, valid, 0.5, 0.3)

    report = {"iter": it, "cam_idx": int(d["cam_idx"]),
              "input": input_health(d), "terms": {}}
    for name in TERMS:
        leaves = GaussianParams(**{
            k: getattr(base.params, k).detach().clone().requires_grad_(True)
            for k in PARAM_FIELDS})
        sdum = torch.zeros(P, 2, device=dev, requires_grad=True)
        sdum_abs = torch.zeros(P, 2, device=dev, requires_grad=True)
        res, dnormal = render_view(
            dataclasses.replace(base, params=leaves), cam, rcfg, bg, src=src,
            learnt_normal=True, render_geo=True, return_depth_normal=True,
            screen_dummy=sdum, screen_dummy_abs=sdum_abs)
        val = term(name, res, dnormal)
        inputs = [getattr(leaves, k) for k in LEAVES] + [sdum, sdum_abs]
        grads = torch.autograd.grad(val, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        bad_rows = np.zeros((P,), bool)
        rec = {"value": float(val.detach()), "leaves": {}, "screen": {}}
        for ln, g in zip(LEAVES, grads[:len(LEAVES)]):
            nf = ~np.isfinite(g.detach().cpu().numpy())
            if nf.any():
                rows = nf.reshape(P, -1).any(-1)
                bad_rows |= rows
                rec["leaves"][ln] = [int(nf.sum()), int(rows.sum())]
        for gname, g in zip(("screen_dummy", "screen_dummy_abs"),
                            grads[len(LEAVES):]):
            nf = ~np.isfinite(g.detach().cpu().numpy())
            if nf.any():
                bad_rows |= nf.reshape(P, -1).any(-1)
                rec["screen"][gname] = int(nf.sum())
        rec["rows"] = np.nonzero(bad_rows)[0].tolist()
        report["terms"][name] = rec
    return report


def print_report(report, d):
    nf = int(d.get("nonfinite_grads", -1))
    print(f"snapshot: iter {report['iter']} cam {report['cam_idx']} "
          f"nonfinite_grads={nf}")
    for name, h in report["input"].items():
        if h["min"] is None:
            print(f"  in[{name}]: nonfinite {h['nonfinite']}  "
                  f"(no finite elements)")
        else:
            print(f"  in[{name}]: nonfinite {h['nonfinite']}  "
                  f"min {h['min']:.4g} max {h['max']:.4g}")
    for name, rec in report["terms"].items():
        print(f"term {name}: value {rec['value']:.6g}")
        for ln, (cnt, rows) in rec["leaves"].items():
            print(f"  grad[{ln}]: {cnt} non-finite in {rows} rows")
        for gname, cnt in rec["screen"].items():
            print(f"  grad[{gname}]: {cnt} non-finite")
        idx = rec["rows"]
        if idx:
            print(f"  offending rows ({len(idx)}): {idx[:10]}")
            for i in idx[:5]:
                print(f"    row {i}: alive={bool(d['alive'][i])} "
                      f"xyz={d['xyz'][i]} log_scale={d['log_scale'][i]} "
                      f"quat={d['quat'][i]} op={d['opacity_logit'][i]} "
                      f"normal={d['normal'][i]} offset={d['offset'][i]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="replay a debug snapshot")
    ap.add_argument("snapshot")
    ap.add_argument("size", nargs="?", default="960x544", help="WxH")
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--gt", type=int, default=150_000)
    ap.add_argument("--seed_pts", type=int, default=20_000)
    ap.add_argument("--cap", type=int, default=1 << 19)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the replay (default cuda)")
    args = ap.parse_args(argv)
    from ibgs_tpu_torch.data.synthetic import make_synthetic_scene

    d = dict(np.load(args.snapshot))
    W, H = (int(x) for x in args.size.split("x"))
    scene = make_synthetic_scene(n_views=args.views, width=W, height=H,
                                 n_gt=args.gt, n_seed=args.seed_pts,
                                 eval_every=8, device=args.device)
    report = replay(d, scene.train_cameras[int(d["cam_idx"])], args.device,
                    args.cap)
    print_report(report, d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
