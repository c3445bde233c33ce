"""Capture a converged-scene bench bundle (counterpart of the JAX package's
scripts/make_bench_bundle.py: the same keys, dtypes and layout).

A bundle freezes one training-step input at a trained model: the alive
Gaussian parameters, one train camera (pose + fov, so a reader can
rebuild it at any resolution), its ground truth, and the exact source
pack (images, the per-view median depth cache, relative transforms).

Two entry points:
  * `write_bundle(...)`: called in process by the training drivers
    (`scripts/train_runs.py`) with the model and the depth cache in hand;
  * CLI: `python -m ibgs_tpu_torch.scripts.make_bench_bundle <model_path>
    <out.npz> [--spec V W H GT SEED] [--device cuda]`: loads the newest
    (or `--iteration`) PLY snapshot, rebuilds the synthetic scene it was
    trained on, re-renders the source depth cache with the model, then
    writes the bundle.

Both packages read the result: `ibgs_tpu_torch.convert.bundle_scene` and
the JAX package's bench reader.  A failed write raises.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch

from ibgs_tpu_torch.models.gaussians import PARAM_FIELDS
from ibgs_tpu_torch.renderer import source_views_from_stacks


def write_bundle(path, model, scene, depths_stack, cam_idx, opt):
    """model: a GaussianModel; depths_stack: (N_train, H, W) median depth
    cache (the training loop's stacks["depths"]); cam_idx: the train view
    to freeze.  Returns the number of splats written."""
    cam = scene.train_cameras[cam_idx]
    view = cam.view.cpu().numpy()
    R = view[:3, :3].T
    t = view[:3, 3]
    fovx = 2.0 * math.atan(float(cam.tan_fovx))
    fovy = 2.0 * math.atan(float(cam.tan_fovy))

    w2v, centers, _ = scene.poses_stack()
    dev = w2v.device
    nbrs = list(scene.nearest_ids[cam_idx][: opt.number_src_frames])
    S = max(len(nbrs), 1)
    idx = np.zeros((S,), np.int64)
    idx[: len(nbrs)] = nbrs
    src = source_views_from_stacks(
        torch.as_tensor(np.asarray(scene.images)).to(dev),
        torch.as_tensor(depths_stack).to(dev), w2v, centers,
        torch.as_tensor(idx).to(dev), len(nbrs), cam)

    alive = model.alive.cpu().numpy()
    p = {k: getattr(model.params, k).detach().cpu().numpy()[alive]
         for k in PARAM_FIELDS}
    np.savez_compressed(
        path, **p,
        cam_R=R, cam_t=t, fovx=np.float64(fovx), fovy=np.float64(fovy),
        gt=np.asarray(scene.images[cam_idx], np.float32),
        src_images=src.images.cpu().numpy(),
        src_depths=src.depths.cpu().numpy(),
        src_ref_to_src=src.ref_to_src.cpu().numpy(),
        src_cam_pos=src.cam_pos.cpu().numpy(),
        src_count=np.asarray(src.count, np.int32),
    )
    n = int(alive.sum())
    print(f"bundle: {n} splats, cam {cam_idx}, {len(nbrs)} sources -> "
          f"{path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    return n


def build_parser():
    ap = argparse.ArgumentParser(description="ibgs_tpu_torch bench bundle")
    ap.add_argument("model_path")
    ap.add_argument("out")
    ap.add_argument("--spec", nargs=5, type=int,
                    default=[16, 960, 544, 150_000, 20_000],
                    metavar=("V", "W", "H", "GT", "SEED"),
                    help="synthetic scene spec the model was trained on")
    ap.add_argument("--cam_idx", type=int, default=0)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the renders (default cuda)")
    return ap


@torch.no_grad()
def main(argv=None):
    args = build_parser().parse_args(argv)
    from ibgs_tpu_torch.config import OptimizationParams
    from ibgs_tpu_torch.core import sh as shlib
    from ibgs_tpu_torch.data.ply import load_gaussian_ply
    from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    from ibgs_tpu_torch.render import model_from_ply
    from ibgs_tpu_torch.renderer import render_depth_view

    dev = torch.device(args.device)
    v, w, h, ngt, nseed = args.spec
    scene = make_synthetic_scene(n_views=v, width=w, height=h, n_gt=ngt,
                                 n_seed=nseed, eval_every=8, device=dev)

    pc_root = os.path.join(args.model_path, "point_cloud")
    it = args.iteration
    if it == -1:
        it = max(int(d.split("_")[-1]) for d in os.listdir(pc_root))
    ply = os.path.join(pc_root, f"iteration_{it}", "point_cloud.ply")
    n_rest = load_gaussian_ply(ply)["sh_rest"].shape[1]
    degree = next(d for d in range(4) if shlib.num_coeffs(d) - 1 == n_rest)
    model, _ = model_from_ply(ply, degree, device=dev)

    opt = OptimizationParams()
    rcfg = RasterConfig(staircase_cull=True)
    H, W = scene.images.shape[1:3]
    depths = torch.zeros(scene.n_train, H, W, device=dev)
    for ci in scene.nearest_ids[args.cam_idx][: opt.number_src_frames]:
        depths[ci] = render_depth_view(model, scene.train_cameras[ci], rcfg,
                                       learnt_normal=opt.learnt_normal)
    write_bundle(args.out, model, scene, depths, args.cam_idx, opt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
