"""Synthetic multi-view scene (counterpart of ibgs_tpu/data/synthetic.py).

A procedurally coloured wavy disc seen from a ring of cameras, with no
files on disk.  The ground-truth images are rendered by the port's own
rasterizer from a dense splat set (the plain blend on the CPU, the CUDA
forward on the card).  The numpy random calls are the JAX package's, in
the same order, so points, colours, seed indices and noise match its
scene exactly.  The ground truth is rendered with exact-size instance
lists; the JAX package caps its ground-truth render (`gt_instance_cap`,
by default the power of two above 12 instances per point, at least
2^15) and so drops the deepest splats where a view needs more, as at
960x544 with 150,000 points (3.3M instances against 2^21).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ibgs_tpu_torch.core.camera import look_at_camera
from ibgs_tpu_torch.core.sh import rgb_to_sh0
from ibgs_tpu_torch.data.dataset import (CameraInfo, SceneData,
                                         nearest_by_centre)
from ibgs_tpu_torch.ops.rasterize import RasterConfig, rasterize


def _gt_cloud(rng, n):
    """A colourful blobby surface: points on a wavy disc."""
    r = np.sqrt(rng.random(n)) * 1.1
    th = rng.random(n) * 2 * np.pi
    x, y = r * np.cos(th), r * np.sin(th)
    z = 0.25 * np.sin(3 * x) * np.cos(3 * y)
    pts = np.stack([x, y, z], -1)
    col = np.stack([(np.sin(4 * x) + 1) / 2, (np.cos(4 * y) + 1) / 2,
                    (np.sin(2 * (x + y)) + 1) / 2], -1)
    return pts.astype(np.float32), col.astype(np.float32)


@torch.no_grad()
def make_synthetic_scene(
    n_views: int = 12, width: int = 64, height: int = 64,
    n_gt: int = 1200, n_seed: int = 400, seed: int = 0,
    cam_radius: float = 3.0, eval_every: int = 6, device="cuda",
) -> SceneData:
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    pts, col = _gt_cloud(rng, n_gt)

    def rows(v):
        return torch.tensor([v], dtype=torch.float32, device=dev).repeat(
            n_gt, 1)

    gt_params = dict(
        xyz=torch.as_tensor(pts).to(dev),
        scale=torch.full((n_gt, 3), 0.05, device=dev),
        quat=rows([1.0, 0.0, 0.0, 0.0]),
        opacity=torch.full((n_gt,), 0.85, device=dev),
        sh_coeffs=rgb_to_sh0(torch.as_tensor(col).to(dev))[:, None, :],
        normal_world=rows([0.0, 0.0, 1.0]),
        plane_offset=torch.zeros(n_gt, device=dev),
    )
    cfg = RasterConfig()

    cams, infos, imgs = [], [], []
    for k in range(n_views):
        a = 2 * math.pi * k / n_views
        eye = [cam_radius * math.sin(a) * 0.45,
               cam_radius * math.cos(a) * 0.45, -cam_radius]
        cam = look_at_camera(eye, [0, 0, 0], [0, -1, 0], 0.8, 0.8,
                             width, height, dev)
        res = rasterize(**gt_params, active_sh_degree=0, cam=cam,
                        bg=torch.zeros(3, device=dev), cfg=cfg,
                        render_geo=False)
        cams.append(cam)
        imgs.append(res.render.cpu().numpy())
        view = cam.view.cpu().numpy()
        infos.append(CameraInfo(
            uid=k, R=view[:3, :3].T, T=view[:3, 3],
            fovx=0.8, fovy=0.8, width=width, height=height,
            image_path=f"synthetic_{k}", image_name=f"synthetic_{k}"))

    test_sel = [k for k in range(n_views) if k % eval_every == 0]
    train_sel = [k for k in range(n_views) if k % eval_every != 0]
    seed_idx = rng.choice(n_gt, size=min(n_seed, n_gt), replace=False)

    centers = np.stack([cams[k].cam_pos.cpu().numpy() for k in train_sel])

    return SceneData(
        train_cameras=[cams[k] for k in train_sel],
        test_cameras=[cams[k] for k in test_sel],
        train_infos=[infos[k] for k in train_sel],
        test_infos=[infos[k] for k in test_sel],
        images=np.stack([imgs[k] for k in train_sel]),
        test_images=np.stack([imgs[k] for k in test_sel]),
        points=pts[seed_idx] + rng.normal(
            0, 0.01, (len(seed_idx), 3)).astype(np.float32),
        colors=col[seed_idx],
        cameras_extent=float(cam_radius),
        nearest_ids=nearest_by_centre(centers),
        test_nearest_ids=[[0, 1] for _ in test_sel],
        white_background=False,
    )
