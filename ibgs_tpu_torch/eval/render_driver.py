"""Evaluation rendering driver (counterpart of
ibgs_tpu/eval/render_driver.py).

`EvalRenderer.render_one` is the full test-time IBGS pipeline that the
reference's FPS benchmark times: a depth-only re-render of each source
view, the IBGS geometry render of the target view with the image-based
warp into the source views, and the colour-fusion net.  Around it:
`render_split` writes a split's renders, fused renders, ground truth,
depth and normal PNGs and measures its FPS; `dump_test_time_data` stores
the train images in the deployment's lossy format and reloads them as the
warp's sources, with the cameras' intrinsics and extrinsics;
`extract_tsdf_mesh` fuses the train views' median depths into a TSDF and
writes its mesh; `folder_size_mb` sizes the deployment.  Images are
written by `utils/image_io` (no cv2 or PIL needed for PNG).
"""
from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ibgs_tpu_torch.config import OptimizationParams
from ibgs_tpu_torch.core.camera import Camera
from ibgs_tpu_torch.models import aggregation
from ibgs_tpu_torch.models.gaussians import GaussianModel
from ibgs_tpu_torch.ops.rasterize import RasterConfig
from ibgs_tpu_torch.renderer import (render_depth_view, render_view,
                                     source_views_from_stacks)
from ibgs_tpu_torch.utils import image_io, profiling


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _save_png(path, img):
    """Write a float image in [0, 1] as 8 bits, truncated (not rounded);
    the extension picks the format."""
    arr = np.clip(_np(img), 0, 1)
    image_io.write_image(path, (arr * 255).astype(np.uint8))


def _colorize_depth(d):
    """Depth map → MAGMA colours in [0, 1] (float64), from the 2nd
    percentile of the positive depths (near, bright) to the maximum."""
    d = _np(d)
    lo, hi = np.percentile(d[d > 0], 2) if (d > 0).any() else 0, d.max() + 1e-9
    x = np.clip((d - lo) / (hi - lo + 1e-9), 0, 1)
    return image_io.MAGMA_RGB[(255 - x * 255).astype(np.uint8)] / 255.0


def folder_size_mb(path):
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total / 1e6


class EvalRenderer:
    """Test-time renderer over one model and its train views.

    images (N, H, W, 3), w2v (N, 4, 4) and centers (N, 3) are the train
    views' stacks; `train_cameras` are their N cameras.  `net` is the
    colour-fusion net with its weights, or None to skip fusion.
    `from_scene` builds one over a scene's train views and keeps the scene
    (`scene`), which the split, dump and mesh functions read."""

    def __init__(self, model: GaussianModel,
                 net: Optional[aggregation.ColorFusionResidualNet],
                 images: torch.Tensor, w2v: torch.Tensor,
                 centers: torch.Tensor, train_cameras: Sequence[Camera],
                 opt: OptimizationParams, rcfg: RasterConfig,
                 device="cuda"):
        self.device = torch.device(device)
        self.model = model
        self.net = net.to(self.device).eval() if net is not None else None
        self.train_cameras = list(train_cameras)
        self.opt = opt
        self.rcfg = rcfg
        self.H, self.W = images.shape[1:3]
        self.stacks = dict(images=images.to(self.device),
                           w2v=w2v.to(self.device),
                           centers=centers.to(self.device))
        self.scene = None
        self.served = 0         # views rendered by render_one

    @classmethod
    def from_scene(cls, model: GaussianModel,
                   net: Optional[aggregation.ColorFusionResidualNet],
                   scene, opt: OptimizationParams, rcfg: RasterConfig,
                   device="cuda") -> "EvalRenderer":
        """An EvalRenderer over `scene`'s train views (its cameras on
        `device`)."""
        w2v, centers, _ = scene.poses_stack()
        ev = cls(model, net, torch.as_tensor(scene.images), w2v, centers,
                 scene.train_cameras, opt, rcfg, device)
        ev.scene = scene
        return ev

    @torch.no_grad()
    def render_one(self, cam: Camera, nearest) -> dict:
        """Re-render the source depths, then render and fuse one view."""
        self.served += 1
        with profiling.annotate("render_one", self.served):
            with profiling.annotate("source_depths"):
                nbrs = list(nearest[: self.opt.number_src_frames])
                depths = [render_depth_view(self.model,
                                            self.train_cameras[i], self.rcfg,
                                            self.opt.learnt_normal)
                          for i in nbrs]
                S = self.rcfg.max_src
                idx = torch.zeros(S, dtype=torch.long)
                idx[: len(nbrs)] = torch.as_tensor(nbrs, dtype=torch.long)
                idx = idx.to(self.device)
                dstack = torch.stack(
                    depths + [torch.zeros(self.H, self.W, device=self.device)]
                    * (S - len(depths)))
                src = source_views_from_stacks(
                    self.stacks["images"][idx], dstack,
                    self.stacks["w2v"][idx], self.stacks["centers"][idx],
                    torch.arange(S, device=self.device), len(nbrs), cam)
            return self.render_with_sources(cam, src)

    @torch.no_grad()
    def render_with_sources(self, cam: Camera, src) -> dict:
        res, dnormal = render_view(
            self.model, cam, self.rcfg, torch.zeros(3, device=self.device),
            src=src, learnt_normal=self.opt.learnt_normal, render_geo=True,
            return_depth_normal=True)
        out = dict(render=res.render, depth=res.median_depth,
                   normal=res.normal, dnormal=dnormal,
                   ray=res.ibr.camera_ray, warped=res.ibr.warped_image,
                   n_instances=res.n_instances, n_rows=res.n_rows)
        if self.net is not None:
            fusion = aggregation.fuse_color(
                self.net, res.render, res.ibr.warped_image, res.ibr.cam_feat,
                res.ibr.camera_ray, res.ibr.min_depth_diff,
                res.ibr.use_first_src_mask, 1.0,
                self.opt.nb_visible_src_frames,
                self.opt.enable_exposure_correction,
                self.opt.residual_resolution_scale,
                self.opt.enable_mix_precision)
            out["aggregate"] = torch.where(fusion["any_valid"],
                                           fusion["image_pred"], res.render)
            out["residual"] = fusion["residual"]
        return out


def render_split(ev: EvalRenderer, cameras, gts, nearest_ids, out_dir,
                 measure_fps=False, fps_loops=5):
    """Render `cameras` (each with its nearest train ids) to PNGs under
    out_dir/{renders, renders_aggregate, gt, depth, normal}/NNNNN.png.
    With measure_fps, first time `fps_loops` passes over the split after
    one warm-up pass and return views per second (host clock, each pass
    ending in a device synchronise); else None."""
    os.makedirs(out_dir, exist_ok=True)
    for sub in ("renders", "renders_aggregate", "gt", "depth", "normal"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    fps = None
    if measure_fps and cameras:
        times = []
        for loop in range(fps_loops + 1):     # the first pass warms up
            t0 = time.time()
            for k, cam in enumerate(cameras):
                ev.render_one(cam, nearest_ids[k])
            if ev.device.type == "cuda":
                torch.cuda.synchronize(ev.device)
            if loop > 0:
                times.append(time.time() - t0)
        fps = len(cameras) / float(np.mean(times))

    for k, cam in enumerate(cameras):
        out = ev.render_one(cam, nearest_ids[k])
        name = f"{k:05d}.png"
        _save_png(os.path.join(out_dir, "renders", name), out["render"])
        if "aggregate" in out:
            _save_png(os.path.join(out_dir, "renders_aggregate", name),
                      out["aggregate"])
        _save_png(os.path.join(out_dir, "gt", name), gts[k])
        _save_png(os.path.join(out_dir, "depth", name),
                  _colorize_depth(out["depth"]))
        _save_png(os.path.join(out_dir, "normal", name),
                  (_np(out["normal"]) + 1) / 2)
    return fps


def filter_depth_by_view_angle(depth, dnormal, ray, max_angle_deg=80.0):
    """Zero the depths whose depth-derived normal is within
    90 - max_angle_deg degrees of perpendicular to the viewing ray:
    grazing surfaces give unreliable depths that corrupt the TSDF."""
    d = _np(depth)
    n = _np(dnormal)
    n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
    r = _np(ray)
    r = r / (np.linalg.norm(r, axis=-1, keepdims=True) + 1e-12)
    dot = np.abs((n * r).sum(-1))
    angle = np.arccos(np.clip(dot, -1.0, 1.0))
    return np.where(angle > np.deg2rad(max_angle_deg), 0.0, d)


def dump_test_time_data(ev: EvalRenderer, model_path, iteration,
                        ext="jpg"):
    """Store the test-time source data as a deployment would: the train
    images encoded as `ext` and reloaded into the warp's source stack (so
    evaluation sees the codec's artefacts), with per-view intrinsics
    (fx, fy, cx, cy) and extrinsics (axis-angle, translation) as .npy.
    Returns the dump directory, whose size counts in the memory metric.
    A JPEG `ext` needs PIL or cv2 (`utils/image_io`)."""
    from scipy.spatial.transform import Rotation

    misc_path = os.path.join(model_path, "test_time_data",
                             f"ours_{iteration}")
    os.makedirs(os.path.join(misc_path, "images"), exist_ok=True)
    scene = ev.scene
    imgs, intr, extr = [], [], []
    for k, cam in enumerate(scene.train_cameras):
        p = os.path.join(misc_path, "images", f"{k:05d}.{ext}")
        _save_png(p, scene.images[k])
        imgs.append(image_io.read_image(p).astype(np.float32) / 255.0)
        intr.append([float(cam.fx), float(cam.fy),
                     float(cam.cx), float(cam.cy)])
        w2c = _np(cam.view)[:3]
        rotvec = Rotation.from_matrix(w2c[:3, :3]).as_rotvec()
        extr.append(np.concatenate([rotvec, w2c[:3, 3]]).astype(np.float32))
    np.save(os.path.join(misc_path, "test_intrinsic.npy"),
            np.stack(intr).astype(np.float32))
    np.save(os.path.join(misc_path, "test_extrinsic.npy"), np.stack(extr))
    ev.stacks["images"] = torch.as_tensor(np.stack(imgs)).to(ev.device)
    return misc_path


def extract_tsdf_mesh(ev: EvalRenderer, out_path, voxel_size=0.01,
                      depth_trunc=None, use_depth_filter=False):
    """Integrate every train view's median depth into a TSDF over the seed
    cloud's bounds (widened by 20% of their extent on each side) and write
    its mesh, small clusters dropped, as a PLY.  The voxel is
    max(voxel_size, np.ptp(hi - lo) / 512), the JAX package's formula.
    Returns (verts, faces)."""
    from ibgs_tpu_torch.eval.tsdf import (TSDFVolume, post_process_mesh,
                                          save_mesh_ply)
    scene = ev.scene
    pts = scene.points
    lo = pts.min(0) - 0.2 * np.ptp(pts, 0)
    hi = pts.max(0) + 0.2 * np.ptp(pts, 0)
    vol = TSDFVolume(lo, hi, voxel_size=max(voxel_size,
                                            float(np.ptp(hi - lo)) / 512),
                     device=ev.device)
    for k, cam in enumerate(scene.train_cameras):
        out = ev.render_one(cam, scene.nearest_ids[k])
        depth = out["depth"]
        if use_depth_filter and out.get("dnormal") is not None:
            depth = filter_depth_by_view_angle(depth, out["dnormal"],
                                               out["ray"])
        K = np.array([[float(cam.fx), 0, float(cam.cx)],
                      [0, float(cam.fy), float(cam.cy)], [0, 0, 1]],
                     np.float32)
        vol.integrate(depth, ev.stacks["images"][k], K, cam.view)
    verts, faces = vol.extract_mesh()
    verts, faces = post_process_mesh(verts, faces)
    save_mesh_ply(out_path, verts, faces)
    return verts, faces
