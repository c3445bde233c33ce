"""Serving entry point (counterpart of ibgs_tpu/eval/render_driver.py).

`EvalRenderer.render_one` is the full test-time IBGS pipeline that the
reference's FPS benchmark times: a depth-only re-render of each source
view, the IBGS geometry render of the target view with the image-based
warp into the source views, and the colour-fusion net.  PNG writing, TSDF
meshing and video belong to later slices.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ibgs_tpu_torch.config import OptimizationParams
from ibgs_tpu_torch.core.camera import Camera
from ibgs_tpu_torch.models import aggregation
from ibgs_tpu_torch.models.gaussians import GaussianModel
from ibgs_tpu_torch.ops.rasterize import RasterConfig
from ibgs_tpu_torch.renderer import (render_depth_view, render_view,
                                     source_views_from_stacks)


class EvalRenderer:
    """Test-time renderer over one model and its train views.

    images (N, H, W, 3), w2v (N, 4, 4) and centers (N, 3) are the train
    views' stacks; `train_cameras` are their N cameras.  `net` is the
    colour-fusion net with its weights, or None to skip fusion."""

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

    @torch.no_grad()
    def render_one(self, cam: Camera, nearest) -> dict:
        """Re-render the source depths, then render and fuse one view."""
        nbrs = list(nearest[: self.opt.number_src_frames])
        depths = [render_depth_view(self.model, self.train_cameras[i],
                                    self.rcfg, self.opt.learnt_normal)
                  for i in nbrs]
        S = self.rcfg.max_src
        idx = torch.zeros(S, dtype=torch.long)
        idx[: len(nbrs)] = torch.as_tensor(nbrs, dtype=torch.long)
        idx = idx.to(self.device)
        dstack = torch.stack(
            depths + [torch.zeros(self.H, self.W, device=self.device)]
            * (S - len(depths)))
        src = source_views_from_stacks(
            self.stacks["images"][idx], dstack, self.stacks["w2v"][idx],
            self.stacks["centers"][idx],
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
