"""View-level rendering orchestration (counterpart of ibgs_tpu/renderer.py):
camera-facing plane normals, source-view stacks, the rasterizer call and
screen-space depth normals."""
from __future__ import annotations

from typing import Optional

import torch

from ibgs_tpu_torch.core.camera import Camera
from ibgs_tpu_torch.models.gaussians import GaussianModel
from ibgs_tpu_torch.ops.epilogue import SourceViews
from ibgs_tpu_torch.ops.rasterize import RasterConfig, rasterize
from ibgs_tpu_torch.utils import profiling


def depth_to_normal(cam: Camera, depth: torch.Tensor) -> torch.Tensor:
    """Median depth map → camera-space normals by central differences
    (back-project through K^-1, cross(right-left, top-bottom), zero-padded
    border).  Returns (H, W, 3)."""
    pts = cam.rays_cam() * depth[..., None]
    l2r = pts[1:-1, 2:] - pts[1:-1, :-2]
    b2t = pts[:-2, 1:-1] - pts[2:, 1:-1]
    n = torch.linalg.cross(l2r, b2t)
    n = n * torch.rsqrt((n * n).sum(-1, keepdim=True) + 1e-20)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def source_views_from_stacks(image_stack: torch.Tensor,
                             depth_stack: torch.Tensor,
                             w2v_stack: torch.Tensor,
                             cam_pos_stack: torch.Tensor,
                             indices: torch.Tensor, count: int,
                             ref_cam: Camera) -> SourceViews:
    """Gather the per-view source pack; ref_to_src = W2V_src @ V2W_ref."""
    w2v = w2v_stack[indices]
    ref_v2w = torch.linalg.inv(ref_cam.view)
    return SourceViews(images=image_stack[indices],
                       depths=depth_stack[indices],
                       ref_to_src=w2v @ ref_v2w[None],
                       cam_pos=cam_pos_stack[indices], count=int(count))


def render_view(model: GaussianModel, cam: Camera, cfg: RasterConfig,
                bg: torch.Tensor, src: Optional[SourceViews] = None,
                learnt_normal: bool = True, render_geo: bool = True,
                depth_only: bool = False, return_depth_normal: bool = True,
                screen_dummy: Optional[torch.Tensor] = None,
                screen_dummy_abs: Optional[torch.Tensor] = None):
    """One differentiable render.  Returns (RenderResult, depth_normal |
    None)."""
    with profiling.annotate("render"):
        normal_w, offset = model.oriented_normal(cam.cam_pos,
                                                 learnt=learnt_normal)
        res = rasterize(
            xyz=model.params.xyz, scale=model.scale, quat=model.quat_unit,
            opacity=model.opacity, sh_coeffs=model.sh_coeffs,
            active_sh_degree=model.active_sh_degree, normal_world=normal_w,
            plane_offset=offset, cam=cam, bg=bg, cfg=cfg, src=src,
            alive=model.alive, render_geo=render_geo, depth_only=depth_only,
            screen_dummy=screen_dummy, screen_dummy_abs=screen_dummy_abs)
        dnormal = None
        if return_depth_normal and (render_geo or depth_only):
            dn = depth_to_normal(cam, res.median_depth)
            dnormal = dn * torch.rsqrt((dn * dn).sum(-1, keepdim=True)
                                       + 1e-16)
        return res, dnormal


def render_depth_view(model: GaussianModel, cam: Camera, cfg: RasterConfig,
                      learnt_normal: bool = True) -> torch.Tensor:
    """Depth-only pre-pass for source views."""
    res, _ = render_view(
        model, cam, cfg, bg=torch.zeros(3, device=cam.device), src=None,
        learnt_normal=learnt_normal, render_geo=False, depth_only=True,
        return_depth_normal=False)
    return res.median_depth


def apply_exposure(render: torch.Tensor, appear_ab: torch.Tensor,
                   cam_uid: int) -> torch.Tensor:
    """Per-camera affine exposure: exp(a)·render + b."""
    ab = appear_ab[cam_uid]
    return torch.exp(ab[0]) * render + ab[1]
