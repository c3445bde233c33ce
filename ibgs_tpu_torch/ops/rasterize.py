"""Plane-based Gaussian rasterization, forward (counterpart of
ibgs_tpu/ops/rasterize.py).

    preprocess → binning → pack_rows → blend (CUDA kernel on the card)
      → epilogue

The viewport-band arguments of the JAX package's `rasterize` (row-band
sharding) belong to the parallel slice; the blend still takes `row0`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ibgs_tpu_torch.core.camera import Camera
from ibgs_tpu_torch.ops import binning, blend, epilogue, preprocess
from ibgs_tpu_torch.ops.blend_common import BlendConfig
from ibgs_tpu_torch.ops.epilogue import IBROutputs, SourceViews


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterizer configuration.

    The tile shape changes no output; 16x32 keeps binning integer-comparable
    with the JAX package's default.  `instance_cap` / `row_cap` of 0 size
    the instance and row lists exactly (the JAX package needs static caps;
    with a cap the port keeps its prefix-truncation semantics)."""
    tile_h: int = 16
    tile_w: int = 32
    instance_cap: int = 0
    buffer_len: int = 4
    max_src: int = 5
    depth_error_threshold: float = 0.01
    # staircase-interval expansion (output-preserving, fewer instances)
    staircase_cull: bool = False
    row_cap: int = 0

    def blend_cfg(self, render_geo: bool, depth_only: bool) -> BlendConfig:
        return BlendConfig(tile_h=self.tile_h, tile_w=self.tile_w,
                           buffer_len=self.buffer_len,
                           render_geo=render_geo, depth_only=depth_only)


@dataclasses.dataclass
class RenderResult:
    render: torch.Tensor           # (H, W, 3) composited colour (+bg)
    radii: torch.Tensor            # (P,) int32 screen radii (0 = culled)
    final_t: torch.Tensor          # (H, W)
    n_contrib: torch.Tensor        # (H, W) int32
    normal: torch.Tensor           # (H, W, 3) rendered plane normals
    median_depth: torch.Tensor     # (H, W)
    n_instances: int               # pre-truncation instance count
    ibr: Optional[IBROutputs]      # image-based outputs (render_geo only)
    n_rows: int = 0                # staircase rows (0 = AABB)


def _padded(size: int, tile: int) -> int:
    return -(-size // tile) * tile


def mark_visible(xyz: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(P,) bool frustum-culling mask: view-space depth > 0.2."""
    z = xyz @ cam.view[2, :3] + cam.view[2, 3]
    return z > 0.2


@dataclasses.dataclass
class Prepared:
    """Everything the blend of one view reads."""
    sp: preprocess.Splats2D
    bins: binning.TileBins
    feats_inst: torch.Tensor   # (n, 13) per-instance table, columns FX..FD
    Wp: int                    # padded, tile-aligned image size
    Hp: int


def prepare(*, xyz, scale, quat, opacity, sh_coeffs, active_sh_degree,
            normal_world, plane_offset, cam: Camera, cfg: RasterConfig,
            alive: Optional[torch.Tensor] = None,
            rgb_override: Optional[torch.Tensor] = None) -> Prepared:
    """Preprocess, bin and pack one view's instances."""
    P = xyz.shape[0]
    for name, arr, trail in (("xyz", xyz, (3,)), ("scale", scale, (3,)),
                             ("quat", quat, (4,)), ("opacity", opacity, ()),
                             ("normal_world", normal_world, (3,)),
                             ("plane_offset", plane_offset, ())):
        if tuple(arr.shape) != (P,) + trail:
            raise ValueError(f"rasterize: {name} must have shape "
                             f"{(P,) + trail}, got {tuple(arr.shape)}")
    if (sh_coeffs is None) == (rgb_override is None):
        raise ValueError(
            "rasterize: provide exactly one of sh_coeffs or rgb_override")

    Hp = _padded(cam.height, cfg.tile_h)
    Wp = _padded(cam.width, cfg.tile_w)
    tiles_x = Wp // cfg.tile_w
    tiles_y = Hp // cfg.tile_h

    sp = preprocess.preprocess(
        xyz, scale, quat, opacity, sh_coeffs, active_sh_degree,
        normal_world, plane_offset, cam, cfg.tile_h, cfg.tile_w,
        alive=alive, rgb_override=rgb_override)
    cull_tab = None
    if cfg.staircase_cull:
        # mean + conic + the ln(255*opacity) power threshold of the blend's
        # alpha >= 1/255 gate
        thr = torch.log(torch.clamp(255.0 * sp.opacity, min=1.000001))
        cull_tab = torch.stack(
            [sp.mean2d[:, 0], sp.mean2d[:, 1], sp.conic[:, 0],
             sp.conic[:, 1], sp.conic[:, 2], thr], dim=1)
    bins = binning.bin_splats(sp, tiles_x, tiles_y, cfg.instance_cap,
                              cull_tab=cull_tab, tile_h=cfg.tile_h,
                              tile_w=cfg.tile_w,
                              staircase=cfg.staircase_cull,
                              row_cap=cfg.row_cap or cfg.instance_cap // 2)

    # one packed per-Gaussian table (columns FX..FD) → one row gather
    feats_g = torch.cat([sp.mean2d, sp.conic, sp.opacity[:, None], sp.rgb,
                         sp.plane_normal, sp.plane_dist[:, None]], dim=1)
    return Prepared(sp=sp, bins=bins,
                    feats_inst=binning.pack_rows(feats_g, bins), Wp=Wp, Hp=Hp)


def rasterize(*, xyz, scale, quat, opacity, sh_coeffs, active_sh_degree,
              normal_world, plane_offset, cam: Camera, bg: torch.Tensor,
              cfg: RasterConfig, src: Optional[SourceViews] = None,
              alive: Optional[torch.Tensor] = None, render_geo: bool = True,
              depth_only: bool = False,
              rgb_override: Optional[torch.Tensor] = None) -> RenderResult:
    """Forward render of one view (no autograd: the blend backward belongs
    to the training slice)."""
    pr = prepare(xyz=xyz, scale=scale, quat=quat, opacity=opacity,
                 sh_coeffs=sh_coeffs, active_sh_degree=active_sh_degree,
                 normal_world=normal_world, plane_offset=plane_offset,
                 cam=cam, cfg=cfg, alive=alive, rgb_override=rgb_override)
    bcfg = cfg.blend_cfg(render_geo, depth_only)
    out = blend.blend_packed(pr.feats_inst, pr.bins, pr.Wp, pr.Hp, cam.fx,
                             cam.fy, cam.cx, cam.cy, bcfg
                             ).crop(cam.height, cam.width)
    out_color = out.color + out.final_t[..., None] * bg

    ibr = None
    if depth_only:
        median = epilogue.median_depth_only(out)
    elif render_geo:
        if src is None:
            raise ValueError("rasterize: render_geo requires SourceViews")
        ibr = epilogue.ibr_epilogue(out, cam, src, cfg.depth_error_threshold)
        median = ibr.median_depth
    else:
        median = torch.zeros_like(out.final_t)

    return RenderResult(
        render=out_color, radii=pr.sp.radius, final_t=out.final_t,
        n_contrib=out.n_contrib, normal=out.normal, median_depth=median,
        n_instances=pr.bins.n_instances, ibr=ibr, n_rows=pr.bins.n_rows)
