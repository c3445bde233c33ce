"""Plane-based Gaussian rasterization (counterpart of
ibgs_tpu/ops/rasterize.py).

    preprocess → binning → pack_rows → blend (CUDA kernels on the card)
      → epilogue

The whole call is differentiable w.r.t. the Gaussian parameters: the
blend, `pack_rows` and the warp carry hand-written VJPs, everything else
is torch autograd.  As in the JAX package, zero-valued `screen_dummy` /
`screen_dummy_abs` inputs (P, 2) expose the per-Gaussian screen-space
gradient and its per-pixel absolute-value sum (the densification
statistics).  With `viewport_row0` / `viewport_rows` only the band of
rows [row0, row0 + rows) is rasterized, on a band-local tile grid: the
unit of the row-band sharding in parallel/.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from benchmark.reference.camera import Camera
from benchmark.reference import binning, blend, epilogue, preprocess
from benchmark.reference.blend_common import BlendConfig
from benchmark.reference.epilogue import IBROutputs, SourceViews
from benchmark.reference.precision import q


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
    # exact per-instance tile / ellipse cull in binning: retags instances
    # whose whole tile lies past the blend's alpha >= 1/255 gate (output-
    # and gradient-preserving; under GSP it also shrinks the exchange)
    exact_tile_cull: bool = False
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
    feats_inst: torch.Tensor   # (n, 15) per-instance table, columns FX..FAY
    Wp: int                    # padded, tile-aligned image size
    Hp: int
    row0: int = 0              # first image row of the band


def _band(sp: preprocess.Splats2D, row0: int, tiles_y: int, tile_h: int
          ) -> preprocess.Splats2D:
    """The splats' tile rects on the band-local grid that starts at image
    row `row0` (a multiple of tile_h).  Splats that preprocess culled stay
    culled: their rects are not meaningful, so n_tiles is gated by the
    original count."""
    ty0 = row0 // tile_h
    rmin_y = torch.clamp(sp.rect_min[:, 1] - ty0, 0, tiles_y)
    rmax_y = torch.clamp(sp.rect_max[:, 1] - ty0, 0, tiles_y)
    n_tiles = torch.where(
        sp.n_tiles > 0,
        (sp.rect_max[:, 0] - sp.rect_min[:, 0]) * (rmax_y - rmin_y), 0
    ).to(sp.n_tiles.dtype)
    return dataclasses.replace(
        sp, rect_min=torch.stack([sp.rect_min[:, 0], rmin_y], 1),
        rect_max=torch.stack([sp.rect_max[:, 0], rmax_y], 1),
        n_tiles=n_tiles,
        radius=torch.where(n_tiles > 0, sp.radius, 0).to(sp.radius.dtype))


def cull_table(sp: preprocess.Splats2D, row0: float = 0.0) -> torch.Tensor:
    """(P, 6) exact-cull table of `bin_splats`: mean (y in the coordinates
    of a grid starting at image row `row0`), conic and the ln(255·opacity)
    power threshold of the blend's alpha >= 1/255 gate.  Binning's outputs
    are integers, so no gradient flows here."""
    m2c, con = sp.mean2d.detach(), sp.conic.detach()
    thr = torch.log(torch.clamp(255.0 * sp.opacity.detach(), min=1.000001))
    return torch.stack([m2c[:, 0], m2c[:, 1] - float(row0), con[:, 0],
                        con[:, 1], con[:, 2], thr], dim=1)


def prepare(*, xyz, scale, quat, opacity, sh_coeffs, active_sh_degree,
            normal_world, plane_offset, cam: Camera, cfg: RasterConfig,
            alive: Optional[torch.Tensor] = None,
            rgb_override: Optional[torch.Tensor] = None,
            screen_dummy: Optional[torch.Tensor] = None,
            screen_dummy_abs: Optional[torch.Tensor] = None,
            viewport_row0: Optional[int] = None,
            viewport_rows: Optional[int] = None) -> Prepared:
    """Preprocess, bin and pack one view's instances, on the tile grid of
    the band [viewport_row0, viewport_row0 + viewport_rows) when given.
    `screen_dummy` is added to the screen means; `screen_dummy_abs`
    becomes columns FAX/FAY (zeros when absent)."""
    P = xyz.shape[0]
    for name, arr, trail in (("xyz", xyz, (3,)), ("scale", scale, (3,)),
                             ("quat", quat, (4,)), ("opacity", opacity, ()),
                             ("normal_world", normal_world, (3,)),
                             ("plane_offset", plane_offset, ()),
                             ("screen_dummy", screen_dummy, (2,)),
                             ("screen_dummy_abs", screen_dummy_abs, (2,))):
        if arr is None:
            continue
        if tuple(arr.shape) != (P,) + trail:
            raise ValueError(f"rasterize: {name} must have shape "
                             f"{(P,) + trail}, got {tuple(arr.shape)}")
    if (sh_coeffs is None) == (rgb_override is None):
        raise ValueError(
            "rasterize: provide exactly one of sh_coeffs or rgb_override")
    if sh_coeffs is not None and (
            sh_coeffs.ndim != 3 or sh_coeffs.shape[0] != P
            or sh_coeffs.shape[2] != 3):
        raise ValueError(
            f"rasterize: sh_coeffs must be (P, n_sh, 3), got "
            f"{tuple(sh_coeffs.shape)}")
    if rgb_override is not None and tuple(rgb_override.shape) != (P, 3):
        raise ValueError(
            f"rasterize: rgb_override must be (P, 3), got "
            f"{tuple(rgb_override.shape)}")

    band = viewport_rows is not None
    row0 = int(viewport_row0 or 0) if band else 0
    if band and (row0 % cfg.tile_h or row0 < 0):
        raise ValueError(f"rasterize: viewport_row0 {row0} is not a "
                         f"non-negative multiple of tile_h {cfg.tile_h}")
    Hp = _padded(viewport_rows if band else cam.height, cfg.tile_h)
    Wp = _padded(cam.width, cfg.tile_w)
    tiles_x = Wp // cfg.tile_w
    tiles_y = Hp // cfg.tile_h

    sp = preprocess.preprocess(
        xyz, scale, quat, opacity, sh_coeffs, active_sh_degree,
        normal_world, plane_offset, cam, cfg.tile_h, cfg.tile_w,
        alive=alive, rgb_override=rgb_override)
    if band:
        sp = _band(sp, row0, tiles_y, cfg.tile_h)
    cull_tab = None
    if cfg.exact_tile_cull or cfg.staircase_cull:
        cull_tab = cull_table(sp, row0)
    bins = binning.bin_splats(sp, tiles_x, tiles_y, cfg.instance_cap,
                              cull_tab=cull_tab, tile_h=cfg.tile_h,
                              tile_w=cfg.tile_w,
                              staircase=cfg.staircase_cull,
                              row_cap=cfg.row_cap or cfg.instance_cap // 2)

    mean2d = sp.mean2d if screen_dummy is None else sp.mean2d + screen_dummy
    if screen_dummy_abs is None:
        screen_dummy_abs = torch.zeros(P, 2, dtype=torch.float32,
                                       device=xyz.device)
    # one packed per-Gaussian table (columns FX..FAY) → one row gather
    feats_g = torch.cat([mean2d, sp.conic, sp.opacity[:, None], sp.rgb,
                         sp.plane_normal, sp.plane_dist[:, None],
                         screen_dummy_abs], dim=1)
    return Prepared(sp=sp, bins=bins,
                    feats_inst=q(binning.pack_rows(feats_g, bins)), Wp=Wp, Hp=Hp,
                    row0=row0)


def rasterize(*, xyz, scale, quat, opacity, sh_coeffs, active_sh_degree,
              normal_world, plane_offset, cam: Camera, bg: torch.Tensor,
              cfg: RasterConfig, src: Optional[SourceViews] = None,
              alive: Optional[torch.Tensor] = None, render_geo: bool = True,
              depth_only: bool = False,
              rgb_override: Optional[torch.Tensor] = None,
              screen_dummy: Optional[torch.Tensor] = None,
              screen_dummy_abs: Optional[torch.Tensor] = None,
              viewport_row0: Optional[int] = None,
              viewport_rows: Optional[int] = None) -> RenderResult:
    """Differentiable render of one view, or of its band of rows
    [viewport_row0, viewport_row0 + viewport_rows) (row0 a multiple of
    tile_h): then every image output is (viewport_rows, W, ...)."""
    pr = prepare(xyz=xyz, scale=scale, quat=quat, opacity=opacity,
                 sh_coeffs=sh_coeffs, active_sh_degree=active_sh_degree,
                 normal_world=normal_world, plane_offset=plane_offset,
                 cam=cam, cfg=cfg, alive=alive, rgb_override=rgb_override,
                 screen_dummy=screen_dummy,
                 screen_dummy_abs=screen_dummy_abs,
                 viewport_row0=viewport_row0, viewport_rows=viewport_rows)
    rows = cam.height if viewport_rows is None else viewport_rows
    bcfg = cfg.blend_cfg(render_geo, depth_only)
    out = blend.blend_packed(pr.feats_inst, pr.bins, pr.Wp, pr.Hp, cam.fx,
                             cam.fy, cam.cx, cam.cy, bcfg, row0=pr.row0
                             ).crop(rows, cam.width)
    out = dataclasses.replace(
        out, color=q(out.color), normal=q(out.normal),
        final_t=q(out.final_t), buf_depth=q(out.buf_depth),
        buf_weight=q(out.buf_weight))
    out_color = out.color + out.final_t[..., None] * bg

    ibr = None
    if depth_only:
        median = epilogue.median_depth_only(out)
    elif render_geo:
        if src is None:
            raise ValueError("rasterize: render_geo requires SourceViews")
        ibr = epilogue.ibr_epilogue(out, cam, src, cfg.depth_error_threshold,
                                    row0=pr.row0)
        median = ibr.median_depth
    else:
        median = torch.zeros_like(out.final_t)

    return RenderResult(
        render=out_color, radii=pr.sp.radius, final_t=out.final_t,
        n_contrib=out.n_contrib, normal=out.normal, median_depth=median,
        n_instances=pr.bins.n_instances, ibr=ibr, n_rows=pr.bins.n_rows)
