"""Row-band rendering and training over a (dp, tp) mesh (counterpart of
ibgs_tpu/parallel/sharding.py).

One process per rank.  The mesh's first dim batches cameras (rank i of it
renders camera i of the step), its second cuts the image into row bands
(rank b renders rows [b·band, (b+1)·band) through `rasterize`'s viewport
band), so the depth sort and the blend stay local to a rank.  Gaussian
gradients are summed over both dims with `collectives.psum` (rank order,
the same sum on every rank) and divided by dp; each band's loss (its SSIM
window stays inside the band) is summed and divided by dp·tp.

`fsdp_train_step` shards the Gaussian parameters and Adam moments over
the whole mesh instead: each rank holds P / (dp·tp) rows, gathers the full
set for its render, reduce-scatters the gradients back to their owner and
updates its slice with Adam masked by the alive rows of the slice.
"""
from __future__ import annotations

import dataclasses

import torch

from ibgs_tpu_torch.core.camera import Camera
from ibgs_tpu_torch.models.gaussians import (PARAM_FIELDS, GaussianModel,
                                             GaussianParams, LRConfig,
                                             adam_step, lr_tree)
from ibgs_tpu_torch.ops.epilogue import SourceViews
from ibgs_tpu_torch.ops.rasterize import RasterConfig, rasterize
from ibgs_tpu_torch.parallel import collectives as C
from ibgs_tpu_torch.parallel import distributed
from ibgs_tpu_torch.train import losses

_CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos", "fx", "fy", "cx",
               "cy", "tan_fovx", "tan_fovy")


def make_mesh(dp: int, tp: int, device="cuda", axis_names=("dp", "tp")):
    """A (dp, tp) DeviceMesh over the process group (one rank each)."""
    return distributed.global_mesh(dp, tp, axis_names, device)


def _cam_stack(cams) -> dict:
    """The fields of a list of cameras stacked along a leading axis."""
    return {f: torch.stack([torch.as_tensor(getattr(c, f),
                                            dtype=torch.float32,
                                            device=c.device) for c in cams])
            for f in _CAM_FIELDS}


def _band_camera(cam_arrays: dict, width: int, height: int,
                 index: int = 0) -> Camera:
    """Camera `index` of a stack made by `_cam_stack`."""
    v = {f: cam_arrays[f][index] for f in _CAM_FIELDS}
    for f in ("fx", "fy", "cx", "cy", "tan_fovx", "tan_fovy"):
        v[f] = float(v[f])
    return Camera(width=width, height=height, **v)


def stack_sources(srcs) -> SourceViews:
    """One SourceViews with a leading axis from a list of them (`count`
    becomes a list of ints)."""
    return SourceViews(
        **{f: torch.stack([getattr(s, f) for s in srcs])
           for f in ("images", "depths", "ref_to_src", "cam_pos")},
        count=[int(s.count) for s in srcs])


def source_at(srcs: SourceViews, i: int) -> SourceViews:
    """Entry i of a stacked SourceViews."""
    return SourceViews(images=srcs.images[i], depths=srcs.depths[i],
                       ref_to_src=srcs.ref_to_src[i],
                       cam_pos=srcs.cam_pos[i], count=int(srcs.count[i]))


def _leaves(params: GaussianParams) -> GaussianParams:
    return GaussianParams(**{k: getattr(params, k).detach()
                             .requires_grad_(True) for k in PARAM_FIELDS})


def _grad_list(loss, inputs) -> list:
    """d loss / d input for each input (zeros where it does not depend)."""
    g = torch.autograd.grad(loss, inputs, allow_unused=True)
    return [torch.zeros_like(x) if gx is None else gx
            for x, gx in zip(inputs, g)]


def _grads(loss, leaves: GaussianParams) -> dict:
    return dict(zip(PARAM_FIELDS, _grad_list(
        loss, [getattr(leaves, k) for k in PARAM_FIELDS])))


def _band_loss(model: GaussianModel, params: GaussianParams, cam: Camera,
               rcfg: RasterConfig, src: SourceViews, gt_band, row0: int,
               rows: int):
    """The band objective of both steps: DSSIM + L1 of the band plus
    1e-4 · mean squared median depth."""
    m = dataclasses.replace(model, params=params)
    normal_w, offset = m.oriented_normal(cam.cam_pos, learnt=True)
    res = rasterize(
        xyz=params.xyz, scale=m.scale, quat=m.quat_unit, opacity=m.opacity,
        sh_coeffs=m.sh_coeffs, active_sh_degree=m.active_sh_degree,
        normal_world=normal_w, plane_offset=offset, cam=cam,
        bg=torch.zeros(3, device=params.xyz.device), cfg=rcfg, src=src,
        alive=m.alive, render_geo=True, viewport_row0=row0,
        viewport_rows=rows)
    return (losses.dssim_l1(res.render, gt_band)
            + 1e-4 * (res.median_depth ** 2).mean())


def _layout(mesh, height: int, tile_h: int):
    dp_ax, band_ax = mesh.mesh_dim_names
    n = C.axis_size(mesh, band_ax)
    if height % (n * tile_h):
        raise ValueError(f"height {height} does not split into {n} bands "
                         f"of whole {tile_h}-row tiles")
    band = height // n
    return (dp_ax, band_ax, C.axis_size(mesh, dp_ax), n, band,
            C.axis_index(mesh, dp_ax), C.axis_index(mesh, band_ax) * band)


def sharded_render(model: GaussianModel, cams, cfg: RasterConfig, bg,
                   mesh, learnt_normal=True) -> torch.Tensor:
    """Render len(cams) == dp views, each cut into tp row bands; returns
    the (dp, H, W, 3) images on every rank."""
    width, height = cams[0].width, cams[0].height
    _, _, dp, tp, band, i, row0 = _layout(mesh, height, cfg.tile_h)
    cam = cams[i]
    normal_w, offset = model.oriented_normal(cam.cam_pos,
                                             learnt=learnt_normal)
    res = rasterize(
        xyz=model.params.xyz, scale=model.scale, quat=model.quat_unit,
        opacity=model.opacity, sh_coeffs=model.sh_coeffs,
        active_sh_degree=model.active_sh_degree, normal_world=normal_w,
        plane_offset=offset, cam=cam, bg=bg, cfg=cfg, alive=model.alive,
        render_geo=False, viewport_row0=row0, viewport_rows=band)
    full = C.all_gather(res.render, mesh, tuple(mesh.mesh_dim_names))
    return full.reshape(dp, height, width, 3)


def sharded_train_step(opt_like, rcfg: RasterConfig, mesh, width: int,
                       height: int, lrcfg: LRConfig = LRConfig()):
    """step(model, cam_arrays, gts, srcs, iteration) -> (model, loss).

    The model is replicated (every rank passes the same one and gets the
    same update back); cam_arrays is `_cam_stack` of dp cameras, gts the
    (dp, H, W, 3) full frames, srcs a stacked SourceViews of dp packs
    (`stack_sources`).  `opt_like` is unused, as in the JAX package."""
    axes = tuple(mesh.mesh_dim_names)
    _, _, dp, tp, band, i, row0 = _layout(mesh, height, rcfg.tile_h)

    def step(model: GaussianModel, cam_arrays, gts, srcs, iteration: int):
        cam = _band_camera(cam_arrays, width, height, i)
        leaves = _leaves(model.params)
        loss = _band_loss(model, leaves, cam, rcfg, source_at(srcs, i),
                          gts[i, row0:row0 + band], row0, band)
        g = _grads(loss, leaves)
        loss = C.psum(loss.detach(), mesh, axes) / (dp * tp)
        grads = GaussianParams(**{k: C.psum(x, mesh, axes) / dp
                                  for k, x in g.items()})
        return adam_step(model, grads, lr_tree(lrcfg, iteration, 1.0)), loss

    return step


def shard_rows(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """This rank's tile of x's leading axis, over the ranks of `axes`."""
    n, k = C.axis_size(mesh, axes), C.axis_index(mesh, axes)
    per = x.shape[0] // n
    return x[k * per:(k + 1) * per]


def fsdp_train_step(opt_like, rcfg: RasterConfig, mesh, width: int,
                    height: int, lrcfg: LRConfig = LRConfig()):
    """step(model, cam_arrays, gts, srcs, iteration) -> (model, loss) with
    the parameters and Adam moments sharded over the whole mesh: the
    model's `params`, `mu` and `nu` hold this rank's P / (dp·tp) rows
    (`shard_rows` over every dim; rank r owns tile r), its `alive` all P.
    The full parameters are gathered for the render; the gradients are
    summed and scattered back to their owner (÷ dp), and Adam updates the
    slice with the slice's alive mask.  Returns the model with the new
    slices."""
    axes = tuple(mesh.mesh_dim_names)
    _, _, dp, tp, band, i, row0 = _layout(mesh, height, rcfg.tile_h)

    def step(model: GaussianModel, cam_arrays, gts, srcs, iteration: int):
        with torch.no_grad():
            full = GaussianParams(**{
                k: C.all_gather(getattr(model.params, k), mesh, axes)
                for k in PARAM_FIELDS})
        cam = _band_camera(cam_arrays, width, height, i)
        leaves = _leaves(full)
        loss = _band_loss(model, leaves, cam, rcfg, source_at(srcs, i),
                          gts[i, row0:row0 + band], row0, band)
        g = _grads(loss, leaves)
        loss = C.psum(loss.detach(), mesh, axes) / (dp * tp)
        g_shard = GaussianParams(**{k: C.psum_scatter(x, mesh, axes) / dp
                                    for k, x in g.items()})
        local = dataclasses.replace(
            model, alive=shard_rows(model.alive, mesh, axes))
        out = adam_step(local, g_shard, lr_tree(lrcfg, iteration, 1.0))
        return dataclasses.replace(out, alive=model.alive), loss

    return step
