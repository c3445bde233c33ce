"""Gaussian-sharded rendering and training: the instance exchange
(counterpart of ibgs_tpu/parallel/gsp.py).

Mesh ("dp", "gs"), one process per rank.  The dp dim replicates over
cameras; the gs dim shards both the Gaussians (each rank owns P/n rows)
and the image (each rank owns one band of rows).  Per rank:

  1. preprocess its own P/n Gaussians for its dp row's camera;
  2. bin them over the FULL tile grid (the exact / staircase cull in
     image coordinates, so culled instances never travel);
  3. route every instance to the rank that owns its tile's band with one
     `all_to_all` over gs: per-destination runs of at most `exchange_cap`
     rows (prefix truncation, the dropped rows counted in `n_overflow`);
  4. merge what arrives by (local tile, depth) with stable sorts, and
     blend the band with the CUDA kernels (`row0` = the band's first row);
  5. the gradients go back through the permutation, the all_to_all (its
     own transpose) and the row routing to the owning rank's Gaussians, so
     only the dp replicas sum.

Row routing and the merge permutation are autograd Functions whose
backward is a row gather, never a scatter-add.  With one band and nothing
to drop the exchange is the identity and is skipped (the fast path); the
generic path gives bit-identical outputs and gradients there.

Capacities: `cap_local` caps the local instance list as
`RasterConfig.instance_cap` does, `exchange_cap` the rows one rank sends
to one band; 0 means no cap (the exchange then sends, per step, the
largest run any rank has, so nothing is dropped).

A rank holds its shard as a GaussianModel of P/n rows (`shard_model`);
`gather_model` puts the full model together in shard order, and
`gsp_interleave` deals a full model's rows round-robin so that alive rows
and free slots spread evenly over the shards.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ibgs_tpu_torch.core.camera import Camera
from ibgs_tpu_torch.models import gaussians
from ibgs_tpu_torch.models.gaussians import (PARAM_FIELDS, GaussianModel,
                                             GaussianParams, LRConfig,
                                             accumulate_stats, adam_step,
                                             lr_tree)
from ibgs_tpu_torch.ops import binning, blend, preprocess
from ibgs_tpu_torch.ops.epilogue import IBROutputs, ibr_epilogue
from ibgs_tpu_torch.ops.rasterize import RasterConfig, cull_table
from ibgs_tpu_torch.parallel import collectives as C
from ibgs_tpu_torch.parallel.sharding import (_band_camera, _grad_list,
                                              _leaves, source_at)
from ibgs_tpu_torch.train import losses
from ibgs_tpu_torch.utils import profiling

# per-Gaussian (leading-P) fields of GaussianModel, sharded over gs
_SHARD_FIELDS = ("params", "mu", "nu", "alive", "max_radii2d", "grad_accum",
                 "grad_accum_abs", "denom", "denom_abs")
_TREES = ("params", "mu", "nu")


@dataclasses.dataclass
class _Bins:
    tile_start: torch.Tensor
    tile_stop: torch.Tensor


def _map_shard_fields(model: GaussianModel, fn) -> GaussianModel:
    """The model with fn applied to every per-Gaussian array."""
    out = {}
    for f in _SHARD_FIELDS:
        v = getattr(model, f)
        if v is None:
            continue
        out[f] = (GaussianParams(**{k: fn(getattr(v, k))
                                    for k in PARAM_FIELDS})
                  if f in _TREES else fn(v))
    return dataclasses.replace(model, **out)


class _RouteRows(torch.autograd.Function):
    """Send-buffer assembly as a row gather with a row-gather backward:
    slot s takes instance src_of_slot[s] (zero where not slot_valid), and
    each kept instance fills exactly one slot (slot_of_src), so the
    backward gathers its slot's cotangent."""

    @staticmethod
    def forward(ctx, feats, src_of_slot, slot_of_src, slot_valid, src_kept):
        ctx.save_for_backward(slot_of_src, slot_valid, src_kept)
        n = feats.shape[0]
        padded = torch.cat([feats, feats.new_zeros(1, feats.shape[1])])
        return padded[torch.where(slot_valid, src_of_slot, n)]

    @staticmethod
    def backward(ctx, g):
        slot_of_src, slot_valid, src_kept = ctx.saved_tensors
        g = torch.where(slot_valid[:, None], g, 0.0)
        d = g[torch.clamp(slot_of_src, 0, g.shape[0] - 1)]
        return torch.where(src_kept[:, None], d, 0.0), None, None, None, None


class _PermuteRows(torch.autograd.Function):
    """x[perm]; the backward gathers by the inverse permutation."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return g[inv_perm], None, None


def _pack_feats(sp: preprocess.Splats2D, screen_dummy_abs=None
                ) -> torch.Tensor:
    """(P, 16) per-Gaussian rows in the blend's column layout FX..FAY;
    column 15 carries the view depth, the merge key (no gradient; the
    blend does not read it)."""
    if screen_dummy_abs is None:
        screen_dummy_abs = sp.mean2d.new_zeros(sp.mean2d.shape[0], 2)
    return torch.cat([sp.mean2d, sp.conic, sp.opacity[:, None], sp.rgb,
                      sp.plane_normal, sp.plane_dist[:, None],
                      screen_dummy_abs, sp.depth.detach()[:, None]], dim=1)


def _exact_capacity(seg_start: torch.Tensor, mesh, axis: str) -> int:
    """The longest per-destination run of any rank of `axis`."""
    longest = (seg_start[1:] - seg_start[:-1]).max().reshape(1)
    return max(int(C.all_gather(longest, mesh, axis).max()), 1)


def exchange_and_blend(params_view: dict, cam: Camera, rcfg: RasterConfig,
                       mesh, cap_local: int, exchange_cap: int,
                       axis: str = "gs", bg=None, src=None,
                       render_geo: bool = True):
    """Steps 1-4 on this rank.  `params_view` holds the rank's per-Gaussian
    arrays: xyz, scale, quat, opacity, sh_coeffs, active_sh_degree,
    normal_world, plane_offset, alive, and optionally screen_dummy /
    screen_dummy_abs (P_loc, 2).

    Returns (render (band, W, 3), BlendOutputs of the band, IBROutputs of
    the band or None, extras) with extras = {"n_overflow": () int64 rows
    the exchange cap dropped, "radius": (P_loc,) int32 screen radii,
    "n_instances": the local pre-truncation instance count}."""
    n_bands, band_index = C.axis_size(mesh, axis), C.axis_index(mesh, axis)
    tile_h, tile_w = rcfg.tile_h, rcfg.tile_w
    Wp = -(-cam.width // tile_w) * tile_w
    tiles_x = Wp // tile_w
    if cam.height % (n_bands * tile_h):
        raise ValueError(f"height {cam.height} does not split into "
                         f"{n_bands} bands of whole {tile_h}-row tiles")
    band = cam.height // n_bands
    band_ty = band // tile_h
    tpb = tiles_x * band_ty                      # tiles per band
    num_tiles = tpb * n_bands
    row0 = band_index * band

    # 1-2. local preprocess, binning over the full tile grid
    pv = params_view
    sp = preprocess.preprocess(
        pv["xyz"], pv["scale"], pv["quat"], pv["opacity"], pv["sh_coeffs"],
        pv["active_sh_degree"], pv["normal_world"], pv["plane_offset"], cam,
        tile_h, tile_w, alive=pv.get("alive"))
    cull_tab = (cull_table(sp) if rcfg.exact_tile_cull or rcfg.staircase_cull
                else None)
    bins = binning.bin_splats(sp, tiles_x, band_ty * n_bands, cap_local,
                              cull_tab=cull_tab, tile_h=tile_h, tile_w=tile_w,
                              staircase=rcfg.staircase_cull,
                              row_cap=rcfg.row_cap or cap_local // 2)
    feats_g = _pack_feats(sp, pv.get("screen_dummy_abs"))
    if pv.get("screen_dummy") is not None:
        feats_g = torch.cat([feats_g[:, :2] + pv["screen_dummy"],
                             feats_g[:, 2:]], dim=1)
    feats_inst = binning.pack_rows(feats_g, bins)
    dev = feats_inst.device

    nothing_drops = exchange_cap == 0 or (0 < cap_local <= exchange_cap)
    if n_bands == 1 and nothing_drops:
        # one band owns every tile and no run can be cut: the exchange is
        # the identity (binning already orders instances by tile, then
        # depth, culled rows last)
        n_overflow = torch.zeros((), dtype=torch.int64, device=dev)
        feats_band = feats_inst
        start, stop = bins.tile_start, bins.tile_stop
    else:
        # 3. each destination's instances are one contiguous run of the
        # tile-sorted list; slot (b, q) of the send buffer is instance
        # seg_start[b] + q
        n = feats_inst.shape[0]
        tile = bins.tile_id
        dest = tile // tpb                        # culled rows → n_bands
        seg_start = torch.searchsorted(
            tile, torch.arange(n_bands + 1, device=dev) * tpb)
        cap_e = exchange_cap or _exact_capacity(seg_start, mesh, axis)
        local_pos = (torch.arange(n, device=dev)
                     - seg_start[torch.clamp(dest, max=n_bands)])
        keep = bins.inst_valid & (local_pos < cap_e) & (dest < n_bands)
        n_overflow = (bins.inst_valid & ~keep).sum()
        slots = torch.arange(n_bands * cap_e, device=dev)
        slot_b, slot_q = slots // cap_e, slots % cap_e
        src_of_slot = seg_start[slot_b] + slot_q
        slot_valid = slot_q < (seg_start[slot_b + 1] - seg_start[slot_b])
        slot_of_src = dest * cap_e + local_pos
        sendf = _RouteRows.apply(feats_inst, src_of_slot, slot_of_src,
                                 slot_valid, keep)
        tile_pad = torch.cat([tile, tile.new_full((1,), num_tiles)])
        sendt = torch.where(
            slot_valid,
            tile_pad[torch.where(slot_valid, src_of_slot, n)] - slot_b * tpb,
            tpb)
        recvf = C.all_to_all(sendf, mesh, axis)
        recvt = C.all_to_all(sendt, mesh, axis)

        # 4. merge by (local tile, depth), arrival order breaking ties: a
        # stable sort by depth, then a stable sort by tile
        depth_key = torch.where(recvt < tpb, recvf[:, 15].detach(),
                                float("inf"))
        by_depth = torch.sort(depth_key, stable=True).indices
        perm = by_depth[torch.sort(recvt[by_depth], stable=True).indices]
        inv_perm = torch.empty_like(perm)
        inv_perm[perm] = torch.arange(perm.shape[0], device=dev)
        feats_band = _PermuteRows.apply(recvf, perm, inv_perm)
        sortt = recvt[perm]
        start, stop = binning.tile_ranges_from_sorted(
            sortt, tpb, (sortt < tpb).sum())

    bcfg = rcfg.blend_cfg(render_geo, False)
    out = blend.blend_packed(feats_band, _Bins(start, stop), Wp,
                             band_ty * tile_h, cam.fx, cam.fy, cam.cx,
                             cam.cy, bcfg, row0=row0).crop(band, cam.width)
    if bg is None:
        bg = torch.zeros(3, device=dev)
    render = out.color + out.final_t[..., None] * bg
    ibr = None
    if render_geo and src is not None:
        ibr = ibr_epilogue(out, cam, src, rcfg.depth_error_threshold,
                           row0=row0)
    extras = {"n_overflow": n_overflow, "radius": sp.radius,
              "n_instances": bins.n_instances}
    return render, out, ibr, extras


def _local_view(model_like: GaussianModel, p_loc: GaussianParams,
                alive_loc: torch.Tensor, cam_pos, learnt=True) -> dict:
    """Shard-local activations from shard-local raw parameters."""
    m = dataclasses.replace(model_like, params=p_loc, alive=alive_loc)
    normal_w, offset = m.oriented_normal(cam_pos, learnt=learnt)
    return {"xyz": p_loc.xyz, "scale": m.scale, "quat": m.quat_unit,
            "opacity": m.opacity, "sh_coeffs": m.sh_coeffs,
            "active_sh_degree": model_like.active_sh_degree,
            "normal_world": normal_w, "plane_offset": offset,
            "alive": alive_loc}


def shard_model(model: GaussianModel, mesh, axis: str = "gs"
                ) -> GaussianModel:
    """This rank's block of a full model's per-Gaussian arrays (rank k of
    `axis` owns rows [k·P/n, (k+1)·P/n))."""
    n, k = C.axis_size(mesh, axis), C.axis_index(mesh, axis)
    if model.capacity % n:
        raise ValueError(f"capacity {model.capacity} over {n} shards")
    per = model.capacity // n
    return _map_shard_fields(model, lambda x: x[k * per:(k + 1) * per])


def gather_model(model_loc: GaussianModel, mesh, axis: str = "gs"
                 ) -> GaussianModel:
    """The full model from every rank's shard, in shard order, on every
    rank of `axis` (a collective: every rank calls it)."""
    def gat(x):
        if x.dtype == torch.bool:
            return C.all_gather(x.to(torch.uint8), mesh, axis).bool()
        return C.all_gather(x.detach(), mesh, axis)

    with torch.no_grad():
        return _map_shard_fields(model_loc, gat)


def gsp_train_step(rcfg: RasterConfig, mesh, width: int, height: int,
                   cap_local: int, exchange_cap: int,
                   lrcfg: LRConfig = LRConfig()):
    """step(model_loc, cam_arrays, gts, srcs, iteration) -> (model_loc,
    loss, n_overflow) with Gaussian-axis compute sharding: `model_loc` is
    this rank's shard (`shard_model`) with its Adam moments; cam_arrays,
    gts (dp, H, W, 3) and the stacked srcs cover the dp cameras.  The
    band objective of sharding.sharded_train_step; the gradients of a
    shard are summed over dp only."""
    dp_ax, gs_ax = mesh.mesh_dim_names
    dp, n = C.axis_size(mesh, dp_ax), C.axis_size(mesh, gs_ax)
    i = C.axis_index(mesh, dp_ax)
    if height % (n * rcfg.tile_h):
        raise ValueError(f"height {height} does not split into {n} bands")
    band = height // n
    row0 = C.axis_index(mesh, gs_ax) * band

    def step(model_loc: GaussianModel, cam_arrays, gts, srcs,
             iteration: int):
        cam = _band_camera(cam_arrays, width, height, i)
        leaves = _leaves(model_loc.params)
        view = _local_view(model_loc, leaves, model_loc.alive, cam.cam_pos)
        render, _, ibr, extras = exchange_and_blend(
            view, cam, rcfg, mesh, cap_local, exchange_cap, axis=gs_ax,
            bg=torch.zeros(3, device=leaves.xyz.device),
            src=source_at(srcs, i), render_geo=True)
        loss = (losses.dssim_l1(render, gts[i, row0:row0 + band])
                + 1e-4 * (ibr.median_depth ** 2).mean())
        g = _grad_list(loss, [getattr(leaves, k) for k in PARAM_FIELDS])
        axes = (dp_ax, gs_ax)
        loss = C.psum(loss.detach(), mesh, axes) / (dp * n)
        n_ovf = C.psum(extras["n_overflow"], mesh, axes)
        grads = GaussianParams(**{k: C.psum(x, mesh, dp_ax) / dp
                                  for k, x in zip(PARAM_FIELDS, g)})
        model_loc = adam_step(model_loc, grads,
                              lr_tree(lrcfg, iteration, 1.0))
        return model_loc, loss, n_ovf

    return step


# float IBROutputs fields gathered to the full frame, with their image
# axis (1 for the (S, h, W, ...) stacks)
_IBR_FLOAT = (("median_depth", 0), ("camera_ray", 0), ("warped_image", 1),
              ("cam_feat", 1), ("min_depth_diff", 0),
              ("valid_src_weight", 1))
_IBR_INT = (("valid_src_index", 1), ("use_first_src_mask", 0),
            ("low_contrib", 0), ("high_contrib", 0))


def _gather_frame(tensors, mesh, axis):
    """All-gather band tensors (image axis 0, or 1 for stacks given as
    (t, 1)) to full frames in ONE collective: each becomes (h, W, k),
    they are concatenated along the last axis, gathered along the rows
    and split again.  One collective keeps the backward's collectives in
    the same order on every rank."""
    flat, shapes = [], []
    for t, ax in tensors:
        if ax == 1:
            t = t.movedim(0, -1 if t.dim() == 3 else 2)   # (h, W, [c,] S)
        shapes.append(t.shape)
        flat.append(t.reshape(t.shape[0], t.shape[1], -1))
    full = C.all_gather(torch.cat(flat, dim=-1), mesh, axis)
    out, c0 = [], 0
    for (t, ax), sh in zip(tensors, shapes):
        k = int(np.prod(sh[2:], dtype=np.int64))
        x = full[..., c0:c0 + k].reshape((full.shape[0],) + tuple(sh[1:]))
        c0 += k
        if ax == 1:
            x = x.movedim(-1 if x.dim() == 3 else 2, 0)
        out.append(x)
    return out


def gsp_full_train_step(opt, rcfg: RasterConfig, net, phase, mesh,
                        width: int, height: int, cap_local: int,
                        exchange_cap: int):
    """The full IBGS objective (trainer.ibgs_objective, shared) with the
    render produced by `exchange_and_blend`.

    step(state, cam_arrays, cam_uids, gts, srcs, iteration, bg, use_app,
    burned_in, net_lr) -> (state, aux).  `state.model` is this rank's
    shard (every per-Gaussian array, `shard_model`); the exposure table
    and `net` (the state's fusion net, updated in place) are replicated.
    Each gs rank renders its band, the band outputs are gathered to the
    full frame so every loss term sees the whole image, and the loss is
    scaled by 1/(dp·n): the n gs ranks of a dp row compute the same loss,
    and the gather's backward sums their n cotangents.  Gaussian and
    screen-dummy gradients are summed over dp only, the exposure table's
    and the net's over both dims; Adam and the densification statistics
    run on the shard.  aux holds the loss terms (means over dp), `loss`,
    `nonfinite_grads`, `n_overflow` and `n_instances` (sums over the
    mesh; instances ÷ dp) and the (dp, H, W) median depths."""
    from ibgs_tpu_torch.renderer import depth_to_normal
    from ibgs_tpu_torch.train.trainer import (ibgs_objective, make_lr_config,
                                              side_adam)

    lrcfg = make_lr_config(opt)
    dp_ax, gs_ax = mesh.mesh_dim_names
    axes = (dp_ax, gs_ax)
    dp, n = C.axis_size(mesh, dp_ax), C.axis_size(mesh, gs_ax)
    i = C.axis_index(mesh, dp_ax)
    if height % (n * rcfg.tile_h):
        raise ValueError(f"height {height} does not split into {n} bands")

    def step(state, cam_arrays, cam_uids, gts, srcs, iteration: int, bg,
             use_app: bool, burned_in: float, net_lr: float):
        with profiling.annotate("train_step", iteration):
            return shard_step(state, cam_arrays, cam_uids, gts, srcs,
                              iteration, bg, use_app, burned_in, net_lr)

    def shard_step(state, cam_arrays, cam_uids, gts, srcs, iteration: int,
                   bg, use_app: bool, burned_in: float, net_lr: float):
        model_loc = state.model
        cam = _band_camera(cam_arrays, width, height, i)
        dev = model_loc.alive.device
        leaves = _leaves(model_loc.params)
        app_ab = state.app_ab.detach().requires_grad_(True)
        sdum = torch.zeros(model_loc.capacity, 2, device=dev,
                           requires_grad=True)
        sdum_abs = torch.zeros(model_loc.capacity, 2, device=dev,
                               requires_grad=True)
        net_params = list(net.parameters()) if net is not None else []

        view = _local_view(model_loc, leaves, model_loc.alive, cam.cam_pos,
                           learnt=opt.learnt_normal)
        view["screen_dummy"], view["screen_dummy_abs"] = sdum, sdum_abs
        render, out, ibr, extras = exchange_and_blend(
            view, cam, rcfg, mesh, cap_local, exchange_cap, axis=gs_ax,
            bg=bg, src=source_at(srcs, i), render_geo=phase.render_geo)
        floats = [(render, 0), (out.normal, 0)]
        if phase.render_geo:
            floats += [(getattr(ibr, f), ax) for f, ax in _IBR_FLOAT]
        image, normal_full, *ibr_f = _gather_frame(floats, mesh, gs_ax)
        # the gather's frames are channel slices of one buffer; the SSIM
        # kernels take contiguous frames
        image = image.contiguous()
        ibr_full = dnormal = median_full = None
        if phase.render_geo:
            ibr_i = _gather_frame([(getattr(ibr, f), ax)
                                   for f, ax in _IBR_INT], mesh, gs_ax)
            ibr_full = IBROutputs(
                **dict(zip((f for f, _ in _IBR_FLOAT), ibr_f)),
                **dict(zip((f for f, _ in _IBR_INT), ibr_i)))
            median_full = ibr_full.median_depth
            dn = depth_to_normal(cam, median_full)
            dnormal = dn * torch.rsqrt((dn * dn).sum(-1, keepdim=True)
                                       + 1e-16)
        total, aux = ibgs_objective(
            opt, phase, net, app_ab, int(cam_uids[i]), image, normal_full,
            dnormal, ibr_full, gts[i], iteration, use_app, burned_in)
        inputs = [*(getattr(leaves, k) for k in PARAM_FIELDS), app_ab,
                  *net_params, sdum, sdum_abs]
        g = _grad_list(total / (dp * n), inputs)
        nf = len(PARAM_FIELDS)
        g_params, g_app, g_net = g[:nf], g[nf], g[nf + 1:-2]
        g_sd, g_sda = g[-2], g[-1]
        nonfinite = sum((~torch.isfinite(x)).sum() for x in g)

        g_params = GaussianParams(**{k: C.psum(x, mesh, dp_ax)
                                     for k, x in zip(PARAM_FIELDS, g_params)})
        g_sd, g_sda = C.psum(g_sd, mesh, dp_ax), C.psum(g_sda, mesh, dp_ax)
        g_app = C.psum(g_app, mesh, axes)
        g_net = [C.psum(x, mesh, axes) for x in g_net]

        lrs = lr_tree(lrcfg, iteration, state.spatial_lr_scale)
        model_new = adam_step(model_loc, g_params, lrs)
        model_new = accumulate_stats(model_new, g_sd, g_sda,
                                     extras["radius"], width, height)
        (app_new,), app_opt = side_adam([state.app_ab], state.app_opt,
                                        [g_app], lr=1e-3, b2=0.99)
        net_opt = state.net_opt
        if phase.use_aggregation:
            new, net_opt = side_adam(net_params, state.net_opt, g_net,
                                     lr=net_lr)
            with torch.no_grad():
                for p, q in zip(net_params, new):
                    p.copy_(q)

        aux = {k: C.psum(v.detach(), mesh, dp_ax) / dp
               for k, v in aux.items()}
        aux["loss"] = C.psum((total / (dp * n)).detach(), mesh, axes)
        aux["nonfinite_grads"] = C.psum(nonfinite, mesh, axes)
        aux["n_overflow"] = C.psum(extras["n_overflow"], mesh, axes)
        aux["n_instances"] = int(C.psum(
            torch.tensor(extras["n_instances"], device=dev), mesh, axes)) \
            // dp
        med = (median_full.detach() if median_full is not None
               else torch.zeros(height, width, device=dev))
        aux["median_depth"] = C.all_gather(med[None], mesh, dp_ax)
        return dataclasses.replace(state, model=model_new, app_ab=app_new,
                                   app_opt=app_opt, net_opt=net_opt), aux

    return step


def gsp_interleave(model: GaussianModel, n_shards: int) -> GaussianModel:
    """Deal a full model's slots round-robin over n_shards: new row
    s·(P/n) + t holds old row t·n + s, so alive rows and free slots spread
    evenly over the block-wise shards (call once after init, a checkpoint
    load or a capacity growth)."""
    P = model.capacity
    if P % n_shards:
        raise ValueError(f"capacity {P} over {n_shards} shards")
    pl = P // n_shards
    dev = model.alive.device
    perm = (torch.arange(pl, device=dev)[None, :] * n_shards
            + torch.arange(n_shards, device=dev)[:, None]).reshape(-1)
    return _map_shard_fields(model, lambda x: x[perm])


def shard_generator(seed: int, mesh, device, axis: str = "gs"
                    ) -> torch.Generator:
    """The densify generator of this rank's shard, seeded from (seed, its
    index along `axis`): the dp replicas of a shard draw the same noise,
    the shards different noise."""
    k = C.axis_index(mesh, axis)
    s = int(np.random.SeedSequence([seed, k]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def gsp_densify_fn(mesh, cfg: gaussians.DensifyConfig, max_screen=None,
                   axis: str = "gs"):
    """densify(model_loc, gen, extent, noise=None) -> model_loc: clone,
    split and prune within this rank's own P/n slot pool through the
    single-chip `densify_and_prune`, with the abs-split budget divided
    over the n shards.  The noise is drawn from `gen` (a `shard_generator`)
    unless given as a (3, P/n, 3) tensor.  No collective."""
    n = C.axis_size(mesh, axis)
    cfg_loc = dataclasses.replace(cfg,
                                  max_abs_split=max(cfg.max_abs_split // n, 1))

    def densify(model_loc: GaussianModel, gen, extent: float, noise=None):
        if noise is None:
            noise = gaussians.densify_noise(gen, model_loc.capacity,
                                            model_loc.alive.device)
        return gaussians.densify_and_prune(model_loc, noise, cfg_loc, extent,
                                           max_screen_size=max_screen)

    return densify


def make_gsp_render(width: int, height: int, rcfg: RasterConfig, mesh,
                    cap_local: int, exchange_cap: int, learnt_normal=True,
                    axis: str = "gs"):
    """render(model, cam, bg=None) -> (this rank's band (band, W, 3), the
    overflow summed over `axis`).  Every rank passes the same full model
    and renders with its shard; differentiable w.r.t. the model's
    parameters."""
    def render(model: GaussianModel, cam: Camera, bg=None):
        loc = shard_model(model, mesh, axis)
        view = _local_view(model, loc.params, loc.alive, cam.cam_pos,
                           learnt=learnt_normal)
        img, _, _, extras = exchange_and_blend(
            view, cam, rcfg, mesh, cap_local, exchange_cap, axis=axis, bg=bg,
            src=None, render_geo=False)
        return img, C.psum(extras["n_overflow"], mesh, axis)

    return render


def gsp_render(model: GaussianModel, cam: Camera, rcfg: RasterConfig, mesh,
               cap_local: int, exchange_cap: int, bg=None,
               learnt_normal=True):
    """Gaussian-sharded render; returns the stitched (H, W, 3) image and
    the total overflow on every rank."""
    band, ovf = make_gsp_render(cam.width, cam.height, rcfg, mesh,
                                cap_local, exchange_cap,
                                learnt_normal)(model, cam, bg)
    return C.all_gather(band, mesh, "gs"), ovf
