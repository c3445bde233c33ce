"""Image-based-rendering epilogue (counterpart of ibgs_tpu/ops/epilogue.py).

The per-pixel tail of the IBGS render: median plane-intersection depth
from the buffer, reprojection of every buffer entry into each source view
with bilinear colour sampling, occlusion testing of the median point
against the source depth maps, valid-first packing of the warped colours
and camera features, and the world-space viewing ray.  Float32 op order
follows the JAX package.

Gradients flow as in the JAX package: `warped_image` and `median_depth`
are differentiable w.r.t. the buffer depths and weights (the warp through
the hand-written VJP of `_WarpViews`); the source views, `camera_ray`,
`cam_feat`, `min_depth_diff`, `valid_src_weight` and the occlusion test
carry no gradient.
"""
from __future__ import annotations

import dataclasses

import torch

from ibgs_tpu_torch.core.camera import Camera, device_scalar
from ibgs_tpu_torch.ops.blend_common import BlendOutputs
from ibgs_tpu_torch.ops.preprocess import to_i32

EPS = 1.0e-8
RGB10_SCALE = 1023.0


@dataclasses.dataclass
class SourceViews:
    """A stack of S source (training) views for the image-based path."""
    images: torch.Tensor      # (S, H, W, 3) colours
    depths: torch.Tensor      # (S, H, W) rendered depths
    ref_to_src: torch.Tensor  # (S, 4, 4) reference-camera → source-camera
    cam_pos: torch.Tensor     # (S, 3) world-space source centres
    count: int                # number of real views (<= S)


@dataclasses.dataclass
class IBROutputs:
    median_depth: torch.Tensor      # (H, W)
    camera_ray: torch.Tensor        # (H, W, 3) world ray through median point
    warped_image: torch.Tensor      # (S, H, W, 3) packed by valid order
    cam_feat: torch.Tensor          # (S, H, W, 4) packed (Δcam-pos, ray-dot)
    min_depth_diff: torch.Tensor    # (H, W)
    valid_src_index: torch.Tensor   # (S, H, W) int32, -1 padded
    valid_src_weight: torch.Tensor  # (S, H, W) per-view buffer-weight sums
    use_first_src_mask: torch.Tensor  # (H, W) int32
    low_contrib: torch.Tensor       # (H, W) int32 median-window low
    high_contrib: torch.Tensor      # (H, W) int32 median-window high


def _corners(img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor):
    """Clamp-to-edge 2x2 footprint of (H, W, C) `img` at integer (x0, y0)
    (already clamped to the image): four (…, C) corner values."""
    H, W = img.shape[0], img.shape[1]
    flat = img.reshape(H * W, -1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    return (flat[y0 * W + x0], flat[y0 * W + x1],
            flat[y1 * W + x0], flat[y1 * W + x1])


def _floor_index(u: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(to_i32(torch.floor(u)).long(), 0, n - 1)


def bilinear_sample(img: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear sampling (texel-centre convention, clamp-to-edge).
    img: (H, W, C) or (H, W); u, v: pixel coords of any shape."""
    H, W = img.shape[0], img.shape[1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    i00, i01, i10, i11 = _corners(img, _floor_index(u, W), _floor_index(v, H))
    if img.ndim == 3:
        fu = fu[..., None]
        fv = fv[..., None]
    else:
        i00, i01, i10, i11 = (c[..., 0] for c in (i00, i01, i10, i11))
    return ((1 - fu) * (1 - fv) * i00 + fu * (1 - fv) * i01
            + (1 - fu) * fv * i10 + fu * fv * i11)


def quantize_rgb10(img: torch.Tensor) -> torch.Tensor:
    """Colours on the 10-bit grid of the JAX package's packed colour tables:
    round(clip(x, 0, 1)·1023) · (1/1023), in float32."""
    q = torch.round(torch.clamp(img, 0.0, 1.0) * RGB10_SCALE)
    return q * (1.0 / RGB10_SCALE)


def _proj_view(bd, r2s_s, pdx, pdy, fx, fy, cx, cy, Hs, Ws):
    """Buffer depths (B, H, W) → source pixel coords of one source view."""
    px_, py_, pz_ = pdx[None] * bd, pdy[None] * bd, bd

    def xf(i):
        return (r2s_s[i, 0] * px_ + r2s_s[i, 1] * py_
                + r2s_s[i, 2] * pz_ + r2s_s[i, 3])

    qx, qy, qz = xf(0), xf(1), xf(2)
    inv_z = 1.0 / (qz + EPS)
    pu = qx * fx * inv_z + cx
    pv = qy * fy * inv_z + cy
    inb = (pu >= 0.0) & (pu <= Ws - 1.0) & (pv >= 0.0) & (pv <= Hs - 1.0)
    return pu, pv, inb, qx, qy, inv_z


def _warp_corners(tables_s, pu, pv, w_eff, Hs, Ws):
    """The four clamp-to-edge corner colours (…, 3) and the fractional
    offsets of the bilinear sample; zero-weight entries read texel 0, as
    the JAX package does."""
    live = w_eff > 0.0
    zero = torch.zeros((), dtype=torch.long, device=pu.device)
    corners = _corners(tables_s, torch.where(live, _floor_index(pu, Ws), zero),
                       torch.where(live, _floor_index(pv, Hs), zero))
    return corners, pu - torch.floor(pu), pv - torch.floor(pv)


def warp_views_plain(bd, bw, tables, r2s, pdx, pdy, fx, fy, cx, cy):
    """Reproject every buffer entry into each source view and accumulate
    weighted bilinear colours.  bd, bw: (B, H, W); tables: (S, Hs, Ws, 3)
    rgb10-quantised source colours.  Returns (S, H, W, 3) weighted colour
    sums and (S, H, W) weight sums.  Differentiable by torch autograd."""
    S, Hs, Ws = tables.shape[0], tables.shape[1], tables.shape[2]
    wsc, ws = [], []
    for s in range(S):
        pu, pv, inb, *_ = _proj_view(bd, r2s[s], pdx, pdy, fx, fy, cx, cy,
                                     Hs, Ws)
        w_eff = bw * inb.to(bw.dtype)
        (c00, c01, c10, c11), fu, fv = _warp_corners(tables[s], pu, pv,
                                                     w_eff, Hs, Ws)
        fu, fv = fu[..., None], fv[..., None]
        col = ((1 - fu) * (1 - fv) * c00 + fu * (1 - fv) * c01
               + (1 - fu) * fv * c10 + fu * fv * c11)       # (B,H,W,3)
        wsc.append((col * w_eff[..., None]).sum(0))
        ws.append(w_eff.sum(0))
    return torch.stack(wsc, 0), torch.stack(ws, 0)


class _WarpViews(torch.autograd.Function):
    """`warp_views_plain` with the JAX package's hand-derived VJP
    (`_warp_views_bwd`): the bilinear texture gradient chained through the
    projection Jacobian dp/d(depth), plus the in-bounds-masked weight
    gradient.  The backward recomputes the projection and the corner
    gather from the inputs instead of saving the (B, H, W, 3) corner slabs
    of every source.  The source tables, transforms and rays get no
    gradient."""

    @staticmethod
    def forward(ctx, bd, bw, tables, r2s, pdx, pdy, intr):
        ctx.save_for_backward(bd, bw, tables, r2s, pdx, pdy)
        ctx.intr = intr
        return warp_views_plain(bd, bw, tables, r2s, pdx, pdy, *intr)

    @staticmethod
    def backward(ctx, g_wsc, g_wsum):
        bd, bw, tables, r2s, pdx, pdy = ctx.saved_tensors
        fx, fy, cx, cy = ctx.intr
        S, Hs, Ws = tables.shape[0], tables.shape[1], tables.shape[2]
        dbd = torch.zeros_like(bd)
        dbw = torch.zeros_like(bw)
        for s in range(S):
            pu, pv, inb, qx, qy, inv_z = _proj_view(
                bd, r2s[s], pdx, pdy, fx, fy, cx, cy, Hs, Ws)
            inbf = inb.to(bw.dtype)
            w_eff = bw * inbf
            (c00, c01, c10, c11), fu, fv = _warp_corners(tables[s], pu, pv,
                                                         w_eff, Hs, Ws)
            w00 = (1 - fu) * (1 - fv)
            w01 = fu * (1 - fv)
            w10 = (1 - fu) * fv
            w11 = fu * fv
            dw_eff = g_wsum[s][None]
            du = torch.zeros_like(bd)
            dv = torch.zeros_like(bd)
            for ch in range(3):
                a00, a01 = c00[..., ch], c01[..., ch]
                a10, a11 = c10[..., ch], c11[..., ch]
                col = w00 * a00 + w01 * a01 + w10 * a10 + w11 * a11
                gc = g_wsc[s][None, ..., ch]
                dw_eff = dw_eff + col * gc
                dcol = w_eff * gc
                du = du + dcol * ((1 - fv) * (a01 - a00) + fv * (a11 - a10))
                dv = dv + dcol * ((1 - fu) * (a10 - a00) + fu * (a11 - a01))
            dbw = dbw + dw_eff * inbf
            # q = A·(pdx·d, pdy·d, d) + t, so dq/dd = A·(pdx, pdy, 1)
            rx, ry, rz = (r2s[s, i, 0] * pdx + r2s[s, i, 1] * pdy
                          + r2s[s, i, 2] for i in range(3))
            du_dbd = fx * (rx[None] - qx * inv_z * rz[None]) * inv_z
            dv_dbd = fy * (ry[None] - qy * inv_z * rz[None]) * inv_z
            dbd = dbd + du * du_dbd + dv * dv_dbd
        return dbd, dbw, None, None, None, None, None


def warp_views(bd, bw, tables, r2s, pdx, pdy, fx, fy, cx, cy):
    """`warp_views_plain` (same arguments and outputs), differentiable
    w.r.t. `bd` and `bw` through the hand-written VJP."""
    return _WarpViews.apply(bd, bw, tables, r2s, pdx, pdy,
                            (fx, fy, cx, cy))


def median_depth_only(blend: BlendOutputs) -> torch.Tensor:
    """Depth-only epilogue: buffer-weighted mean of the buffer depths."""
    tot = blend.buf_weight.sum(-1)
    return (blend.buf_weight * blend.buf_depth).sum(-1) / (tot + EPS)


def ibr_epilogue(blend: BlendOutputs, cam: Camera, src: SourceViews,
                 depth_error_threshold: float = 0.01) -> IBROutputs:
    H, W = blend.final_t.shape
    S, Hs, Ws = src.images.shape[0], src.images.shape[1], src.images.shape[2]
    dev = blend.final_t.device
    # the source views are constants
    images = src.images.detach()
    depths = src.depths.detach()
    r2s = src.ref_to_src.detach()
    src_pos = src.cam_pos.detach()

    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pdx = (gx - cam.cx) / device_scalar(cam.fx, dev)
    pdy = (gy - cam.cy) / device_scalar(cam.fy, dev)

    bw = blend.buf_weight.permute(2, 0, 1)   # (B, H, W)
    bd = blend.buf_depth.permute(2, 0, 1)
    used = bw != 0.0

    tables = quantize_rgb10(images)
    wsum_color, wsum = warp_views(bd, bw, tables, r2s, pdx, pdy,
                                  cam.fx, cam.fy, cam.cx, cam.cy)

    tot_w = (bw * used).sum(0)
    median = (bw * bd).sum(0) / (tot_w + EPS)

    # median contributor window (min/max over used entries, seeded with
    # slot 0)
    contrib = blend.buf_contrib
    used_hwb = blend.buf_weight != 0.0
    low = torch.minimum(
        torch.where(used_hwb, contrib, 2 ** 30).amin(-1), contrib[..., 0])
    high = torch.maximum(
        torch.where(used_hwb, contrib, 0).amax(-1), contrib[..., 0])

    # median point and world-space viewing ray
    mpt = torch.stack([pdx * median, pdy * median, median], dim=-1)
    d = mpt - cam.view[:3, 3]
    V = cam.view[:3, :3]
    mpt_world = torch.stack(
        [d[..., 0] * V[0, k] + d[..., 1] * V[1, k] + d[..., 2] * V[2, k]
         for k in range(3)], dim=-1)
    ray = mpt_world - cam.cam_pos
    ray = (ray * torch.rsqrt((ray * ray).sum(-1, keepdim=True) + EPS)
           ).detach()
    mpt_world_c = mpt_world.detach()

    # occlusion test of the median point per source (no gradient)
    mpt_c = mpt.detach()
    mx, my, mz = mpt_c[..., 0][None], mpt_c[..., 1][None], mpt_c[..., 2][None]

    def xform_m(M, i):
        return (M[:, i, 0][:, None, None] * mx + M[:, i, 1][:, None, None] * my
                + M[:, i, 2][:, None, None] * mz + M[:, i, 3][:, None, None])

    qmx, qmy, qmz = xform_m(r2s, 0), xform_m(r2s, 1), xform_m(r2s, 2)
    inv_zm = 1.0 / (qmz + EPS)
    pum = qmx * cam.fx * inv_zm + cam.cx
    pvm = qmy * cam.fy * inv_zm + cam.cy
    inbm = (pum >= 0.0) & (pum <= W - 1.0) & (pvm >= 0.0) & (pvm <= Hs - 1.0)
    wdepth = torch.stack([bilinear_sample(depths[s], pum[s], pvm[s])
                          for s in range(S)], dim=0)
    wdepth = torch.where(inbm, wdepth, 0.0)
    depth_err = torch.abs(wdepth - qmz) * inv_zm             # (S,H,W)

    s_ids = torch.arange(S, dtype=torch.int32, device=dev)[:, None, None]
    valid = (wdepth > 0.0) & (depth_err < depth_error_threshold) \
        & (s_ids < src.count)

    # valid sources first, in source order: packed slot k takes x[s] from
    # the unique s with valid[s] and rank[s] == k
    rank = torch.cumsum(valid.to(torch.int32), dim=0) - 1
    n_valid = valid.sum(dim=0)
    sel = [valid[s] & (rank[s] == s_ids) for s in range(S)]   # per-s (S,H,W)

    def pack(x):
        out = 0
        for s in range(S):
            m = sel[s].reshape(sel[s].shape + (1,) * (x.ndim - 3))
            out = out + torch.where(m, x[s][None], 0)
        return out

    valid_p = s_ids < n_valid
    warped = wsum_color / (wsum[..., None] + EPS)
    warped_p = pack(warped)

    src_dir = mpt_world_c[None] - src_pos[:, None, None, :]
    src_dir = src_dir * torch.rsqrt((src_dir * src_dir).sum(-1, keepdim=True)
                                    + EPS)
    ray_dot = (src_dir * ray[None]).sum(-1)
    dcam = ((cam.cam_pos - src_pos)[:, None, None, :]
            * torch.ones(S, H, W, 3, device=dev))
    feat = torch.cat([dcam, ray_dot[..., None]], dim=-1)
    feat_p = pack(feat).detach()

    idx_p = torch.where(valid_p, pack(s_ids.expand(S, H, W)), -1)
    wsum_p = pack(wsum).detach()

    min_err = torch.where(valid, depth_err, 1.0).amin(dim=0)
    min_err = torch.clamp(min_err, max=1.0).detach()

    return IBROutputs(
        median_depth=median, camera_ray=ray, warped_image=warped_p,
        cam_feat=feat_p, min_depth_diff=min_err,
        valid_src_index=idx_p.to(torch.int32), valid_src_weight=wsum_p,
        use_first_src_mask=valid[0].to(torch.int32),
        low_contrib=low, high_contrib=high)
