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

The source colours go into the warp as the JAX package's rgb10 tables:
each texel's 2x2 footprint of int32 words, 10 bits per channel, as one
16-byte row (`pack_rgb10_rows`, the layout of its
`pack_bilinear_corners_rgb10`).  On a card the packing and the warp run as
three hand-written CUDA kernels (csrc/warp.cu: `rgb10_pack_cuda`,
`warp_fwd_cuda`, which also takes the occlusion test's depth sample, and
`warp_bwd_cuda`, launched through `_cuda`; the warp reads the blend's
(H, W, B) buffers in place); on the CPU as their plain PyTorch versions
(`pack_rgb10_rows`, `warp_views_plain`, `warp_views_bwd_plain`).
"""
from __future__ import annotations

import dataclasses

import torch

from ibgs_tpu_torch.core.camera import Camera, device_scalar
from ibgs_tpu_torch.ops import _cuda
from ibgs_tpu_torch.ops.blend_common import BlendOutputs
from ibgs_tpu_torch.ops.preprocess import to_i32
from ibgs_tpu_torch.utils import profiling

EPS = 1.0e-8
RGB10_SCALE = 1023.0
# the kernels keep the S transforms in shared memory (48 bytes each)
MAX_SOURCES = 1024


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


def pack_rgb10(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) colours → (...) int32 words of 10 bits per channel, the JAX
    package's colour tables: q = round(clip(x, 0, 1)·1023) per channel (NaN
    → 0), r << 20 | g << 10 | b."""
    q = to_i32(torch.round(torch.clamp(img, 0.0, 1.0) * RGB10_SCALE))
    return (q[..., 0] << 20) | (q[..., 1] << 10) | q[..., 2]


def pack_rgb10_rows(images: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) colours → (..., H, W, 4) int32: each texel's 2x2
    clamp-to-edge footprint of `pack_rgb10` words [I(y, x), I(y, x+1),
    I(y+1, x), I(y+1, x+1)], the rows of the JAX package's
    `pack_bilinear_corners_rgb10`."""
    p = pack_rgb10(images)
    right = torch.cat([p[..., 1:], p[..., -1:]], dim=-1)
    down = torch.cat([p[..., 1:, :], p[..., -1:, :]], dim=-2)
    downright = torch.cat([right[..., 1:, :], right[..., -1:, :]], dim=-2)
    return torch.stack([p, right, down, downright], dim=-1)


def unpack_rgb10(words: torch.Tensor) -> torch.Tensor:
    """int32 rgb10 words → (..., 3) float32 colours q · (1/1023)."""
    q = torch.stack([(words >> 20) & 1023, (words >> 10) & 1023,
                     words & 1023], dim=-1)
    return q.to(torch.float32) * (1.0 / RGB10_SCALE)


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
    """The four clamp-to-edge corner colours (…, 3), unpacked from the
    footprint row of the (Hs, Ws, 4) rgb10 table, and the fractional
    offsets of the bilinear sample; zero-weight entries read texel 0, as
    the JAX package does."""
    live = w_eff > 0.0
    zero = torch.zeros((), dtype=torch.long, device=pu.device)
    x0 = torch.where(live, _floor_index(pu, Ws), zero)
    y0 = torch.where(live, _floor_index(pv, Hs), zero)
    rows = tables_s.reshape(Hs * Ws, 4)[y0 * Ws + x0]
    return (tuple(unpack_rgb10(rows[..., k]) for k in range(4)),
            pu - torch.floor(pu), pv - torch.floor(pv))


def _occlusion(median, depths, r2s, pdx, pdy, fx, fy, cx, cy):
    """The occlusion test's depth sample of the median point (pdx·m,
    pdy·m, m) in every source: its source depth `wdepth` (S, H, W), 0 where
    the point falls outside [0, W-1] x [0, Hs-1] (W the rendered view's
    width, as the JAX package bounds it), and `depth_err` = |wdepth - qz| /
    (qz + 1e-8)."""
    S, Hs = depths.shape[0], depths.shape[1]
    W = pdx.shape[1]
    mx, my, mz = (pdx * median)[None], (pdy * median)[None], median[None]

    def xform_m(M, i):
        return (M[:, i, 0][:, None, None] * mx + M[:, i, 1][:, None, None] * my
                + M[:, i, 2][:, None, None] * mz + M[:, i, 3][:, None, None])

    qmx, qmy, qmz = xform_m(r2s, 0), xform_m(r2s, 1), xform_m(r2s, 2)
    inv_zm = 1.0 / (qmz + EPS)
    pum = qmx * fx * inv_zm + cx
    pvm = qmy * fy * inv_zm + cy
    inbm = (pum >= 0.0) & (pum <= W - 1.0) & (pvm >= 0.0) & (pvm <= Hs - 1.0)
    wdepth = torch.stack([bilinear_sample(depths[s], pum[s], pvm[s])
                          for s in range(S)], dim=0)
    wdepth = torch.where(inbm, wdepth, 0.0)
    depth_err = torch.abs(wdepth - qmz) * inv_zm
    return wdepth, depth_err


def warp_views_plain(bd, bw, tables, r2s, pdx, pdy, median, depths, fx, fy,
                     cx, cy):
    """Reproject every buffer entry into each source view and accumulate
    weighted bilinear colours; sample each source's depth at the median
    point.  bd, bw: (B, H, W); tables: (S, Hs, Ws, 4) int32 rgb10
    footprint rows of the source colours (`pack_rgb10_rows`); median:
    (H, W); depths: (S, Hs, Ws) source depth maps.  Returns (S, H, W, 3)
    weighted colour sums, (S, H, W) weight sums and the occlusion test's
    `wdepth` and `depth_err` (S, H, W).  The colour sums are
    differentiable by torch autograd."""
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
    wdepth, depth_err = _occlusion(median, depths, r2s, pdx, pdy, fx, fy,
                                   cx, cy)
    return torch.stack(wsc, 0), torch.stack(ws, 0), wdepth, depth_err


def warp_views_bwd_plain(bd, bw, tables, r2s, pdx, pdy, intr, g_wsc,
                         g_wsum):
    """The JAX package's hand-derived VJP of the warp (`_warp_views_bwd`)
    in plain PyTorch: the bilinear texture gradient chained through the
    projection Jacobian dp/d(depth), plus the in-bounds-masked weight
    gradient.  It recomputes the projection and the corner gather from the
    inputs instead of saving the (B, H, W, 3) corner slabs of every source.
    `intr` is (fx, fy, cx, cy); g_wsc (S, H, W, 3), g_wsum (S, H, W) are the
    cotangents of the two colour outputs.  Returns (dbd, dbw), each (B, H,
    W)."""
    fx, fy, cx, cy = intr
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
    return dbd, dbw


def _check_warp(name, bd, bw, tables, r2s, pdx, pdy, extra=(), cts=()):
    """Shapes, dtypes, devices and layouts the warp kernels take; raises
    ValueError.  bd and bw must be (B, H, W) views of (H, W, B) buffers
    (read in place), `extra` (name, tensor, shape) triples of further
    float32 inputs; every input but the cotangents `cts` (g_wsc, g_wsum)
    contiguous."""
    if bd.ndim != 3 or tables.ndim != 4 or tables.shape[3] != 4 \
            or min(tables.shape[1:3]) < 1:
        raise ValueError(f"{name}: bd must be (B, H, W) and tables (S, Hs, "
                         f"Ws, 4) with Hs, Ws >= 1, got {tuple(bd.shape)} "
                         f"and {tuple(tables.shape)}")
    (B, H, W), (S, Hs, Ws, _) = bd.shape, tables.shape
    f32, i32 = torch.float32, torch.int32
    named = (("bd", bd, (B, H, W), f32), ("bw", bw, (B, H, W), f32),
             ("tables", tables, (S, Hs, Ws, 4), i32),
             ("r2s", r2s, (S, 4, 4), f32), ("pdx", pdx, (H, W), f32),
             ("pdy", pdy, (H, W), f32),
             *((n, t, shape, f32) for n, t, shape in extra),
             *zip(("g_wsc", "g_wsum"), cts, ((S, H, W, 3), (S, H, W)),
                  (f32, f32)))
    for arg, t, shape, dtype in named:
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != bd.device:
            raise ValueError(f"{name}: {arg} must be {dtype} {shape} on "
                             f"{bd.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if bd.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device, got "
                         f"{bd.device}")
    if S > MAX_SOURCES:
        raise ValueError(f"{name}: at most {MAX_SOURCES} sources, got {S}")
    if bd.stride() != bw.stride() or not _in_place(bd):
        raise ValueError(f"{name}: bd and bw must be (B, H, W) views of "
                         f"(H, W, B) buffers with one row stride, got "
                         f"strides {bd.stride()} and {bw.stride()}")
    for arg, t, *_ in named[2:len(named) - len(cts)]:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _in_place(bd) -> bool:
    """Whether (B, H, W) `bd` reads entry b of pixel (y, x) at y·row_stride
    + x·B + b, the layout of an (H, W, B) buffer (rows may be padded)."""
    B, H, W = bd.shape
    return ((B == 1 or bd.stride(0) == 1) and (W == 1 or bd.stride(2) == B)
            and (H == 1 or bd.stride(1) >= W * B))


def _row_stride(bd) -> int:
    B, H, W = bd.shape
    return bd.stride(1) if H > 1 else W * B


def rgb10_pack_cuda(images):
    """`pack_rgb10_rows` of (S, Hs, Ws, 3) contiguous float32 source
    colours as the CUDA kernel (csrc/warp.cu) on the current stream.
    Returns (S, Hs, Ws, 4) int32."""
    if images.ndim != 4 or images.shape[3] != 3 \
            or images.dtype != torch.float32 or not images.is_contiguous():
        raise ValueError(f"rgb10_pack_cuda: images must be contiguous "
                         f"float32 (S, Hs, Ws, 3), got {images.dtype} "
                         f"{tuple(images.shape)}")
    if images.device.type != "cuda":
        raise ValueError(f"rgb10_pack_cuda: images must be on a CUDA "
                         f"device, got {images.device}")
    out = torch.empty(*images.shape[:3], 4, dtype=torch.int32,
                      device=images.device)
    _cuda.rgb10_pack(images, out)
    return out


def rgb10_tables(images):
    """The warp's (S, Hs, Ws, 4) int32 colour tables of (S, Hs, Ws, 3)
    source images: `pack_rgb10_rows` on CPU tensors, `rgb10_pack_cuda` on
    CUDA tensors."""
    if images.device.type == "cpu":
        return pack_rgb10_rows(images)
    return rgb10_pack_cuda(images)


def warp_fwd_cuda(bd, bw, tables, r2s, pdx, pdy, median, depths, fx, fy,
                  cx, cy):
    """`warp_views_plain` (same arguments and outputs) as the CUDA forward
    kernel (csrc/warp.cu) on the current stream.  bd and bw are read in
    place as (B, H, W) views of the blend's (H, W, B) buffers."""
    B, H, W = bd.shape
    S, Hs, Ws = tables.shape[:3]
    _check_warp("warp_fwd_cuda", bd, bw, tables, r2s, pdx, pdy,
                (("median", median, (H, W)), ("depths", depths, (S, Hs, Ws))))
    dev = bd.device
    outs = (torch.empty(S, H, W, 3, dtype=torch.float32, device=dev),
            *(torch.empty(S, H, W, dtype=torch.float32, device=dev)
              for _ in range(3)))
    _cuda.warp_fwd(bd, bw, _row_stride(bd), tables, r2s, pdx, pdy, median,
                   depths, (float(fx), float(fy), float(cx), float(cy)),
                   outs)
    return outs


def warp_bwd_cuda(bd, bw, tables, r2s, pdx, pdy, intr, g_wsc, g_wsum):
    """`warp_views_bwd_plain` (same arguments and outputs) as the CUDA
    backward kernel (csrc/warp.cu) on the current stream.  Writes the
    gradients in (H, W, B) and returns their (B, H, W) views."""
    _check_warp("warp_bwd_cuda", bd, bw, tables, r2s, pdx, pdy,
                cts=(g_wsc, g_wsum))
    B, H, W = bd.shape
    dev = bd.device
    dbd = torch.empty(H, W, B, dtype=torch.float32, device=dev)
    dbw = torch.empty(H, W, B, dtype=torch.float32, device=dev)
    # autograd may hand an expanded cotangent: copied only then
    _cuda.warp_bwd(bd, bw, _row_stride(bd), tables, r2s, pdx, pdy,
                   tuple(float(v) for v in intr), g_wsc.contiguous(),
                   g_wsum.contiguous(), dbd, dbw)
    return dbd.permute(2, 0, 1), dbw.permute(2, 0, 1)


class _WarpViews(torch.autograd.Function):
    """The warp as one differentiable op of the buffer depths and weights,
    with the JAX package's hand-derived VJP.  CPU tensors go through the
    plain versions (`warp_views_plain`, `warp_views_bwd_plain`), CUDA
    tensors through the kernels (`warp_fwd_cuda`, `warp_bwd_cuda`), which
    raise on what they do not take.  The source tables, transforms, rays,
    median and depth maps get no gradient; `wdepth` and `depth_err` carry
    none."""

    @staticmethod
    def forward(ctx, bd, bw, tables, r2s, pdx, pdy, median, depths, intr):
        ctx.save_for_backward(bd, bw, tables, r2s, pdx, pdy)
        ctx.intr = intr
        fwd = warp_views_plain if bd.device.type == "cpu" else warp_fwd_cuda
        out = fwd(bd, bw, tables, r2s, pdx, pdy, median, depths, *intr)
        ctx.mark_non_differentiable(out[2], out[3])
        return out

    @staticmethod
    def backward(ctx, g_wsc, g_wsum, _g_wdepth, _g_depth_err):
        saved = ctx.saved_tensors
        bwd = (warp_views_bwd_plain if saved[0].device.type == "cpu"
               else warp_bwd_cuda)
        dbd, dbw = bwd(*saved, ctx.intr, g_wsc, g_wsum)
        return (dbd, dbw) + (None,) * 7


def warp_views(bd, bw, tables, r2s, pdx, pdy, median, depths, fx, fy, cx,
               cy):
    """`warp_views_plain` (same arguments and outputs), differentiable
    w.r.t. `bd` and `bw` through the hand-written VJP."""
    return _WarpViews.apply(bd, bw, tables, r2s, pdx, pdy, median, depths,
                            (fx, fy, cx, cy))


def median_depth_only(blend: BlendOutputs) -> torch.Tensor:
    """Depth-only epilogue: buffer-weighted mean of the buffer depths."""
    with profiling.annotate("epilogue"):
        tot = blend.buf_weight.sum(-1)
        return (blend.buf_weight * blend.buf_depth).sum(-1) / (tot + EPS)


def ibr_epilogue(blend: BlendOutputs, cam: Camera, src: SourceViews,
                 depth_error_threshold: float = 0.01,
                 row0: int = 0) -> IBROutputs:
    """The epilogue of a blend over image rows [row0, row0 + H): the rays
    and the warp use those rows' pixel centres; the sources are full
    frames."""
    with profiling.annotate("epilogue"):
        H, W = blend.final_t.shape
        S = src.images.shape[0]
        dev = blend.final_t.device
        # the source views are constants
        images = src.images.detach().contiguous()
        depths = src.depths.detach().contiguous()
        r2s = src.ref_to_src.detach()
        src_pos = src.cam_pos.detach()

        xs = torch.arange(W, dtype=torch.float32, device=dev)
        ys = torch.arange(H, dtype=torch.float32, device=dev) + float(row0)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pdx = (gx - cam.cx) / device_scalar(cam.fx, dev)
        pdy = (gy - cam.cy) / device_scalar(cam.fy, dev)

        bw = blend.buf_weight.permute(2, 0, 1)   # (B, H, W)
        bd = blend.buf_depth.permute(2, 0, 1)
        used = bw != 0.0
        tot_w = (bw * used).sum(0)
        median = (bw * bd).sum(0) / (tot_w + EPS)

        # the warp and the occlusion test's depth sample (no gradient) in one
        wsum_color, wsum, wdepth, depth_err = warp_views(
            bd, bw, rgb10_tables(images), r2s, pdx, pdy, median.detach(),
            depths, cam.fx, cam.fy, cam.cx, cam.cy)

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

        s_ids = torch.arange(S, dtype=torch.int32, device=dev)[:, None, None]
        valid = (wdepth > 0.0) & (depth_err < depth_error_threshold) \
            & (s_ids < src.count)

        # valid sources first, in source order: packed slot k takes x[s] from
        # the unique s with valid[s] and rank[s] == k
        rank = torch.cumsum(valid.to(torch.int32), dim=0) - 1
        n_valid = valid.sum(dim=0)
        # per-s (S, H, W)
        sel = [valid[s] & (rank[s] == s_ids) for s in range(S)]

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
        src_dir = src_dir * torch.rsqrt(
            (src_dir * src_dir).sum(-1, keepdim=True) + EPS)
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
