"""Blend forward and backward: the plain PyTorch versions, the CUDA
kernels' wrappers and the autograd Function around them (counterpart of
ibgs_tpu/ops/blend_oracle.py and ibgs_tpu/ops/blend_pallas.py).

Per pixel, the exact sequential semantics of the JAX oracle: front-to-back
alpha compositing of the tile's depth-sorted instances with
`alpha = min(0.99, op·exp(min(power, 0)))`, the gate
`power <= 0 && alpha >= 1/255`, an exclusive stop once `T·(1-α) < 1e-4`
(the crossing instance is excluded and ends the pixel), plane-intersection
depths and the two-part median buffer (circular "before" part while
T > 0.5, write-once "below" part after, last writer wins per slot).  In
`depth_only` mode a pixel stops once the below part fills; the filling
instance still counts.

The backward is the analytic VJP of the Pallas `_bwd_kernel`: it re-walks
each tile forward, takes the suffix sums of the alpha recursion as the
saved total minus the running inclusive prefix (so it never divides by T),
gates the alpha gradient at the 0.99 clamp and routes median-buffer
gradients only to the exact buffer entry.  It writes one disjoint
16-column row per instance, so the gradient needs no atomics.

`blend_packed` is differentiable w.r.t. the instance table.  On CUDA
tensors it launches the CUDA kernels (`csrc/blend_fwd.cu`,
`csrc/blend_bwd.cu`); on CPU tensors it runs `blend_plain` /
`blend_bwd_plain`.  There is no fallback: a CUDA tensor either goes
through the kernels or raises.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ibgs_tpu_torch.core.camera import device_scalar
from ibgs_tpu_torch.ops import _cuda
from ibgs_tpu_torch.ops import blend_common as bc
from ibgs_tpu_torch.ops.blend_common import BlendConfig, BlendOutputs
from ibgs_tpu_torch.utils import profiling

CF = 16             # packed feature channels of the JAX package's table
# feature channel layout (columns of the per-instance table)
FX, FY, FCA, FCB, FCC, FOP, FR, FG, FB, FNX, FNY, FNZ, FD, FAX, FAY, FPAD = range(16)
N_READ = FD + 1     # channels the forward reads

# threads (one per pixel) of one sub-tile CTA of each kernel, and the most
# sub-tiles of one tile (csrc/blend_fwd.cu, blend_bwd.cu, blend_common.cuh)
FWD_CTA, BWD_CTA, MAX_SPLITS = 256, 128, 8


def cta_threads(sub_h: int, sub_w: int) -> int:
    """Threads of the CTA of a sub_h x sub_w sub-tile: one per pixel, in
    whole warps (csrc/blend_common.cuh `cta_threads`)."""
    n = sub_h * sub_w
    return n if sub_w % 8 == 0 and sub_h % 4 == 0 else -(-n // 32) * 32


@functools.lru_cache(maxsize=None)
def sub_tile_split(tile_h: int, tile_w: int, max_threads: int) -> tuple:
    """(splits_y, splits_x): how a kernel cuts a tile into sub-tiles of
    ceil(tile_h / splits_y) x ceil(tile_w / splits_x) pixels, one CTA of at
    most `max_threads` threads each.  The fewest sub-tiles win, then the
    fewest idle threads, then the squarest sub-tile; no sub-tile is empty.
    A 16x32 tile gives (1, 2) for 256 threads (two 16x16 CTAs) and (1, 4)
    for 128 (four 16x8)."""
    best = None
    for sy in range(1, tile_h + 1):
        sh = -(-tile_h // sy)
        if (sy - 1) * sh >= tile_h:
            continue
        for sx in range(1, tile_w + 1):
            sw = -(-tile_w // sx)
            threads = cta_threads(sh, sw)
            if (sx - 1) * sw >= tile_w or threads > max_threads:
                continue
            key = (sy * sx, sy * sx * threads - tile_h * tile_w,
                   abs(sh - sw), sy)
            if best is None or key < best[0]:
                best = (key, (sy, sx))
            break                   # a larger sx only adds sub-tiles
    if best is None or best[1][0] * best[1][1] > MAX_SPLITS:
        raise ValueError(f"blend: a {tile_h}x{tile_w} tile needs more than "
                         f"{MAX_SPLITS} sub-tiles of {max_threads} pixels")
    return best[1]


def mode_of(cfg: BlendConfig) -> int:
    """Kernel mode: 0 colour only, 1 render_geo, 2 depth_only."""
    return 2 if cfg.depth_only else int(cfg.render_geo)


def blend_plain(feats: torch.Tensor, tile_start: torch.Tensor,
                tile_stop: torch.Tensor, Wp: int, Hp: int,
                fx: float, fy: float, cx: float, cy: float,
                cfg: BlendConfig, row0: float = 0.0) -> BlendOutputs:
    """The blend in plain PyTorch, in per-tile-position form: step k
    updates every pixel with instance `tile_start[tile(pixel)] + k`, masked
    past `tile_stop`.  Only in-range instances touch a pixel, so this is
    the oracle's scan in the order each pixel sees it.  Outputs are
    (Hp, Wp, C) images."""
    dev = feats.device
    f32 = torch.float32
    B = cfg.buffer_len
    geo = cfg.render_geo or cfg.depth_only
    tiles_x = Wp // cfg.tile_w
    N = Hp * Wp
    xs = torch.arange(Wp, device=dev)
    ys = torch.arange(Hp, device=dev)
    px = xs.to(f32).repeat(Hp)
    py = ys.to(f32).repeat_interleave(Wp) + row0
    ray_x = (px - cx) / device_scalar(fx, dev)
    ray_y = (py - cy) / device_scalar(fy, dev)
    tile_of_pix = ((ys // cfg.tile_h)[:, None] * tiles_x
                   + (xs // cfg.tile_w)[None, :]).reshape(-1)
    start = tile_start.long()[tile_of_pix]
    length = tile_stop.long()[tile_of_pix] - start
    n_feat = feats.shape[0]

    T = torch.ones(N, dtype=f32, device=dev)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    C = torch.zeros(N, 3, dtype=f32, device=dev)
    nrm = torch.zeros(N, 3, dtype=f32, device=dev)
    before_ptr = torch.zeros(N, dtype=torch.int32, device=dev)
    below_cnt = torch.zeros(N, dtype=torch.int32, device=dev)
    bd = torch.zeros(N, B, dtype=f32, device=dev)
    bw = torch.zeros(N, B, dtype=f32, device=dev)
    bcontrib = torch.zeros(N, B, dtype=torch.int32, device=dev)
    last = torch.zeros(N, dtype=torch.int32, device=dev)
    slots = torch.arange(B, dtype=torch.int32, device=dev)

    max_len = int(length.max()) if N and n_feat else 0
    for k in range(max_len):
        if k % 32 == 0 and bool(done.all()):
            break
        in_range = (k < length) & ~done
        f = feats[torch.clamp(start + k, max=n_feat - 1)]
        pos = k + 1
        dx = f[:, FX] - px
        dy = f[:, FY] - py
        power = (-0.5 * (f[:, FCA] * dx * dx + f[:, FCC] * dy * dy)
                 - f[:, FCB] * dx * dy)
        alpha = torch.clamp(f[:, FOP] * torch.exp(torch.clamp(power, max=0.0)),
                            max=bc.ALPHA_CLAMP)
        ok = in_range & (power <= 0.0) & (alpha >= bc.ALPHA_MIN)
        test_t = T * (1.0 - alpha)
        crossing = test_t < bc.T_STOP
        contribute = ok & ~crossing
        done = done | (ok & crossing)
        a_t = torch.where(contribute, alpha * T, 0.0)

        if not cfg.depth_only:
            C = C + f[:, FR:FB + 1] * a_t[:, None]

        if geo:
            denom = (f[:, FNX] * ray_x + f[:, FNY] * ray_y + f[:, FNZ]
                     + bc.PLANE_EPS)
            depth_i = -f[:, FD] / denom
            has_depth = contribute & (depth_i > 0.0)
            push_before = has_depth & (T > 0.5)
            push_below = has_depth & (T <= 0.5) & (below_cnt < cfg.below_cap)
            slot = torch.where(push_before, before_ptr,
                               cfg.before_cap + below_cnt)
            push = push_before | push_below
            onehot = push[:, None] & (slot[:, None] == slots[None, :])
            bd = torch.where(onehot, depth_i[:, None], bd)
            bw = torch.where(onehot, a_t[:, None], bw)
            bcontrib = torch.where(onehot, pos, bcontrib)
            before_ptr = torch.where(push_before,
                                     (before_ptr + 1) % cfg.before_cap,
                                     before_ptr)
            below_cnt = below_cnt + push_below.to(torch.int32)
            if cfg.depth_only:
                done = done | (has_depth & (below_cnt == cfg.below_cap))

        if cfg.render_geo and not cfg.depth_only:
            nrm = nrm + f[:, FNX:FNZ + 1] * a_t[:, None]

        T = torch.where(contribute, test_t, T)
        last = torch.where(contribute, pos, last)

    return BlendOutputs(
        color=C.reshape(Hp, Wp, 3), normal=nrm.reshape(Hp, Wp, 3),
        final_t=T.reshape(Hp, Wp), n_contrib=last.reshape(Hp, Wp),
        buf_depth=bd.reshape(Hp, Wp, B), buf_weight=bw.reshape(Hp, Wp, B),
        buf_contrib=bcontrib.reshape(Hp, Wp, B))


def _check_inputs(feats, tile_start, tile_stop, Wp, Hp, cfg):
    if feats.dtype != torch.float32 or feats.dim() != 2 \
            or not N_READ <= feats.shape[1] <= CF:
        raise ValueError(f"blend: feats must be float32 (n, {N_READ}..{CF}), "
                         f"got {feats.dtype} {tuple(feats.shape)}")
    if Wp % cfg.tile_w or Hp % cfg.tile_h:
        raise ValueError(f"blend: {Wp}x{Hp} is not a multiple of the "
                         f"{cfg.tile_w}x{cfg.tile_h} tile")
    num_tiles = (Wp // cfg.tile_w) * (Hp // cfg.tile_h)
    for name, t in (("tile_start", tile_start), ("tile_stop", tile_stop)):
        if t.dtype != torch.int32 or t.shape != (num_tiles,):
            raise ValueError(f"blend: {name} must be int32 ({num_tiles},), "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != feats.device:
            raise ValueError(f"blend: {name} is on {t.device}, feats on "
                             f"{feats.device}")
    if not 1 <= cfg.buffer_len <= bc.MAX_BUFFER:
        raise ValueError(f"blend: buffer_len must be in 1..{bc.MAX_BUFFER}")


def blend_fwd_cuda(feats: torch.Tensor, tile_start: torch.Tensor,
                   tile_stop: torch.Tensor, Wp: int, Hp: int,
                   fx: float, fy: float, cx: float, cy: float,
                   cfg: BlendConfig, row0: float = 0.0) -> BlendOutputs:
    """Launch the CUDA blend forward on the current stream: the tile-order
    pre-pass and the blend kernel (csrc/blend_fwd.cu), one launch of
    `_cuda.blend_fwd`."""
    _check_inputs(feats, tile_start, tile_stop, Wp, Hp, cfg)
    if feats.device.type != "cuda":
        raise ValueError(f"blend_fwd_cuda: tensors must be on a CUDA device, "
                         f"got {feats.device}")
    splits = sub_tile_split(cfg.tile_h, cfg.tile_w, FWD_CTA)
    feats = feats.contiguous()
    tile_start = tile_start.contiguous()
    tile_stop = tile_stop.contiguous()
    dev = feats.device
    B = cfg.buffer_len
    f32, i32 = torch.float32, torch.int32
    out = BlendOutputs(
        color=torch.empty(Hp, Wp, 3, dtype=f32, device=dev),
        normal=torch.empty(Hp, Wp, 3, dtype=f32, device=dev),
        final_t=torch.empty(Hp, Wp, dtype=f32, device=dev),
        n_contrib=torch.empty(Hp, Wp, dtype=i32, device=dev),
        buf_depth=torch.empty(Hp, Wp, B, dtype=f32, device=dev),
        buf_weight=torch.empty(Hp, Wp, B, dtype=f32, device=dev),
        buf_contrib=torch.empty(Hp, Wp, B, dtype=i32, device=dev))
    _cuda.blend_fwd(feats, tile_start, tile_stop, Wp // cfg.tile_w,
                    Hp // cfg.tile_h, cfg.tile_h, cfg.tile_w, splits, fx, fy,
                    cx, cy, row0, B, mode_of(cfg), out,
                    torch.empty(tile_start.numel(), dtype=i32, device=dev))
    return out


def _tile_major(x: torch.Tensor, tiles_y: int, tiles_x: int, th: int,
                tw: int) -> torch.Tensor:
    """(Hp, Wp, ...) image → (num_tiles·th·tw, ...) pixels, tile by tile,
    row-major inside each tile."""
    rest = x.shape[2:]
    return (x.reshape(tiles_y, th, tiles_x, tw, *rest).transpose(1, 2)
            .reshape(tiles_y * tiles_x * th * tw, *rest))


def blend_bwd_plain(feats: torch.Tensor, tile_start: torch.Tensor,
                    tile_stop: torch.Tensor, Wp: int, Hp: int,
                    fx: float, fy: float, cx: float, cy: float,
                    cfg: BlendConfig, saved: BlendOutputs, cts,
                    row0: float = 0.0,
                    stats: Optional[dict] = None) -> torch.Tensor:
    """The blend VJP in plain PyTorch, in per-tile-position form.

    `saved` holds the uncropped forward outputs, `cts` the cotangents
    (dcolor (Hp,Wp,3), dnormal (Hp,Wp,3), dT (Hp,Wp), dbuf_depth (Hp,Wp,B),
    dbuf_weight (Hp,Wp,B)).  Step k re-walks instance `tile_start[tile]+k`
    for every pixel of the tile, carrying T, the colour+normal prefix Pc
    and the buffer prefix Qle, and reduces the step's per-pixel terms over
    the tile's pixels with a fixed-order sum.  An instance contributes
    where it passes the alpha gate, lies in its tile's range and sits at
    or before the pixel's saved `n_contrib`.  The walk stops at
    `start + max(n_contrib)` of each tile.  Returns the (n, 16) float32
    gradient table in the column layout FX..FPAD; rows the walk never
    reaches are zero.  A `stats` dict, when given, receives the number of
    contributing (pixel, instance) pairs under "contrib_pairs"."""
    dev = feats.device
    f32 = torch.float32
    geo = cfg.render_geo
    th, tw = cfg.tile_h, cfg.tile_w
    tiles_x, tiles_y = Wp // tw, Hp // th
    num_tiles, NP = tiles_x * tiles_y, th * tw
    n = feats.shape[0]
    out = torch.zeros(n, CF, dtype=f32, device=dev)
    if cfg.depth_only or n == 0 or num_tiles == 0:
        return out

    def tm(x):
        return _tile_major(x, tiles_y, tiles_x, th, tw)

    dLc, dLn, dLt, dLbd, dLbw = (tm(c) for c in cts)
    color, normal, Tf = tm(saved.color), tm(saved.normal), tm(saved.final_t)
    nc = tm(saved.n_contrib).long()
    tile = torch.arange(num_tiles, device=dev).repeat_interleave(NP)
    local = torch.arange(NP, device=dev).repeat(num_tiles)
    px = ((tile % tiles_x) * tw + local % tw).to(f32)
    py = ((tile // tiles_x) * th + local // tw).to(f32) + row0
    ray_x = (px - cx) / device_scalar(fx, dev)
    ray_y = (py - cy) / device_scalar(fy, dev)
    start_t = tile_start.long()
    eff_t = torch.clamp(torch.minimum(tile_stop.long() - start_t,
                                      nc.reshape(num_tiles, NP).amax(1)),
                        min=0)
    start, eff = start_t[tile], eff_t[tile]

    TOTcn = color[:, 0] * dLc[:, 0] + color[:, 1] * dLc[:, 1] \
        + color[:, 2] * dLc[:, 2]
    if geo:
        TOTcn = TOTcn + (normal[:, 0] * dLn[:, 0] + normal[:, 1] * dLn[:, 1]
                         + normal[:, 2] * dLn[:, 2])
        bcN = tm(saved.buf_contrib).long()
        gS = dLbw * tm(saved.buf_weight)
        TOTQ = gS[:, 0]
        for b in range(1, cfg.buffer_len):
            TOTQ = TOTQ + gS[:, b]
    zero = torch.zeros(num_tiles * NP, dtype=f32, device=dev)
    T = torch.ones_like(zero)
    Pc = torch.zeros_like(zero)
    Qle = torch.zeros_like(zero)

    for k in range(int(eff_t.max())):
        f = feats[torch.clamp(start + k, max=n - 1)]
        pos = k + 1
        dx = f[:, FX] - px
        dy = f[:, FY] - py
        power = (-0.5 * (f[:, FCA] * dx * dx + f[:, FCC] * dy * dy)
                 - f[:, FCB] * dx * dy)
        g = torch.exp(torch.clamp(power, max=0.0))
        raw = f[:, FOP] * g
        alpha = torch.clamp(raw, max=bc.ALPHA_CLAMP)
        contrib = ((power <= 0.0) & (alpha >= bc.ALPHA_MIN) & (k < eff)
                   & (pos <= nc))
        if stats is not None:
            stats["contrib_pairs"] = (stats.get("contrib_pairs", 0)
                                      + int(contrib.sum()))
        a_c = torch.where(contrib, alpha, 0.0)
        w = torch.where(contrib, alpha * T, 0.0)
        om_a = 1.0 - a_c
        cndl = (f[:, FR] * dLc[:, 0] + f[:, FG] * dLc[:, 1]
                + f[:, FB] * dLc[:, 2])
        if geo:
            cndl = cndl + (f[:, FNX] * dLn[:, 0] + f[:, FNY] * dLn[:, 1]
                           + f[:, FNZ] * dLn[:, 2])
        Pc = Pc + w * cndl
        dLa = cndl * T - (TOTcn - Pc) / om_a + dLt * (-Tf / om_a)
        if geo:
            # at most one buffer slot holds a given position
            eq = bcN == pos
            dd = torch.where(eq, dLbd, 0.0).sum(-1)
            gw = torch.where(eq, dLbw, 0.0).sum(-1)
            Qle = Qle + torch.where(eq, gS, 0.0).sum(-1)
            dLa = dLa + (gw * T - (TOTQ - Qle) / om_a)
            inv_den = 1.0 / (f[:, FNX] * ray_x + f[:, FNY] * ray_y
                             + f[:, FNZ] + bc.PLANE_EPS)
            d_dist = dd * (-inv_den)
            coef = dd * f[:, FD] * inv_den * inv_den
            geo_cols = [w * dLn[:, 0] + coef * ray_x,
                        w * dLn[:, 1] + coef * ray_y,
                        w * dLn[:, 2] + coef, d_dist]
        else:
            geo_cols = [zero] * 4
        dLa = torch.where(contrib, dLa, 0.0)
        live = (raw < bc.ALPHA_CLAMP).to(f32)
        gg = g * f[:, FOP] * dLa * live
        dmx = -(f[:, FCA] * dx + f[:, FCB] * dy) * gg
        dmy = -(f[:, FCC] * dy + f[:, FCB] * dx) * gg
        cols = [dmx, dmy, -0.5 * dx * dx * gg, -dx * dy * gg,
                -0.5 * dy * dy * gg, g * dLa * live,
                w * dLc[:, 0], w * dLc[:, 1], w * dLc[:, 2],
                *geo_cols, dmx.abs(), dmy.abs()]
        sums = torch.stack(cols, 1).reshape(num_tiles, NP, FAY + 1).sum(1)
        walked = k < eff_t
        out[start_t[walked] + k, :FAY + 1] = sums[walked]
        T = T * om_a
    return out


def _check_bwd(saved: BlendOutputs, cts, Wp: int, Hp: int, B: int, dev):
    want = {"color": 3, "normal": 3, "final_t": None, "n_contrib": None,
            "buf_depth": B, "buf_weight": B, "buf_contrib": B}
    for name, c in want.items():
        t = getattr(saved, name)
        if tuple(t.shape) != ((Hp, Wp) if c is None else (Hp, Wp, c)) \
                or t.device != dev:
            raise ValueError(f"blend_bwd: saved {name} is {tuple(t.shape)} "
                             f"on {t.device}; padded image {Hp}x{Wp} on {dev}")
    for name, c, trail in zip(("dcolor", "dnormal", "dT", "dbuf_depth",
                               "dbuf_weight"), cts, (3, 3, None, B, B)):
        shape = (Hp, Wp) if trail is None else (Hp, Wp, trail)
        if c.dtype != torch.float32 or tuple(c.shape) != shape \
                or c.device != dev:
            raise ValueError(f"blend_bwd: {name} must be float32 {shape} on "
                             f"{dev}, got {c.dtype} {tuple(c.shape)} on "
                             f"{c.device}")


def blend_bwd_cuda(feats: torch.Tensor, tile_start: torch.Tensor,
                   tile_stop: torch.Tensor, Wp: int, Hp: int,
                   fx: float, fy: float, cx: float, cy: float,
                   cfg: BlendConfig, saved: BlendOutputs, cts,
                   row0: float = 0.0) -> torch.Tensor:
    """Launch the CUDA blend backward on the current stream: the tile-order
    pre-pass and the backward kernel (csrc/blend_bwd.cu), one launch of
    `_cuda.blend_bwd`.  Returns the (n, 16) gradient table (rows the walk
    never reaches are zero)."""
    _check_inputs(feats, tile_start, tile_stop, Wp, Hp, cfg)
    _check_bwd(saved, cts, Wp, Hp, cfg.buffer_len, feats.device)
    if feats.device.type != "cuda":
        raise ValueError(f"blend_bwd_cuda: tensors must be on a CUDA device, "
                         f"got {feats.device}")
    if cfg.depth_only:
        raise ValueError("blend_bwd_cuda: depth_only has no backward")
    splits = sub_tile_split(cfg.tile_h, cfg.tile_w, BWD_CTA)
    S = splits[0] * splits[1]
    c = [t.contiguous() for t in (*_tensors(saved), *cts)]
    feats = feats.contiguous()
    dev = feats.device
    n, f32 = feats.shape[0], torch.float32
    out = torch.zeros(n, CF, dtype=f32, device=dev)
    # per-sub-tile rows, summed in sub-tile order by each tile's last CTA
    scratch = torch.empty(S, n, CF, dtype=f32, device=dev) if S > 1 else None
    workspace = torch.empty(tile_start.numel() * (2 + S), dtype=torch.int32,
                            device=dev)
    _cuda.blend_bwd(feats, tile_start.contiguous(), tile_stop.contiguous(),
                    Wp // cfg.tile_w, Hp // cfg.tile_h, cfg.tile_h,
                    cfg.tile_w, splits, fx, fy, cx, cy, row0, cfg.buffer_len,
                    mode_of(cfg), c[:7], c[7:], out, scratch, workspace)
    return out


def _tensors(out: BlendOutputs) -> tuple:
    return tuple(getattr(out, f.name) for f in dataclasses.fields(out))


class _BlendFunction(torch.autograd.Function):
    """The blend as one differentiable op of the instance table, with the
    contract of the JAX package's `_blend_core` / `_blend_bwd_rule`: the 7
    uncropped forward outputs are saved (the crop stays outside), the
    integer outputs are not differentiable, a missing cotangent is zero,
    `depth_only` has a zero gradient and launches nothing, and gradient
    rows at or past `tile_stop[-1]` are zero."""

    @staticmethod
    def forward(ctx, feats, tile_start, tile_stop, Wp, Hp, fx, fy, cx, cy,
                cfg, row0):
        args = (feats, tile_start, tile_stop, Wp, Hp, fx, fy, cx, cy, cfg,
                row0)
        if feats.device.type == "cpu":
            _check_inputs(feats, tile_start, tile_stop, Wp, Hp, cfg)
            out = blend_plain(*args)
        else:
            out = blend_fwd_cuda(*args)
        outs = _tensors(out)
        ctx.mark_non_differentiable(out.n_contrib, out.buf_contrib)
        ctx.save_for_backward(feats, tile_start, tile_stop, *outs)
        ctx.geom = (Wp, Hp, fx, fy, cx, cy, cfg)
        ctx.row0 = row0
        return outs

    @staticmethod
    def backward(ctx, d_color, d_normal, d_t, _d_nc, d_bd, d_bw, _d_bc):
        feats, tile_start, tile_stop, *outs = ctx.saved_tensors
        cfg = ctx.geom[6]
        n, C = feats.shape
        if cfg.depth_only or tile_stop.numel() == 0:
            return (torch.zeros_like(feats),) + (None,) * 10
        bwd = blend_bwd_plain if feats.device.type == "cpu" else blend_bwd_cuda
        g = bwd(feats, tile_start, tile_stop, *ctx.geom, BlendOutputs(*outs),
                (d_color, d_normal, d_t, d_bd, d_bw), ctx.row0)
        valid = torch.arange(n, device=feats.device) < tile_stop[-1]
        return (torch.where(valid[:, None], g[:, :C], 0.0),) + (None,) * 10


def blend_packed(feats_inst: torch.Tensor, bins, Wp: int, Hp: int,
                 fx: float, fy: float, cx: float, cy: float,
                 cfg: BlendConfig, row0: float = 0.0) -> BlendOutputs:
    """Blend from a packed (n, C) per-instance table, 13 <= C <= 16, in the
    column layout FX..FAY of the JAX package; differentiable w.r.t. the
    table (its gradient is the first C columns of the backward's rows).
    `bins` supplies the int32 `tile_start` / `tile_stop` ranges.  CUDA
    tensors go through the kernels; CPU tensors through the plain
    versions."""
    with profiling.annotate("blend"):
        return BlendOutputs(*_BlendFunction.apply(
            feats_inst, bins.tile_start, bins.tile_stop, Wp, Hp, float(fx),
            float(fy), float(cx), float(cy), cfg, float(row0)))
