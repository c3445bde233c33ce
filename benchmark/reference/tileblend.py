"""The blend of the reference, vectorised over each tile's instances.

The same semantics as the port's per-pixel walk (`blend.blend_plain`):
front-to-back compositing of the tile's depth-sorted instances with
alpha = min(0.99, op·exp(min(power, 0))), the gate power <= 0 and alpha
>= 1/255, an exclusive stop once T·(1 - alpha) < 1e-4, plane depths into
the two-part median buffer (a circular "before" part while T > 0.5, a
write-once "below" part after, last writer wins per slot) and, in
depth_only mode, a stop once the below part fills (the filling instance
still counts).  Instead of one step per instance position, tiles of
similar length are taken in groups and their instances in chunks of
positions: within a chunk the transmittance before each instance is the
exclusive running product of (1 - alpha) over the instances that
contribute, the first crossing of the stop ends the pixel, and the
buffers' writers are found by running counts.  The running product is a
scan, so T may differ from the walk's sequential product in the last
bits.  The gradient is torch autograd of this forward, each chunk
recomputed in the backward (`torch.utils.checkpoint`), so memory holds
one chunk at a time.  It reads the table's first 13 columns; the walk's
VJP also fills the FAX / FAY columns with each instance's absolute
screen-gradient sums for the densification statistics, which are no
gradient of the forward and which the reference does not compute.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference import blend_common as bc
from benchmark.reference.blend_common import BlendConfig, BlendOutputs
from benchmark.reference.camera import device_scalar

FX, FY, FCA, FCB, FCC, FOP, FR, FG, FB, FNX, FNY, FNZ, FD = range(13)
ELEMENTS = 1 << 25        # (pixel, instance) pairs of one chunk
GROUP_TILES = 128


def _excl_cumprod(x):
    one = torch.ones_like(x[..., :1])
    return torch.cat([one, torch.cumprod(x[..., :-1], -1)], -1)


def _excl_cumsum(x):
    c = torch.cumsum(x, -1)
    return c - x


def _chunk(f, valid, kpos, px, py, ray_x, ray_y, state, cfg: BlendConfig):
    """One chunk of K instance positions for a group of g tiles.  f: (g,
    K, 13) instance rows, valid: (g, K) in range, kpos: (K,) positions
    (0-based), px / py / rays: (g, NP).  state: (T, C, N, bd, bw, done,
    last, bcn, before_ptr, below_cnt)."""
    T, C, Nrm, bd, bw, done, last, bcn, bptr, bcnt = state
    geo = cfg.render_geo or cfg.depth_only
    B, bcap, lcap = cfg.buffer_len, cfg.before_cap, cfg.below_cap
    fx_ = f[:, None, :, :]                                   # (g,1,K,13)
    dx = fx_[..., FX] - px[..., None]
    dy = fx_[..., FY] - py[..., None]
    power = (-0.5 * (fx_[..., FCA] * dx * dx + fx_[..., FCC] * dy * dy)
             - fx_[..., FCB] * dx * dy)
    alpha = torch.clamp(fx_[..., FOP] * torch.exp(torch.clamp(power,
                                                              max=0.0)),
                        max=bc.ALPHA_CLAMP)
    ok = (valid[:, None, :] & (power <= 0.0) & (alpha >= bc.ALPHA_MIN)
          & ~done[..., None])
    om = torch.where(ok, 1.0 - alpha, 1.0)
    P = T[..., None] * _excl_cumprod(om)
    crossing = ok & (P * (1.0 - alpha) < bc.T_STOP)
    before_cross = torch.cumsum(crossing.to(torch.int32), -1) == 0
    contribute = ok & before_cross
    crossed = crossing.any(-1)

    filled = torch.zeros_like(done)
    if geo:
        denom = (fx_[..., FNX] * ray_x[..., None] + fx_[..., FNY]
                 * ray_y[..., None] + fx_[..., FNZ] + bc.PLANE_EPS)
        depth_i = -fx_[..., FD] / denom
        if cfg.depth_only:
            cand = contribute & (depth_i > 0.0) & (P <= 0.5)
            idx = bcnt[..., None] + _excl_cumsum(cand.to(torch.int32))
            fill = cand & (idx == lcap - 1)
            after = _excl_cumsum(fill.to(torch.int32)) > 0
            contribute = contribute & ~after
            filled = fill.any(-1)
    a_t = torch.where(contribute, alpha * P, 0.0)
    T_new = T * torch.where(contribute, om, 1.0).prod(-1)
    if not cfg.depth_only:
        C = C + torch.bmm(a_t, f[..., FR:FB + 1])
    if cfg.render_geo and not cfg.depth_only:
        Nrm = Nrm + torch.bmm(a_t, f[..., FNX:FNZ + 1])
    pos = (kpos + 1).to(torch.int32)
    last = torch.maximum(last, torch.where(contribute, pos, 0).amax(-1))

    if geo:
        has = contribute & (depth_i > 0.0)
        push_b = has & (P > 0.5)
        cand = has & (P <= 0.5)
        bidx = bcnt[..., None] + _excl_cumsum(cand.to(torch.int32))
        push_l = cand & (bidx < lcap)
        cb = bptr[..., None] + _excl_cumsum(push_b.to(torch.int32))
        slot = torch.where(push_b, cb % bcap,
                           torch.where(push_l, bcap + bidx, B))
        bd_cols, bw_cols, bc_cols = [], [], []
        K = f.shape[1]
        kk = torch.arange(K, device=f.device)
        for s in range(B):
            m = slot == s
            any_m = m.any(-1)
            k_s = torch.where(m, kk, -1).amax(-1).clamp(min=0)   # last
            d_s = depth_i.expand_as(m).gather(-1, k_s[..., None])[..., 0]
            w_s = a_t.gather(-1, k_s[..., None])[..., 0]
            bd_cols.append(torch.where(any_m, d_s, bd[..., s]))
            bw_cols.append(torch.where(any_m, w_s, bw[..., s]))
            bc_cols.append(torch.where(any_m, pos[k_s], bcn[..., s]))
        bd = torch.stack(bd_cols, -1)
        bw = torch.stack(bw_cols, -1)
        bcn = torch.stack(bc_cols, -1)
        bptr = (bptr + push_b.sum(-1, dtype=torch.int32)) % bcap
        bcnt = bcnt + push_l.sum(-1, dtype=torch.int32)
    done = done | crossed | filled
    return (T_new, C, Nrm, bd, bw, done, last, bcn, bptr, bcnt,
            contribute.sum())


def blend_tiles(feats: torch.Tensor, tile_start: torch.Tensor,
                tile_stop: torch.Tensor, Wp: int, Hp: int, fx: float,
                fy: float, cx: float, cy: float, cfg: BlendConfig,
                row0: float = 0.0, counts: dict = None) -> BlendOutputs:
    """The blend of the (n, >=13) instance table over each tile's range
    [tile_start, tile_stop); (Hp, Wp, ...) outputs, differentiable w.r.t.
    `feats`.  `counts`, when given, receives the contributing pairs
    ("contrib", a 0-dim tensor)."""
    dev = feats.device
    f32, i32 = torch.float32, torch.int32
    th, tw = cfg.tile_h, cfg.tile_w
    tiles_x, tiles_y = Wp // tw, Hp // th
    NT, NP, B = tiles_x * tiles_y, th * tw, cfg.buffer_len
    n = feats.shape[0]
    start = tile_start.long()
    length = torch.clamp(tile_stop.long() - start, min=0)
    tile = torch.arange(NT, device=dev)
    local = torch.arange(NP, device=dev)
    px = ((tile % tiles_x) * tw)[:, None] + (local % tw)[None, :]
    py = ((tile // tiles_x) * th)[:, None] + (local // tw)[None, :]
    px, py = px.to(f32), py.to(f32) + row0
    ray_x = (px - cx) / device_scalar(fx, dev)
    ray_y = (py - cy) / device_scalar(fy, dev)
    table = feats[:, :13]

    order = torch.argsort(length, descending=True, stable=True)
    lens = length[order].tolist()
    outs, contrib = [], torch.zeros((), dtype=torch.int64, device=dev)
    for g0 in range(0, NT, GROUP_TILES):
        G = order[g0:g0 + GROUP_TILES]
        g = G.shape[0]
        L = lens[g0]
        state = (torch.ones(g, NP, dtype=f32, device=dev),
                 torch.zeros(g, NP, 3, dtype=f32, device=dev),
                 torch.zeros(g, NP, 3, dtype=f32, device=dev),
                 torch.zeros(g, NP, B, dtype=f32, device=dev),
                 torch.zeros(g, NP, B, dtype=f32, device=dev),
                 torch.zeros(g, NP, dtype=torch.bool, device=dev),
                 torch.zeros(g, NP, dtype=i32, device=dev),
                 torch.zeros(g, NP, B, dtype=i32, device=dev),
                 torch.zeros(g, NP, dtype=i32, device=dev),
                 torch.zeros(g, NP, dtype=i32, device=dev))
        K = max(8, min(512, ELEMENTS // (g * NP)))
        gpx, gpy, grx, gry = px[G], py[G], ray_x[G], ray_y[G]
        for k0 in range(0, L, K):
            kpos = torch.arange(k0, min(L, k0 + K), device=dev)
            valid = kpos[None, :] < length[G][:, None]
            idx = torch.clamp(start[G][:, None] + kpos[None, :], max=n - 1)
            f = table[idx]
            args = (f, valid, kpos, gpx, gpy, grx, gry, state, cfg)
            if f.requires_grad:
                res = checkpoint(_chunk, *args, use_reentrant=False)
            else:
                res = _chunk(*args)
            state, contrib = res[:10], contrib + res[10]
        outs.append(state)
    inv = torch.argsort(order)

    def image(k):
        x = torch.cat([o[k] for o in outs])[inv]          # (NT, NP, ...)
        rest = x.shape[2:]
        return (x.reshape(tiles_y, tiles_x, th, tw, *rest).transpose(1, 2)
                .reshape(Hp, Wp, *rest))

    if counts is not None:
        counts["contrib"] = contrib
    return BlendOutputs(color=image(1), normal=image(2), final_t=image(0),
                        n_contrib=image(6), buf_depth=image(3),
                        buf_weight=image(4), buf_contrib=image(7))
