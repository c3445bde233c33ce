"""Blend forward: the plain PyTorch version and the CUDA kernel's wrapper
(counterpart of ibgs_tpu/ops/blend_oracle.py and the forward of
ibgs_tpu/ops/blend_pallas.py).

Per pixel, the exact sequential semantics of the JAX oracle: front-to-back
alpha compositing of the tile's depth-sorted instances with
`alpha = min(0.99, op·exp(min(power, 0)))`, the gate
`power <= 0 && alpha >= 1/255`, an exclusive stop once `T·(1-α) < 1e-4`
(the crossing instance is excluded and ends the pixel), plane-intersection
depths and the two-part median buffer (circular "before" part while
T > 0.5, write-once "below" part after, last writer wins per slot).  In
`depth_only` mode a pixel stops once the below part fills; the filling
instance still counts.

`blend_packed` launches the CUDA kernel (`csrc/blend_fwd.cu`) on CUDA
tensors and runs `blend_plain` on CPU tensors.  There is no fallback: a
CUDA tensor either goes through the kernel or raises.
"""
from __future__ import annotations

import torch

from ibgs_tpu_torch.core.camera import device_scalar
from ibgs_tpu_torch.ops import blend_common as bc
from ibgs_tpu_torch.ops.blend_common import BlendConfig, BlendOutputs

CF = 16             # packed feature channels of the JAX package's table
# feature channel layout (columns of the per-instance table)
FX, FY, FCA, FCB, FCC, FOP, FR, FG, FB, FNX, FNY, FNZ, FD, FAX, FAY, FPAD = range(16)
N_READ = FD + 1     # channels the forward reads

# Kernel launch counts, by kernel name.  Only the wrapper's launch site
# adds to them.
LAUNCHES = {"blend_fwd": 0}


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
    """Launch the CUDA blend-forward kernel on the current stream."""
    from ibgs_tpu_torch.ops import _cuda

    _check_inputs(feats, tile_start, tile_stop, Wp, Hp, cfg)
    if feats.device.type != "cuda":
        raise ValueError(f"blend_fwd_cuda: tensors must be on a CUDA device, "
                         f"got {feats.device}")
    if cfg.tile_h * cfg.tile_w > 1024:
        raise ValueError("blend_fwd_cuda: a tile may hold at most 1024 pixels")
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _cuda.blend_fwd(
            feats, tile_start, tile_stop, Wp // cfg.tile_w, Hp // cfg.tile_h,
            cfg.tile_h, cfg.tile_w, fx, fy, cx, cy, row0, B, mode_of(cfg),
            out, stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: "
                           f"{_cuda.error_string(err)} ({err})")
    LAUNCHES["blend_fwd"] += 1
    return out


def blend_packed(feats_inst: torch.Tensor, bins, Wp: int, Hp: int,
                 fx: float, fy: float, cx: float, cy: float,
                 cfg: BlendConfig, row0: float = 0.0) -> BlendOutputs:
    """Blend from a packed (n, C) per-instance table, 13 <= C <= 16, in the
    column layout FX..FAY of the JAX package.  `bins` supplies the int32
    `tile_start` / `tile_stop` ranges.  CUDA tensors go through the kernel;
    CPU tensors through the plain version."""
    args = (feats_inst, bins.tile_start, bins.tile_stop, Wp, Hp,
            float(fx), float(fy), float(cx), float(cy), cfg, float(row0))
    if feats_inst.device.type == "cpu":
        _check_inputs(*args[:5], cfg)
        return blend_plain(*args)
    return blend_fwd_cuda(*args)
