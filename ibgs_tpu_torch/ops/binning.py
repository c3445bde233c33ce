"""Tile binning, depth ordering and instance assembly (counterpart of
ibgs_tpu/ops/binning.py).

The JAX package expands Gaussians into tile instances inside static
capacities with a head-scatter + cummax machinery, because XLA needs
static shapes.  PyTorch runs eagerly, so the port sizes every instance
list exactly with `repeat_interleave`.  When a `cap` or `row_cap` is given
it keeps the JAX package's prefix-truncation semantics: slots are assigned
in depth-rank order and the deepest Gaussians' slots are the ones dropped;
`n_instances` / `n_rows` report the pre-truncation totals.

Instance order is (tile, pre-sort slot): one stable sort by tile id, with
slots already in depth order.  `tile_start` / `tile_stop` are the per-tile
[start, stop) ranges that the blend reads.  The slots of one Gaussian are
contiguous before the sort ([seg_off[r], seg_off[r+1]) for depth rank r),
which `pack_rows`' backward turns into deterministic segment sums.

The staircase path has two versions of one algorithm, chosen by the
tensors' device alone: on CPU tensors the plain torch version
(`bin_staircase_plain`), on CUDA tensors the hand-written kernels
of csrc/binning.cu (`bin_staircase_cuda`, launched through `_cuda`), bit for
bit the same TileBins in 12 device events and one host read a render
(their own radix sorts in place of the plain version's `torch.sort`s).
There is no fallback: a CUDA input the kernels do not take raises.  The
AABB path and `pack_rows` are torch code on both devices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ibgs_tpu_torch.ops import _cuda
from ibgs_tpu_torch.ops.preprocess import Splats2D, to_i32
from ibgs_tpu_torch.utils import profiling

_I32_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class TileBins:
    order: torch.Tensor       # (P,) int64 gaussian ids in depth order
    rank: torch.Tensor        # (n,) int64 depth rank of each sorted instance
    gauss_id: torch.Tensor    # (n,) int64 gaussian id (= order[rank])
    tile_id: torch.Tensor     # (n,) int64 owning tile (num_tiles = culled)
    inst_valid: torch.Tensor  # (n,) bool
    tile_start: torch.Tensor  # (num_tiles,) int32
    tile_stop: torch.Tensor   # (num_tiles,) int32
    n_instances: int          # total (pre-truncation) instance count
    slot: torch.Tensor        # (n,) int64 pre-sort slot of each sorted row
    seg_off: torch.Tensor     # (P+1,) int64 slot range of depth rank r =
    #                           [seg_off[r], seg_off[r+1]) (may pass n)
    n_rows: int = 0           # staircase row count (0 = AABB path)


def tile_ranges_from_sorted(tile_sorted: torch.Tensor, num_tiles: int,
                            n_valid: int):
    """[start, stop) index ranges per tile from a tile-id-sorted instance
    list (ids >= num_tiles mark culled rows sorted to the end)."""
    probes = torch.arange(num_tiles + 1, dtype=tile_sorted.dtype,
                          device=tile_sorted.device)
    start = torch.searchsorted(tile_sorted, probes, side="left")
    start[num_tiles] = torch.clamp(start[num_tiles], max=n_valid)
    start = start.to(torch.int32)
    return start[:num_tiles], start[1:]


def _depth_order(sp: Splats2D) -> torch.Tensor:
    """Stable depth ranking; culled splats sort last."""
    key = torch.where(sp.n_tiles > 0, sp.depth,
                      torch.full_like(sp.depth, float("inf")))
    return torch.sort(key, stable=True).indices


def _expand(counts: torch.Tensor, cap: int):
    """Owner index of every slot of a run-length list, truncated to `cap`
    slots (0 = no cap), plus the exclusive offsets and the full total."""
    total = int(counts.sum())
    n = min(total, cap) if cap else total
    owner = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts,
        output_size=total)[:n]
    offsets = torch.cumsum(counts, 0) - counts
    return owner, offsets, total


def _finish(tile, rank, order, num_tiles, n_valid, total, seg_off,
            n_rows=0):
    tile_sorted, perm = torch.sort(tile, stable=True)
    rank_sorted = rank[perm]
    start, stop = tile_ranges_from_sorted(tile_sorted, num_tiles, n_valid)
    return TileBins(
        order=order, rank=rank_sorted, gauss_id=order[rank_sorted],
        tile_id=tile_sorted, inst_valid=tile_sorted < num_tiles,
        tile_start=start, tile_stop=stop, n_instances=total, slot=perm,
        seg_off=seg_off, n_rows=n_rows)


def _staircase_row_interval(ca, cb, cc, thr, v_lo, v_hi, tile_w, mx, rx, rw):
    """Kept tile-column interval [lo, lo+w) of one tile row: the closed-form
    u-extent of the sublevel set {q(u,v) <= thr} within the band
    v in [v_lo, v_hi], widened for f32 safety (see the JAX package's
    _staircase_row_interval for the derivation).  Degenerate conics keep
    the full AABB row."""
    thr_m = thr + (1e-3 + 1e-3 * torch.abs(thr))
    det = ca * cc - cb * cb
    safe = (ca > 0.0) & (cc > 0.0) & (det > 0.0) & (thr_m > 0.0)
    ca_s = torch.where(safe, ca, 1.0)
    cc_s = torch.where(safe, cc, 1.0)
    det_s = torch.where(safe, det, 1.0)
    thr_s = torch.where(safe, thr_m, 1.0)
    vstar = -cb * torch.sqrt(2.0 * thr_s / (cc_s * det_s))
    v_at_max = torch.clamp(vstar, v_lo, v_hi)
    v_at_min = torch.clamp(-vstar, v_lo, v_hi)
    disc_max = 2.0 * ca_s * thr_s - det_s * v_at_max * v_at_max
    disc_min = 2.0 * ca_s * thr_s - det_s * v_at_min * v_at_min
    hit = disc_max >= 0.0
    u_max = (-cb * v_at_max + torch.sqrt(torch.clamp(disc_max, min=0.0))) / ca_s
    u_min = (-cb * v_at_min - torch.sqrt(torch.clamp(disc_min, min=0.0))) / ca_s
    u_max = u_max + (1e-3 + 1e-3 * torch.abs(u_max))
    u_min = u_min - (1e-3 + 1e-3 * torch.abs(u_min))
    tx_lo_f = torch.ceil((mx + u_min - (tile_w - 1)) / tile_w)
    tx_hi_f = torch.floor((mx + u_max) / tile_w)
    big = float(1 << 24)
    tx_lo = to_i32(torch.clamp(tx_lo_f, -1.0, big)).long()
    tx_hi = to_i32(torch.clamp(tx_hi_f, -2.0, big)).long()
    lo = torch.maximum(tx_lo, rx)
    hi = torch.minimum(tx_hi, rx + rw - 1)
    w = torch.where(hit, torch.clamp(hi - lo + 1, min=0), 0)
    lo = torch.where(safe, lo, rx)
    w = torch.where(safe, w, rw)
    return lo, w


def bin_staircase_plain(sp: Splats2D, tiles_x: int, tiles_y: int, cap: int,
                        cull_tab: torch.Tensor, tile_h: int, tile_w: int,
                        row_cap: int) -> TileBins:
    """Two-level expansion: gaussians → tile rows → kept tiles.  Each row's
    kept-tile interval is computed before slot assignment, so culled tiles
    never take a slot.  Enumeration order (row-major within each
    gaussian's kept staircase, gaussians in depth order) matches the AABB
    path."""
    num_tiles = tiles_x * tiles_y
    P = sp.depth.shape[0]
    order = _depth_order(sp)
    rx_p = sp.rect_min[:, 0].long()
    ry_p = sp.rect_min[:, 1].long()
    rw_p = torch.clamp((sp.rect_max[:, 0] - sp.rect_min[:, 0]).long(), min=1)
    rh_p = torch.where(sp.n_tiles > 0,
                       (sp.rect_max[:, 1] - sp.rect_min[:, 1]).long(), 0)

    # level 1: rows, owned by gaussian depth ranks
    rh = rh_p[order]
    rrank, offs_r, total_rows = _expand(rh, row_cap)
    gid = order[rrank]
    rslot = torch.arange(rrank.shape[0], device=rh.device)
    ty = ry_p[gid] + (rslot - offs_r[rrank])
    cf = cull_tab[gid]
    v_lo = (ty * tile_h).to(torch.float32) - cf[:, 1]
    lo, w = _staircase_row_interval(
        cf[:, 2], cf[:, 3], cf[:, 4], cf[:, 5], v_lo, v_lo + (tile_h - 1),
        tile_w, cf[:, 0], rx_p[gid], rw_p[gid])

    # level 2: rows → tile instances
    rowrank, offs2, total = _expand(w, cap)
    inst = torch.arange(rowrank.shape[0], device=rh.device)
    tile = (ty * tiles_x + lo)[rowrank] + (inst - offs2[rowrank])
    # a gaussian's rows are contiguous and so are each row's slots: its
    # slot range starts at offs2 of its first row (clipped like row_cap)
    offs2_ext = torch.cat([offs2, offs2.new_tensor([total])])
    first_row = torch.cat([offs_r, offs_r.new_tensor([total_rows])])
    seg_off = offs2_ext[torch.clamp(first_row, 0, rrank.shape[0])]
    return _finish(tile, rrank[rowrank], order, num_tiles, inst.shape[0],
                   total, seg_off, n_rows=total_rows)


def _check_cuda(sp: Splats2D, cull_tab: torch.Tensor, tiles_x: int,
                tiles_y: int, tile_h: int, tile_w: int, cap: int,
                row_cap: int):
    """Raise ValueError on what the binning kernels do not take: a tensor
    of the wrong dtype or shape or not contiguous, a grid, tile size or cap
    out of range, or (checked last) a tensor off the CUDA device of
    `sp.depth`."""
    P = sp.depth.shape[0]
    tensors = (("depth", sp.depth, torch.float32, (P,)),
               ("n_tiles", sp.n_tiles, torch.int32, (P,)),
               ("rect_min", sp.rect_min, torch.int32, (P, 2)),
               ("rect_max", sp.rect_max, torch.int32, (P, 2)),
               ("cull_tab", cull_tab, torch.float32, (P, 6)))
    for name, t, dtype, shape in tensors:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"bin_splats: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"bin_splats: {name} must be contiguous")
    if min(tiles_x, tiles_y, tile_h, tile_w) < 1 or \
            tiles_x * tiles_y >= _I32_MAX or P >= _I32_MAX:
        raise ValueError(f"bin_splats: the kernels take a grid of 1 to "
                         f"2^31 - 2 tiles of at least 1x1 pixels and fewer "
                         f"than 2^31 - 1 splats, got {tiles_x}x{tiles_y} "
                         f"tiles of {tile_h}x{tile_w}, {P} splats")
    if cap < 0 or row_cap < 0:
        raise ValueError(f"bin_splats: cap and row_cap must be >= 0 (0 = no "
                         f"cap), got {cap} and {row_cap}")
    dev = sp.depth.device
    for _, t, _, _ in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"bin_splats: the kernels take tensors on one "
                             f"CUDA device, got {t.device} and {dev}")


def bin_staircase_cuda(sp: Splats2D, tiles_x: int, tiles_y: int, cap: int,
                       cull_tab: torch.Tensor, tile_h: int, tile_w: int,
                       row_cap: int) -> TileBins:
    """`bin_staircase_plain` (same arguments and TileBins, bit for bit) as
    the kernels of csrc/binning.cu on the current stream: a zeroed
    workspace, bin_key and the depth sort's 4 radix passes, bin_count
    (both offsets, the totals), one host read of the totals (the one sync,
    which sizes the lists), bin_emit, the tile sort's passes and
    bin_ranges.  Raises ValueError where a rectangle with rows lies outside
    the grid (the projection's never do; their tile ids would not sort)."""
    _check_cuda(sp, cull_tab, tiles_x, tiles_y, tile_h, tile_w, cap,
                row_cap)
    dev = sp.depth.device
    P = sp.depth.shape[0]
    num_tiles = tiles_x * tiles_y
    grid = (tiles_x, tiles_y, tile_h, tile_w)
    i32, i64 = torch.int32, torch.int64

    def ints(k, m):
        return [torch.empty(k, dtype=i32, device=dev) for _ in range(m)]
    ws = torch.zeros(_cuda.bin_workspace_words(P), dtype=i64, device=dev)
    order = torch.empty(P, dtype=i64, device=dev)
    _cuda.bin_order(sp.depth, sp.n_tiles, ws, ints(P, 4), order)
    seg_off = torch.empty(P + 1, dtype=i64, device=dev)
    kept = torch.empty(P, dtype=i32, device=dev)
    _cuda.bin_count(order, sp, cull_tab, grid, row_cap, ws, seg_off, kept)
    n_rows, total, outside = ws[:3].tolist()
    if outside:
        raise ValueError(f"bin_splats: a tile rectangle with rows lies "
                         f"outside the {tiles_x}x{tiles_y} grid")
    n = min(total, cap) if cap else total
    if n >= _I32_MAX:
        raise ValueError(f"bin_splats: {n} instances, the kernels take "
                         f"fewer than 2^31 - 1")
    state = torch.empty(_cuda.bin_tile_state_words(n, num_tiles),
                        dtype=i64, device=dev)
    tile, slot_rank, tile_sorted, *tile_scratch = ints(n, 6)
    _cuda.bin_emit(order, sp, cull_tab, grid, seg_off, kept, tile,
                   slot_rank, ws, state)
    perm = torch.empty(n, dtype=i64, device=dev)
    _cuda.bin_tiles(tile, num_tiles, P, ws, state, tile_scratch,
                    tile_sorted, perm)
    outs = (torch.empty(n, dtype=i64, device=dev),
            torch.empty(n, dtype=i64, device=dev),
            torch.empty(n, dtype=i64, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(num_tiles + 1, dtype=i32, device=dev))
    _cuda.bin_ranges(tile_sorted, perm, slot_rank, order, num_tiles, outs)
    rank, gauss_id, tile_id, inst_valid, start = outs
    return TileBins(
        order=order, rank=rank, gauss_id=gauss_id, tile_id=tile_id,
        inst_valid=inst_valid, tile_start=start[:num_tiles],
        tile_stop=start[1:], n_instances=total, slot=perm, seg_off=seg_off,
        n_rows=n_rows)


def _bin_splats_staircase(sp: Splats2D, tiles_x: int, tiles_y: int,
                          cap: int, cull_tab: torch.Tensor, tile_h: int,
                          tile_w: int, row_cap: int) -> TileBins:
    """The staircase expansion: the plain version on CPU tensors, the
    kernels on CUDA tensors (which raise on what they do not take)."""
    fn = (bin_staircase_plain if sp.depth.device.type == "cpu"
          else bin_staircase_cuda)
    return fn(sp, tiles_x, tiles_y, cap, cull_tab, tile_h, tile_w, row_cap)


def bin_splats(sp: Splats2D, tiles_x: int, tiles_y: int, cap: int = 0,
               cull_tab: Optional[torch.Tensor] = None,
               tile_h: int = 16, tile_w: int = 16,
               staircase: bool = False, row_cap: int = 0) -> TileBins:
    """Expand, depth-order and tile-sort the splats' instances.

    `cull_tab` (P, 6) f32 [mean_x, mean_y_band, conic_a, conic_b, conic_c,
    ln(255*opacity)] enables the exact per-tile cull: instances whose
    Mahalanobis power exceeds the 1/255 alpha threshold over the whole tile
    are retagged as culled (tile = num_tiles).  With `staircase=True`
    (requires cull_tab) the two-level staircase expansion is used instead.
    `cap` / `row_cap` of 0 mean no cap."""
    with profiling.annotate("binning"):
        if staircase:
            if cull_tab is None:
                raise ValueError("staircase expansion needs cull_tab")
            return _bin_splats_staircase(sp, tiles_x, tiles_y, cap, cull_tab,
                                         tile_h, tile_w, row_cap)
        num_tiles = tiles_x * tiles_y
        order = _depth_order(sp)
        rank, offsets, total = _expand(sp.n_tiles[order].long(), cap)
        gid = order[rank]
        rx = sp.rect_min[gid, 0].long()
        ry = sp.rect_min[gid, 1].long()
        rw = torch.clamp((sp.rect_max[gid, 0] - sp.rect_min[gid, 0]).long(),
                         min=1)
        inst = torch.arange(rank.shape[0], device=rank.device)
        local = inst - offsets[rank]
        tx = rx + local % rw
        ty = ry + local // rw
        tile = ty * tiles_x + tx

        if cull_tab is not None:
            cf = cull_tab[gid]
            mx, my = cf[:, 0], cf[:, 1]
            ca, cb, cc, thr = cf[:, 2], cf[:, 3], cf[:, 4], cf[:, 5]
            # pixel offsets from the mean over this tile's pixel rectangle
            u_lo = (tx * tile_w).to(torch.float32) - mx
            u_hi = u_lo + (tile_w - 1)
            v_lo = (ty * tile_h).to(torch.float32) - my
            v_hi = v_lo + (tile_h - 1)
            inside = ((u_lo <= 0.0) & (u_hi >= 0.0) & (v_lo <= 0.0)
                      & (v_hi >= 0.0))

            def _qu(ue):  # min over the edge u = ue, v in [v_lo, v_hi]
                vs = torch.clamp(-cb * ue / cc, v_lo, v_hi)
                return 0.5 * ca * ue * ue + cb * ue * vs + 0.5 * cc * vs * vs

            def _qv(ve):  # min over the edge v = ve, u in [u_lo, u_hi]
                us = torch.clamp(-cb * ve / ca, u_lo, u_hi)
                return 0.5 * cc * ve * ve + cb * us * ve + 0.5 * ca * us * us

            qmin = torch.minimum(torch.minimum(_qu(u_lo), _qu(u_hi)),
                                 torch.minimum(_qv(v_lo), _qv(v_hi)))
            qmin = torch.where(inside, 0.0, qmin)
            keep = ((qmin <= thr + (1e-3 + 1e-3 * torch.abs(thr)))
                    | (ca <= 0.0) | (cc <= 0.0))
            tile = torch.where(keep, tile, num_tiles)

        seg_off = torch.cat([offsets, offsets.new_tensor([total])])
        return _finish(tile, rank, order, num_tiles, inst.shape[0], total,
                       seg_off)


class _PackRows(torch.autograd.Function):
    """Row gather forward; deterministic segment-sum backward (the JAX
    package's `_pack_rows_bwd`): sorted-row cotangents go back to pre-sort
    slot order through the `slot` permutation (a unique-index copy), a
    cumsum plus a boundary difference over `seg_off` sums each Gaussian's
    slots in depth-rank order, and `order` puts the ranks back in
    Gaussian-id order (another unique-index copy).  No float scatter-add,
    so the gradient does not vary from run to run.  The cumsum runs in
    float64: in float32 the difference of two running sums keeps an error
    of an ulp of the running sum (~6e-8 once it reaches 1), which is
    larger than the net gradient of a Gaussian whose instances cancel."""

    @staticmethod
    def forward(ctx, feats_g, gauss_id, inst_valid, slot, seg_off, order):
        ctx.save_for_backward(inst_valid, slot, seg_off, order)
        out = feats_g.index_select(0, gauss_id)
        return torch.where(inst_valid[:, None], out, 0.0)

    @staticmethod
    def backward(ctx, g):
        inst_valid, slot, seg_off, order = ctx.saved_tensors
        n, C = g.shape
        # (C, n) layout: the scan runs along the contiguous dimension (a
        # scan along dim 0 of (n, C) is one sequential walk per column)
        g_pre = g.new_empty(C, n)
        g_pre[:, slot] = torch.where(inst_valid[:, None], g, 0.0).t()
        f64 = torch.float64
        cums = torch.cat([g.new_zeros(C, 1, dtype=f64),
                          torch.cumsum(g_pre, 1, dtype=f64)], 1)
        cb = cums[:, torch.clamp(seg_off, 0, n)]
        g_out = torch.empty(order.shape[0], C, dtype=g.dtype, device=g.device)
        g_out[order] = (cb[:, 1:] - cb[:, :-1]).t().to(g.dtype)
        return g_out, None, None, None, None, None


def pack_rows(feats_g: torch.Tensor, bins: TileBins) -> torch.Tensor:
    """Instance assembly: (P, C) per-Gaussian rows → (n, C) per-instance
    rows in tile-sorted order (culled rows zeroed); differentiable w.r.t.
    `feats_g` through `_PackRows`."""
    with profiling.annotate("binning"):
        return _PackRows.apply(feats_g, bins.gauss_id, bins.inst_valid,
                               bins.slot, bins.seg_off, bins.order)
