"""Seeded synthetic scenes for the staircase binning kernels
(csrc/binning.cu) and their plain version, shared by the CPU tests of the
kernels' host build (tests/test_torch_binning_kernels.py) and the card's
tests (tests/test_torch_gpu.py).  numpy and torch only: no JAX.

A scene is the part of a Splats2D that `bin_splats` reads (depth, n_tiles,
rect_min, rect_max) and its (P, 6) cull table, on a grid of
tiles_x x tiles_y tiles of tile_h x tile_w pixels (powers of two, so the
CPU's true division by the tile width and the card's multiply by its
reciprocal agree).  Rectangles are built as the projection builds them:
the tile cover of a 3-sigma box, clipped to the grid, empty where the
splat is culled.  Depths repeat (ties keep the stable order's index
order); "ties" has three depths over 50,000 splats and "pile" puts 20,000
splats on one spot, so the kernels' sorts meet long runs of equal keys
across many CTAs; "fine" has 300 x 256 tiles of 4x4 pixels (tile ids of
three 8-bit digits, rows that cross a multiple of 256 and rows of more
than 256 tiles).
"""
from __future__ import annotations

import numpy as np
import torch

from ibgs_tpu_torch.ops.preprocess import Splats2D

# name: (P, width, height, tile_h, tile_w, row0)
GRIDS = {"random": (3000, 512, 256, 16, 32, 0),
         "caps": (3000, 512, 256, 16, 32, 0),
         "band": (3000, 512, 128, 16, 32, 192),
         "empty": (500, 512, 256, 16, 32, 0),
         "one": (1, 512, 256, 16, 32, 0),
         "edges": (400, 256, 128, 16, 16, 0),
         "degenerate": (800, 256, 128, 8, 16, 0),
         "nonfinite": (800, 256, 128, 8, 16, 0),
         "ties": (50_000, 512, 256, 16, 32, 0),
         "pile": (20_000, 512, 256, 16, 32, 0),
         "fine": (1500, 1200, 1024, 4, 4, 0)}
CASES = list(GRIDS)


def scene(case: str, seed: int = 0, device="cpu"):
    """(sp, cull_tab, tiles_x, tiles_y, tile_h, tile_w) of one case.  In
    "band" the grid is the band of image rows [row0, row0 + height) of a
    768-row image: means in image rows, the cull table's y in band rows."""
    P, W, H, TH, TW, row0 = GRIDS[case]
    r = np.random.default_rng([seed, CASES.index(case)])
    TX, TY = -(-W // TW), -(-H // TH)
    img_h = 768 if case == "band" else H
    if case == "edges":   # around the four edges, large enough to clip
        side = r.integers(0, 4, P)
        mx = np.where(side == 0, r.uniform(-60, 20, P),
                      np.where(side == 1, r.uniform(W - 20, W + 60, P),
                               r.uniform(-60, W + 60, P)))
        my = np.where(side == 2, r.uniform(-60, 20, P),
                      np.where(side == 3, r.uniform(H - 20, H + 60, P),
                               r.uniform(-60, H + 60, P)))
        sig = (8.0, 40.0)
    elif case == "pile":   # one spot: a few tiles hold every instance
        mx = r.uniform(W / 2 - 3, W / 2 + 3, P)
        my = r.uniform(H / 2 - 3, H / 2 + 3, P)
        sig = (2.0, 12.0)
    else:
        mx = r.uniform(-0.05 * W, 1.05 * W, P)
        my = r.uniform(-0.05 * img_h, 1.05 * img_h, P)
        sig = (0.4, 30.0)
    sx = np.exp(r.uniform(np.log(sig[0]), np.log(sig[1]), P))
    sy = np.exp(r.uniform(np.log(sig[0]), np.log(sig[1]), P))
    if case == "fine":   # a few rows wider than 256 tiles
        wide = r.uniform(size=P) < 0.01
        sx[wide] *= 16.0
        sy[wide] *= 16.0
    rho = r.uniform(-0.95, 0.95, P)
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    ca, cb, cc = sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det
    op = r.uniform(0.005, 1.0, P)
    thr = np.log(np.maximum(255.0 * op, 1.000001))
    R = np.ceil(3.0 * np.maximum(sx, sy))
    my_grid = my - row0
    rmin = np.stack([np.clip(np.floor((mx - R) / TW), 0, TX),
                     np.clip(np.floor((my_grid - R) / TH), 0, TY)], 1)
    rmax = np.stack([np.clip(np.floor((mx + R) / TW) + 1, 0, TX),
                     np.clip(np.floor((my_grid + R) / TH) + 1, 0, TY)], 1)
    rmax = np.maximum(rmax, rmin)
    n_tiles = (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1])
    n_tiles[r.uniform(size=P) < 0.1] = 0          # culled by the projection
    if case == "empty":
        n_tiles[:] = 0
    if case == "one":
        mx[:], my[:], n_tiles[:] = W / 2, H / 2, 0
        rmin[:] = [[TX // 2 - 3, TY // 2 - 2]]
        rmax[:] = [[TX // 2 + 3, TY // 2 + 3]]
        n_tiles[:] = 30
        ca[:], cb[:], cc[:], thr[:] = 0.002, 0.001, 0.004, 4.0
    depth = np.round(r.uniform(0.3, 8.0, P), 2)   # ties
    if case == "ties":   # three depths: long runs of equal keys
        depth = r.choice([0.5, 2.0, 7.25], P)
    cull = np.stack([mx, my_grid, ca, cb, cc, thr], 1).astype(np.float32)
    if case == "degenerate":   # the full-AABB-row branch, row by row
        k = r.integers(0, 5, P)
        cull[k == 0, 2] = -cull[k == 0, 2]                  # a <= 0
        cull[k == 1, 4] = 0.0                               # c = 0
        cull[k == 2, 3] = 2.0 * np.sqrt(cull[k == 2, 2] * cull[k == 2, 4])
        cull[k == 3, 5] = -5.0                              # thr_m <= 0
    if case == "nonfinite":
        bad = np.array([np.nan, np.inf, -np.inf], np.float32)
        rows = r.uniform(size=P) < 0.5
        cols = r.integers(0, 6, P)
        cull[rows, cols[rows]] = bad[r.integers(0, 3, rows.sum())]
    sp = Splats2D(
        mean2d=torch.as_tensor(np.stack([mx, my], 1).astype(np.float32)),
        depth=torch.as_tensor(depth.astype(np.float32)),
        conic=None, opacity=None, rgb=None, plane_normal=None,
        plane_dist=None, radius=None,
        rect_min=torch.as_tensor(rmin.astype(np.int32)),
        rect_max=torch.as_tensor(rmax.astype(np.int32)),
        n_tiles=torch.as_tensor(n_tiles.astype(np.int32)))
    sp = to_device(sp, device)
    return sp, torch.as_tensor(cull, device=device), TX, TY, TH, TW


def to_device(sp: Splats2D, device) -> Splats2D:
    return Splats2D(**{k: None if v is None else v.to(device)
                       for k, v in vars(sp).items()})


def caps_inside(plain_bins_fn, sp, cull, TX, TY, TH, TW):
    """(cap, row_cap) that cut the lists inside a Gaussian: row_cap one row
    into a Gaussian of at least 3 rows, cap one slot into a Gaussian of at
    least 2 kept slots; `plain_bins_fn(cap, row_cap)` bins without and
    then with the row cap."""
    free = plain_bins_fn(0, 0)
    order = free.order.cpu()
    rh = torch.where(sp.n_tiles.cpu() > 0,
                     (sp.rect_max[:, 1] - sp.rect_min[:, 1]).cpu().long(),
                     0)[order]
    row_off = torch.cumsum(rh, 0) - rh
    tall = torch.nonzero(rh >= 3).flatten()
    row_cap = int(row_off[tall[len(tall) // 2]]) + 1
    seg = plain_bins_fn(0, row_cap).seg_off.cpu()
    wide = torch.nonzero((seg[1:] - seg[:-1] >= 2) & (seg[:-1] > 0)).flatten()
    cap = int(seg[wide[len(wide) // 3]]) + 1
    return cap, row_cap


# ------------------------------------------------------ pack_rows' backward

PACK_CASES = ("long", "cancel", "empty")


def pack_case(case: str, seed: int = 0, C: int = 16, device="cpu"):
    """`pack_rows`' backward inputs without a scene: a namespace of g (n, C)
    float32 cotangent rows in sorted order, inst_valid, slot, seg_off,
    order and gauss_id (= order[rank] of each sorted row), as TileBins
    holds them.  "long": 2,000 Gaussians, most with 0-3 slots, eight with
    1,000-12,000 (a splat over most of a grid), a fifth of the rows
    culled, the cap in the middle of the longest segment; "cancel": each
    segment a residual of about 1e-4 among pairs +a, -a (a up to 100), so
    that a float32 running sum loses the residual; "empty": no instance."""
    import types
    r = np.random.default_rng([seed, 99, PACK_CASES.index(case)])
    P = {"long": 2000, "cancel": 3000, "empty": 500}[case]
    if case == "long":
        lens = r.integers(0, 4, P)
        lens[r.choice(P, 8, replace=False)] = r.integers(1000, 12001, 8)
    elif case == "cancel":
        lens = 2 * r.integers(0, 4, P) + 1
    else:
        lens = np.zeros(P, np.int64)
    seg_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    n = int(seg_off[-1])
    if case == "long":
        big = int(np.argmax(lens))
        n = int(seg_off[big] + lens[big] // 2)
    rank_of_slot = np.searchsorted(seg_off, np.arange(n), side="right") - 1
    if case == "cancel":
        by_slot = np.empty((n, C), np.float32)
        for rk in range(P):
            b, e = seg_off[rk], seg_off[rk + 1]
            res = r.uniform(0.5e-4, 1.5e-4, C) * r.choice([-1, 1], C)
            a = r.uniform(1.0, 100.0, ((e - b) // 2, C)).astype(np.float32)
            vals = np.concatenate([res[None].astype(np.float32), a, -a])
            by_slot[b:e] = vals[r.permutation(e - b)]
    else:
        by_slot = r.normal(size=(n, C)).astype(np.float32)
    slot = r.permutation(n).astype(np.int64)
    order = r.permutation(P).astype(np.int64)
    valid = (r.uniform(size=n) >= (0.2 if case == "long" else 0.0))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return types.SimpleNamespace(
        g=t(by_slot[slot]), inst_valid=t(valid), slot=t(slot),
        seg_off=t(seg_off), order=t(order),
        gauss_id=t(order[rank_of_slot[slot]]))


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance of two float32 tensors in float32 ulps (int64;
    -0 and +0 the same; for finite values)."""
    def key(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (key(a) - key(b)).abs()
