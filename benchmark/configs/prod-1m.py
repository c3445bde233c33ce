"""The JAX package's 1M-splat production scene, made from the seed on the
card: the wavy-disc ground-truth cloud of `data/synthetic` (1.5M points),
16 ring cameras (every 8th a test view), 1M seed splats drawn from the
cloud with 0.01 noise and initialised as the training loop initialises a
seed cloud (isotropic scales from the mean squared distance to the 3
nearest neighbours, opacity 0.1, identity rotation, normal +z), laid into
1,310,720 slots, SH degree 2 as the schedule has it by iteration 2,000.
The train views' images are the benchmark's own point z-buffer of the
ground-truth cloud (nearest point per pixel), not a render of the port.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import scene as sc

C0 = 0.28209479177387814


def gt_cloud(gen: torch.Generator, n: int, device):
    """`data/synthetic._gt_cloud` drawn with torch on the card: points on
    the wavy disc and their colours."""
    u = torch.rand(2, n, generator=gen, device=device, dtype=torch.float64)
    r = torch.sqrt(u[0]) * 1.1
    th = u[1] * 2 * math.pi
    x, y = r * torch.cos(th), r * torch.sin(th)
    z = 0.25 * torch.sin(3 * x) * torch.cos(3 * y)
    pts = torch.stack([x, y, z], -1)
    col = torch.stack([(torch.sin(4 * x) + 1) / 2, (torch.cos(4 * y) + 1) / 2,
                       (torch.sin(2 * (x + y)) + 1) / 2], -1)
    return pts.float(), col.float()


def ring_views(n_views: int, radius: float = 3.0):
    out = []
    for k in range(n_views):
        a = 2 * math.pi * k / n_views
        out.append(sc.look_at_view([radius * math.sin(a) * 0.45,
                                    radius * math.cos(a) * 0.45, -radius]))
    return out


def zbuffer(pts, col, view, fovx, fovy, W, H):
    """The colour of the nearest point in each pixel (0 where none); ties
    in depth go to the lower point index."""
    V = torch.as_tensor(view, device=pts.device)
    p = pts @ V[:3, :3].T + V[:3, 3]
    z = p[:, 2]
    fx = W / (2.0 * math.tan(0.5 * fovx))
    fy = H / (2.0 * math.tan(0.5 * fovy))
    u = torch.round(p[:, 0] / z * fx + (W - 1) / 2).long()
    v = torch.round(p[:, 1] / z * fy + (H - 1) / 2).long()
    ok = (z > 0.2) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    idx = torch.nonzero(ok)[:, 0]
    pix = v[idx] * W + u[idx]
    key = (z[idx].contiguous().view(torch.int32).long() << 21) + idx
    best = torch.full((H * W,), torch.iinfo(torch.int64).max,
                      dtype=torch.int64, device=pts.device)
    best.scatter_reduce_(0, pix, key, "amin")
    hit = best != torch.iinfo(torch.int64).max
    img = torch.zeros(H * W, 3, device=pts.device)
    img[hit] = col[best[hit] & ((1 << 21) - 1)]
    return img.reshape(H, W, 3)


@torch.no_grad()
def mean_sq_dist_3nn(pts: torch.Tensor, block: int = 4096,
                     reach: float = 0.05) -> torch.Tensor:
    """Exact mean squared distance of each point to its 3 nearest others:
    points sorted by x, each block of queries against the points within
    `reach` of its x range (a neighbour nearer than `reach` lies there);
    a block whose third neighbour lies beyond the reach is done again with
    twice the reach."""
    xs, order = torch.sort(pts[:, 0])
    p = pts[order].double()
    n = p.shape[0]
    out = torch.empty(n, dtype=torch.float64, device=pts.device)
    for s in range(0, n, block):
        e = min(n, s + block)
        r = reach
        while True:
            lo = int(torch.searchsorted(xs, xs[s] - r))
            hi = int(torch.searchsorted(xs, xs[e - 1] + r, right=True))
            d = torch.cdist(p[s:e], p[lo:hi]).square()
            rows = torch.arange(e - s, device=pts.device)
            d[rows, rows + (s - lo)] = math.inf
            top = torch.topk(d, 3, dim=1, largest=False).values
            if hi - lo == n or not bool((top[:, 2] > r * r).any()):
                break
            r *= 2
        out[order[s:e]] = top.mean(-1)
    return out.float()


def build(cfg: dict, traffic: dict, seed: int, device) -> sc.Scene:
    W, H = int(traffic["width"]), int(traffic["height"])
    gen = sc.generator(seed, device)
    fov = float(cfg["fov"])
    pts, col = gt_cloud(gen, int(cfg["gt_points"]), device)
    views = ring_views(int(cfg["views"]), float(cfg["cam_radius"]))
    test = [k for k in range(len(views)) if k % cfg["eval_every"] == 0]
    train = [k for k in range(len(views)) if k % cfg["eval_every"] != 0]
    images = torch.stack([zbuffer(pts, col, views[k], fov, fov, W, H)
                          for k in train])

    n, cap = int(cfg["seed_points"]), int(cfg["capacity"])
    pick = torch.randperm(pts.shape[0], generator=gen, device=device)[:n]
    seed_pts = pts[pick] + 0.01 * torch.randn(n, 3, generator=gen,
                                              device=device)
    d2 = torch.clamp(mean_sq_dist_3nn(seed_pts), min=1e-7)
    K = (cfg["sh_degree"] + 1) ** 2

    def rows(v, width):
        x = torch.zeros(cap, width, device=device)
        x[:n] = torch.as_tensor(v, dtype=torch.float32, device=device)
        return x

    xyz = torch.zeros(cap, 3, device=device)
    xyz[:n] = seed_pts
    sh_dc = torch.zeros(cap, 1, 3, device=device)
    sh_dc[:n, 0] = (col[pick] - 0.5) / C0
    log_scale = torch.zeros(cap, 3, device=device)
    log_scale[:n] = torch.log(torch.sqrt(d2))[:, None]
    params = dict(
        xyz=xyz, sh_dc=sh_dc,
        sh_rest=torch.zeros(cap, K - 1, 3, device=device),
        log_scale=log_scale, quat=rows([1.0, 0.0, 0.0, 0.0], 4),
        opacity_logit=rows([float(np.log(0.1 / 0.9))], 1),
        normal=rows([0.0, 0.0, 1.0], 3),
        offset=torch.zeros(cap, 1, device=device))

    train_c = np.stack([sc.centre(views[k]) for k in train])
    nearest = {i: ids for i, ids in
               enumerate(sc.nearest_by_centre(train_c, 4))}
    serve_nearest = []
    for k in test:
        dist = np.linalg.norm(train_c - sc.centre(views[k])[None], axis=-1)
        serve_nearest.append([int(i) for i in
                              np.argsort(dist, kind="stable")[:4]])
    return sc.Scene(
        params=params, alive=torch.arange(cap, device=device) < n,
        sh_degree=int(cfg["sh_degree"]), width=W, height=H, fovx=fov,
        fovy=fov, views=[views[k] for k in train], images=images,
        train_ids=list(range(len(train))), nearest=nearest,
        serve_views=[views[k] for k in test], serve_nearest=serve_nearest,
        extent=float(cfg["cam_radius"]),
        net=sc.lecun_net(gen, device, cfg["net_width"]),
        app_ab=sc.exposure_table(gen, device), net_width=cfg["net_width"])
