"""The IBGS Tanks and Temples deployment at 2M splats, made from the seed
on the card: the wavy-disc ground-truth cloud (2,097,152 points), 64 ring
cameras at 960x540 (every 8th a test view), 2M seed splats drawn from
the cloud and initialised as the training loop initialises a seed cloud,
laid into 2,620,416 slots at SH degree 2.  The cloud, the z-buffer and
the 3-NN scales are prod-1m.py's own functions, loaded from that file.

Each train view's image is the z-buffer of the cloud under its own
seeded exposure, colour·exp(a) + b clipped to [0, 1] on the pixels the
cloud covers, as the auto-exposed frames of a Tanks and Temples video
are.  Each view's sources follow the
data layer's neighbour rule at the ModelParams defaults with the
exposure-aware reordering on (`neighbor_ids`, the benchmark's copy of
`data/dataset._neighbor_ids`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import harness
from benchmark import scene as sc

PROD = harness.load_module(harness.HERE / "configs" / "prod-1m.py")


def neighbor_ids(centers, rays, w2v, q_centers, q_rays, q_w2v,
                 cfg) -> list:
    """Each query camera's nearest train cameras: sorted by centre
    distance, then by the angle of their view directions; those within
    `max_angle` degrees and (min_dis, max_dis); the first `num`; with
    `exposure_reorder` the one whose pose relative to the query is
    nearest the identity moved first."""
    inv = np.linalg.inv(w2v)
    out = []
    for q in range(q_centers.shape[0]):
        dist = np.linalg.norm(q_centers[q][None] - centers, axis=-1)
        cos = np.clip((q_rays[q][None] * rays).sum(-1), -1.0, 1.0)
        ang = np.degrees(np.arccos(cos))
        order = np.lexsort((ang, dist))
        keep = ((ang[order] < cfg["max_angle"])
                & (dist[order] > cfg["min_dis"])
                & (dist[order] < cfg["max_dis"]))
        sel = order[keep][: cfg["num"]]
        if len(sel) and cfg["exposure_reorder"]:
            rel = q_w2v[q][None] @ inv[sel]
            off = np.abs(rel - np.eye(4)[None]).mean(axis=(1, 2))
            best = sel[np.argmin(off)]
            sel = np.concatenate([[best], sel[sel != best]])
        out.append([int(s) for s in sel])
    return out


def pose_arrays(views):
    """(centres, unit view directions, world-to-view matrices) of float32
    views, as the data layer reads them from its cameras."""
    w2v = np.stack(views).astype(np.float32)
    centers = np.stack([sc.centre(v) for v in views])
    rays = w2v[:, 2, :3].astype(np.float64)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return centers, rays, w2v


def build(cfg: dict, traffic: dict, seed: int, device) -> sc.Scene:
    W, H = int(traffic["width"]), int(traffic["height"])
    gen = sc.generator(seed, device)
    fovx = float(cfg["fovx"])
    fovy = 2.0 * math.atan(math.tan(0.5 * fovx) * H / W)
    if int(cfg["gt_points"]) > 1 << 21:
        # prod-1m.zbuffer keeps a point's index in 21 bits of its depth key
        raise harness.SpecError("tnt-2m: gt_points above 2^21")
    pts, col = PROD.gt_cloud(gen, int(cfg["gt_points"]), device)
    views = PROD.ring_views(int(cfg["views"]), float(cfg["cam_radius"]))
    test = [k for k in range(len(views)) if k % cfg["eval_every"] == 0]
    train = [k for k in range(len(views)) if k % cfg["eval_every"] != 0]
    lo_a, hi_a = cfg["image_exposure"]["log_gain"]
    lo_b, hi_b = cfg["image_exposure"]["bias"]
    u = torch.rand(len(train), 2, generator=gen, device=device)
    gain = torch.exp(lo_a + (hi_a - lo_a) * u[:, 0])
    bias = lo_b + (hi_b - lo_b) * u[:, 1]
    images = []
    for j, k in enumerate(train):
        img = PROD.zbuffer(pts, col, views[k], fovx, fovy, W, H)
        # the exposure acts on the scene's pixels; where no point lies the
        # frame stays black, as the renderer's background is (no cloud
        # colour is black in all three channels)
        hit = (img > 0).any(-1, keepdim=True)
        images.append(torch.where(
            hit, torch.clamp(img * gain[j] + bias[j], 0.0, 1.0), 0.0))
    images = torch.stack(images)

    n, cap = int(cfg["seed_points"]), int(cfg["capacity"])
    pick = torch.randperm(pts.shape[0], generator=gen, device=device)[:n]
    seed_pts = pts[pick] + float(cfg["seed_noise"]) * torch.randn(
        n, 3, generator=gen, device=device)
    d2 = torch.clamp(PROD.mean_sq_dist_3nn(seed_pts), min=1e-7)
    K = (cfg["sh_degree"] + 1) ** 2

    def rows(v, width):
        x = torch.zeros(cap, width, device=device)
        x[:n] = torch.as_tensor(v, dtype=torch.float32, device=device)
        return x

    xyz = torch.zeros(cap, 3, device=device)
    xyz[:n] = seed_pts
    sh_dc = torch.zeros(cap, 1, 3, device=device)
    sh_dc[:n, 0] = (col[pick] - 0.5) / PROD.C0
    log_scale = torch.zeros(cap, 3, device=device)
    log_scale[:n] = torch.log(torch.sqrt(d2))[:, None]
    op = float(cfg["seed_opacity"])
    params = dict(
        xyz=xyz, sh_dc=sh_dc,
        sh_rest=torch.zeros(cap, K - 1, 3, device=device),
        log_scale=log_scale, quat=rows([1.0, 0.0, 0.0, 0.0], 4),
        opacity_logit=rows([math.log(op / (1.0 - op))], 1),
        normal=rows([0.0, 0.0, 1.0], 3),
        offset=torch.zeros(cap, 1, device=device))

    train_views = [views[k] for k in train]
    test_views = [views[k] for k in test]
    poses = pose_arrays(train_views)
    nearest = dict(enumerate(neighbor_ids(*poses, *poses,
                                          cfg["multi_view"])))
    serve_nearest = neighbor_ids(*poses, *pose_arrays(test_views),
                                 cfg["multi_view"])
    return sc.Scene(
        params=params, alive=torch.arange(cap, device=device) < n,
        sh_degree=int(cfg["sh_degree"]), width=W, height=H, fovx=fovx,
        fovy=fovy, views=train_views, images=images,
        train_ids=list(range(len(train))), nearest=nearest,
        serve_views=test_views, serve_nearest=serve_nearest,
        extent=float(cfg["cam_radius"]),
        net=sc.lecun_net(gen, device, cfg["net_width"]),
        app_ab=sc.exposure_table(gen, device), net_width=cfg["net_width"])
