"""The converged 91k-splat bundle (`bench_bundle.npz` at the root of the
checkout, held to its SHA-256): its splats, its one view with ground
truth and that view's four ring sources, resized bilinearly to the
traffic's size.  The source cameras are the ring's look-at cameras at the
stored source centres (the stored transforms carry a TPU matmul's bf16
rounding); the fusion net and the exposure table are drawn from the seed.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from benchmark import harness
from benchmark import scene as sc


def _bundle(cfg: dict) -> dict:
    path = harness.ROOT / cfg["bundle"]
    if not path.is_file():
        raise harness.SpecError(f"missing {cfg['file']}")
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    if h.hexdigest() != cfg["sha256"]:
        raise harness.SpecError(f"{cfg['file']} is not the bundle this "
                                f"configuration names: sha256 "
                                f"{h.hexdigest()}")
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def build(cfg: dict, traffic: dict, seed: int, device) -> sc.Scene:
    d = _bundle(cfg)
    W, H = int(traffic["width"]), int(traffic["height"])
    R, t = np.asarray(d["cam_R"], np.float64), np.asarray(d["cam_t"],
                                                          np.float64)
    ref = sc.world_to_view(R, t)
    views = [ref] + [sc.look_at_view(c) for c in
                     np.asarray(d["src_cam_pos"], np.float64)]
    n_src = int(d["src_count"])
    imgs = np.concatenate([d["gt"][None], d["src_images"]]).astype(
        np.float32)
    images = sc.resize_images(torch.as_tensor(imgs).to(device), H, W)
    params = {k: torch.as_tensor(np.asarray(d[k], np.float32)).to(device)
              .contiguous() for k in sc.PARAM_FIELDS}
    P = params["xyz"].shape[0]
    centres = np.stack([sc.centre(v) for v in views]).astype(np.float64)
    extent = float(1.1 * np.linalg.norm(centres - centres.mean(0),
                                        axis=-1).max())
    gen = sc.generator(seed, device)
    sources = list(range(1, 1 + n_src))
    return sc.Scene(
        params=params, alive=torch.ones(P, dtype=torch.bool, device=device),
        sh_degree={0: 0, 3: 1, 8: 2, 15: 3}[params["sh_rest"].shape[1]],
        width=W, height=H, fovx=float(d["fovx"]), fovy=float(d["fovy"]),
        views=views, images=images, train_ids=[0], nearest={0: sources},
        serve_views=[ref], serve_nearest=[sources], extent=extent,
        net=sc.lecun_net(gen, device, cfg["net_width"]),
        app_ab=sc.exposure_table(gen, device), net_width=cfg["net_width"])
