"""Seeded inputs of the preprocess tests, shared by the CPU tests against the
JAX package (test_torch_preprocess_grad.py) and the card's tests of the
kernels against the plain version (test_torch_gpu.py).  Imports no JAX.

Every case holds, beside splats scattered in front of the camera, splats
behind it, splats at the near plane (view z within 1e-3 of 0.2, on either
side: far enough from it that the frameworks' roundings agree), dead
slots (alive False) and splats of opacity below 1/255; `zero_z` puts one
splat exactly at view z = 0, where the gradient is not finite.
"""
import zlib

import numpy as np
import torch

from ibgs_tpu_torch.core import camera as tcam

W, H = 80, 56
# look_at_camera's arguments: eye, target, up, fovx, fovy, width, height
CAM_ARGS = ([0.3, -0.2, -3.0], [0.1, 0.0, 0.2], [0.0, -1.0, 0.0], 0.9, 0.7,
            W, H)
TILE = (16, 32)
BAND_ROW0, BAND_ROWS = 16, 32
# name: (SH degree, active degree, rgb_override, band, zero_z)
CASES = {
    "deg0": (0, 0, False, False, False),
    "deg1_active0": (1, 0, False, False, False),
    "deg2_active1": (2, 1, False, False, False),
    "deg3": (3, 3, False, False, False),
    "deg3_active2": (3, 2, False, False, False),
    "rgb_override": (2, 2, True, False, False),
    "band": (2, 2, False, True, False),
}
ZERO_Z = {"zero_z": (3, 3, False, False, True)}


def camera(device="cpu"):
    return tcam.look_at_camera(*CAM_ARGS, device=device)


def inputs(case: str, n: int = 400):
    """(numpy float32 inputs, the (n, 15) cotangent table) of `case`: xyz,
    scale, quat, opacity, sh (n, K, 3), rgb (the override), normal,
    offset, alive.  Columns 0-1, 2-4, 6-8, 9-11 and 12 of the table are
    the cotangents of mean2d, conic, rgb, plane_normal and plane_dist, as
    `torch.cat` hands them back from rasterize's per-Gaussian table."""
    deg, _, _, _, zero_z = {**CASES, **ZERO_Z}[case]
    r = np.random.default_rng(zlib.crc32(case.encode()) + n)
    q = r.normal(size=(n, 4))
    d = dict(
        xyz=r.uniform(-1.2, 1.2, (n, 3)),
        scale=np.exp(r.uniform(-4.0, -1.0, (n, 3))),
        quat=q / np.linalg.norm(q, axis=1, keepdims=True),
        opacity=r.uniform(0.0, 1.0, n),
        sh=r.uniform(-1, 1, (n, (deg + 1) ** 2, 3)) * 0.5,
        rgb=r.uniform(0.0, 1.0, (n, 3)),
        normal=r.normal(size=(n, 3)),
        offset=r.normal(size=n) * 0.1,
        alive=r.uniform(size=n) > 0.1)
    m = max(n // 40, 1)
    d["opacity"][:m] = r.uniform(0.0, 1.0 / 255.0, m)
    c2w = np.linalg.inv(camera().view.numpy().astype(np.float64))
    # behind the camera, then at the near plane
    behind = np.c_[r.uniform(-1, 1, (m, 2)), -r.uniform(0.1, 2.0, m)]
    near = np.c_[r.uniform(-0.05, 0.05, (m, 2)),
                 0.2 + r.choice([-1.0, 1.0], m) * r.uniform(1e-4, 1e-3, m)]
    for k, pts in ((1, behind), (2, near)):
        d["xyz"][k * m:(k + 1) * m] = (c2w[:3, :3] @ pts.T).T + c2w[:3, 3]
    f = {k: np.asarray(v, bool if k == "alive" else np.float32)
         for k, v in d.items()}
    if zero_z:
        f["xyz"][3 * m] = _on_camera_plane(f["xyz"][3 * m])
    return f, r.normal(size=(n, 15)).astype(np.float32)


def _on_camera_plane(x):
    """x moved along world z until its float32 view z, as the plain
    version's op order computes it, is exactly 0."""
    V = camera().view
    x = torch.as_tensor(x)
    for _ in range(50):
        z = x[0] * V[2, 0] + x[1] * V[2, 1] + x[2] * V[2, 2] + V[2, 3]
        if float(z) == 0.0:
            return x.numpy()
        x = x.clone()
        x[2] = x[2] - z / V[2, 2]
    raise AssertionError("no float32 point with view z == 0 found")


def cotangents(table: torch.Tensor, with_rgb: bool = True):
    """The five cotangents as strided column slices of the table."""
    return (table[:, 0:2], table[:, 2:5], table[:, 6:9] if with_rgb else None,
            table[:, 9:12], table[:, 12])
