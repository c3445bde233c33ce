"""The inputs a configuration makes, in plain tensors and numpy, handed
alike to the port and to the reference: the Gaussians, the views (4x4
world-to-view matrices and their images), each view's sources, the fusion
net's weights and the exposure table.  Also the benchmark's own copies of
the camera and resize arithmetic it needs to make them, and the seeded
camera offsets of the serve traffic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

PARAM_FIELDS = ("xyz", "sh_dc", "sh_rest", "log_scale", "quat",
                "opacity_logit", "normal", "offset")
APP_CAPACITY = 1600     # rows of the exposure table


@dataclasses.dataclass
class Scene:
    params: Dict[str, torch.Tensor]   # the eight fields, (P, ...) float32
    alive: torch.Tensor               # (P,) bool
    sh_degree: int                    # active = max SH degree
    width: int
    height: int
    fovx: float
    fovy: float
    views: List[np.ndarray]           # (4, 4) float32 world-to-view
    images: torch.Tensor              # (N, H, W, 3) float32 view images
    train_ids: List[int]              # views trained on, in cycle order
    nearest: Dict[int, List[int]]     # view id → its source view ids
    serve_views: List[np.ndarray]     # base cameras of served views
    serve_nearest: List[List[int]]    # their source view ids
    extent: float                     # spatial learning-rate scale
    net: Dict[str, torch.Tensor]      # fusion net state_dict, torch layout
    app_ab: torch.Tensor              # (APP_CAPACITY, 2)
    net_width: int = 32

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]


# ---- camera arithmetic (the conventions of ibgs_tpu_torch.core.camera) ----

def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """4x4 float32 world-to-view from a camera-to-world rotation R and the
    world-to-camera translation t."""
    V = np.eye(4, dtype=np.float64)
    V[:3, :3] = np.asarray(R, np.float64).T
    V[:3, 3] = np.asarray(t, np.float64)
    return V.astype(np.float32)


def look_at_view(eye, target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0)):
    """World-to-view of a camera at `eye` looking at `target`, columns of
    its camera-to-world rotation (right, down, forward)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    return world_to_view(R, -R.T @ eye)


def centre(view: np.ndarray) -> np.ndarray:
    v = np.asarray(view, np.float32)
    return (-v[:3, :3].T @ v[:3, 3]).astype(np.float32)


def nearest_by_centre(centres: np.ndarray, num: int = 4) -> List[List[int]]:
    """Each camera's `num` nearest other cameras by centre distance."""
    out = []
    for c in centres:
        d = np.linalg.norm(c[None] - centres, axis=-1)
        out.append([int(o) for o in np.argsort(d, kind="stable")[1:num + 1]])
    return out


def resize_images(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(N, h, w, C) → (N, H, W, C) bilinear with half-pixel centres."""
    if tuple(x.shape[1:3]) == (H, W):
        return x
    t = x.permute(0, 3, 1, 2)
    t = torch.nn.functional.interpolate(t, size=(H, W), mode="bilinear",
                                        align_corners=False)
    return t.permute(0, 2, 3, 1).contiguous()


def offset_views(base: np.ndarray, rng: np.random.Generator, n: int,
                 max_rot_deg: float, max_trans: float) -> List[np.ndarray]:
    """`n` world-to-view matrices: `base` rotated about its centre by up to
    `max_rot_deg` about a random axis and moved by up to `max_trans` in a
    random direction (float64 on the host, rounded to float32)."""
    base = np.asarray(base, np.float64)
    R_c2w = base[:3, :3].T
    c = -R_c2w @ base[:3, 3]
    out = []
    for _ in range(n):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = math.radians(max_rot_deg) * rng.random()
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        Rr = np.eye(3) + math.sin(ang) * K + (1 - math.cos(ang)) * K @ K
        d = rng.normal(size=3)
        d *= max_trans * rng.random() / np.linalg.norm(d)
        R2 = Rr @ R_c2w
        c2 = c + d
        out.append(world_to_view(R2, -R2.T @ c2))
    return out


# ---- the fusion net's weights --------------------------------------------

def net_shapes(d: int = 32) -> Dict[str, tuple]:
    """state_dict shapes of ColorFusionResidualNet(d) in torch layout (the
    Flax tree's names: Dense_0, Dense_1, ConvDecoderAE_0.Conv_0..8)."""
    h = d + 6
    shapes = {"Dense_0.weight": (d, 7), "Dense_0.bias": (d,),
              "Dense_1.weight": (d, d), "Dense_1.bias": (d,)}
    specs = [(h, h, 3), (h, h // 2, 3), (h // 2, h // 4, 3),
             (h // 4, h // 2, 3), (2 * (h // 2), h // 2, 3),
             (h // 2, h, 3), (2 * h, h, 3), (2 * h, h, 1), (h, 3, 1)]
    for i, (cin, cout, k) in enumerate(specs):
        shapes[f"ConvDecoderAE_0.Conv_{i}.weight"] = (cout, cin, k, k)
        shapes[f"ConvDecoderAE_0.Conv_{i}.bias"] = (cout,)
    return shapes


def lecun_net(gen: torch.Generator, device, d: int = 32
              ) -> Dict[str, torch.Tensor]:
    """Flax's default initialisation drawn in one call: LeCun-normal
    weights (variance 1 / fan_in), zero biases."""
    shapes = net_shapes(d)
    weights = {k: s for k, s in shapes.items() if k.endswith("weight")}
    total = sum(int(np.prod(s)) for s in weights.values())
    z = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for k, s in shapes.items():
        if k.endswith("bias"):
            out[k] = torch.zeros(s, device=device)
            continue
        n = int(np.prod(s))
        fan_in = n // s[0]
        out[k] = (z[pos:pos + n].reshape(s) * float(np.sqrt(1.0 / fan_in))
                  ).contiguous()
        pos += n
    return out


def exposure_table(gen: torch.Generator, device) -> torch.Tensor:
    """A seeded per-camera exposure table (log gain, bias)."""
    return 0.05 * torch.randn(APP_CAPACITY, 2, generator=gen, device=device)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g
