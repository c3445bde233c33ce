"""Camera model (counterpart of ibgs_tpu/core/camera.py).

Matrices are built in float64/float32 numpy exactly as the JAX package
builds them, then cast to float32 tensors on the device.  The intrinsics
are Python floats that hold float32 values, so that every tensor op that
reads them sees the same float32 scalar as the JAX package's traced
float32 scalars.  Principal point at the image centre, znear=0.01 /
zfar=100, pixel-centre convention pix = ((ndc+1)*S - 1)/2.

The camera paths (`interpolate_cameras`, `perturbed_camera`,
`ellipse_path`) are numpy float64 on the host, as in the JAX package; the
cameras they return live on their input cameras' device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference import transforms as tf

ZNEAR = 0.01
ZFAR = 100.0


def _f32(x) -> float:
    """A Python float holding the float32 rounding of x."""
    return float(np.float32(x))


@dataclasses.dataclass
class Camera:
    width: int
    height: int
    view: torch.Tensor        # (4,4) world→camera
    proj: torch.Tensor        # (4,4) camera→clip
    full_proj: torch.Tensor   # (4,4) world→clip
    cam_pos: torch.Tensor     # (3,) world-space centre
    fx: float                 # focal in px (float32 value)
    fy: float
    cx: float                 # principal point (W/2, H/2)
    cy: float
    tan_fovx: float
    tan_fovy: float

    @property
    def device(self) -> torch.device:
        return self.view.device

    def rays_cam(self) -> torch.Tensor:
        """(H, W, 3) unit-z camera-space ray directions through pixel
        centres."""
        dev = self.device
        xs = (torch.arange(self.width, dtype=torch.float32, device=dev)
              - self.cx) / device_scalar(self.fx, dev)
        ys = (torch.arange(self.height, dtype=torch.float32, device=dev)
              - self.cy) / device_scalar(self.fy, dev)
        ry, rx = torch.meshgrid(ys, xs, indexing="ij")
        return torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)


def device_scalar(x: float, device) -> torch.Tensor:
    """0-dim float32 tensor on `device`.  Dividing by a device tensor (not a
    Python float) keeps IEEE division: PyTorch's CUDA path turns division
    by a host scalar into multiplication by its reciprocal."""
    return torch.full((), x, dtype=torch.float32, device=device)


def camera_from_view(view: np.ndarray, fovx: float, fovy: float,
                     width: int, height: int, device="cuda") -> Camera:
    """Camera from a 4x4 float32 world-to-view matrix and field of view."""
    view = np.asarray(view, np.float32)
    proj = tf.perspective(ZNEAR, ZFAR, fovx, fovy)
    full = (proj @ view).astype(np.float32)
    cam_pos = (-view[:3, :3].T @ view[:3, 3]).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32).to(device)

    return Camera(
        width=int(width), height=int(height),
        view=t(view), proj=t(proj), full_proj=t(full), cam_pos=t(cam_pos),
        fx=_f32(tf.fov_to_focal(fovx, width)),
        fy=_f32(tf.fov_to_focal(fovy, height)),
        cx=_f32(0.5 * width), cy=_f32(0.5 * height),
        tan_fovx=_f32(math.tan(0.5 * fovx)),
        tan_fovy=_f32(math.tan(0.5 * fovy)),
    )


def make_camera(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                width: int, height: int, device="cuda") -> Camera:
    """Camera from a COLMAP-style pose (R: cam→world rotation, t: w2c
    translation) and field of view."""
    view = tf.world_to_view(np.asarray(R, np.float64),
                            np.asarray(t, np.float64))
    return camera_from_view(view, fovx, fovy, width, height, device)


def look_at_camera(eye, target, up, fovx: float, fovy: float,
                   width: int, height: int, device="cuda") -> Camera:
    """Convenience constructor for tests and synthetic scenes."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)   # columns (right, down, fwd)
    t = -R.T @ eye
    return make_camera(R, t, fovx, fovy, width, height, device)








