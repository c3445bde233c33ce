"""Geometry primitives (counterpart of ibgs_tpu/core/transforms.py).

Matrices follow the column-vector convention ``x_out = M @ x_in``.  Camera
matrices are built on the host in numpy, as in the JAX package; the
per-point helpers run on tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(…, 4) wxyz quaternion → (…, 3, 3) rotation matrix (used as-is;
    callers normalise)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack([torch.stack([r00, r01, r02], dim=-1),
                        torch.stack([r10, r11, r12], dim=-1),
                        torch.stack([r20, r21, r22], dim=-1)], dim=-2)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-24) -> torch.Tensor:
    """Safe unit-normalisation: v * rsqrt(|v|^2 + eps)."""
    return v * torch.rsqrt((v * v).sum(dim=dim, keepdim=True) + eps)


def build_covariance_3d(scale: torch.Tensor,
                        quat: torch.Tensor) -> torch.Tensor:
    """(…, 3) activated scales + (…, 4) unit quats → (…, 3, 3) world
    covariance R S S^T R^T, S = diag(scale)."""
    M = quat_to_rotmat(quat) * scale[..., None, :]   # R @ diag(s)
    return M @ M.transpose(-1, -2)


def cov3d_to_sym6(cov: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) symmetric → packed (…, 6): xx, xy, xz, yy, yz, zz."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
                       dim=-1)


def sym6_to_cov3d(s: torch.Tensor) -> torch.Tensor:
    """Packed (…, 6) → symmetric (…, 3, 3)."""
    return torch.stack([
        torch.stack([s[..., 0], s[..., 1], s[..., 2]], dim=-1),
        torch.stack([s[..., 1], s[..., 3], s[..., 4]], dim=-1),
        torch.stack([s[..., 2], s[..., 4], s[..., 5]], dim=-1)], dim=-2)


# --------------------------------------------------------------------------
# Camera matrices (host-side numpy: built once per camera)
# --------------------------------------------------------------------------

def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """COLMAP-convention pose → 4x4 world-to-camera matrix (``R`` is the
    camera-to-world rotation, ``t`` the world-to-camera translation)."""
    M = np.eye(4, dtype=np.float64)
    M[:3, :3] = R.T
    M[:3, 3] = t
    return M.astype(np.float32)


def perspective(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style frustum used by 3DGS (z in [0,1] after divide)."""
    tx = math.tan(fovx * 0.5)
    ty = math.tan(fovy * 0.5)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tx
    P[1, 1] = 1.0 / ty
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def fov_to_focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


# --------------------------------------------------------------------------
# Projection helpers (device-side)
# --------------------------------------------------------------------------

def _affine_row(M: torch.Tensor, r: int, p: torch.Tensor) -> torch.Tensor:
    """Row r of M applied to (…, 3) points, summed left to right
    (p0·M[r,0] + p1·M[r,1]) + p2·M[r,2] + M[r,3]: one elementwise op per
    term, an order a per-point kernel reproduces bit for bit."""
    return (p[..., 0] * M[r, 0] + p[..., 1] * M[r, 1] + p[..., 2] * M[r, 2]
            + M[r, 3])


def apply_transform(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(4,4) @ (…,3) homogeneous point transform → (…,3) xyz (no divide)."""
    return torch.stack([_affine_row(M, r, p) for r in range(3)], dim=-1)


def apply_rotation(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate direction vectors by the 3x3 block of a 4x4 transform."""
    return v @ M[:3, :3].T


def project_hom(M: torch.Tensor, p: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Full projective transform with homogeneous divide → (…,3) NDC."""
    w = 1.0 / (_affine_row(M, 3, p) + eps)
    return torch.stack([_affine_row(M, r, p) * w for r in range(3)], dim=-1)


def ndc_to_pixel(v: torch.Tensor, size) -> torch.Tensor:
    """NDC in [-1,1] → pixel coordinate, 3DGS convention ((v+1)*S - 1)/2."""
    return ((v + 1.0) * size - 1.0) * 0.5


def camera_center_from_view(view: torch.Tensor) -> torch.Tensor:
    """World-space camera centre from a 4x4 world-to-view matrix."""
    return -(view[:3, :3].T @ view[:3, 3])
