"""Real spherical-harmonics shading, degrees 0..3 (counterpart of
ibgs_tpu/core/sh.py)."""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)

MAX_DEGREE = 3


def num_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """The DC coefficient that shades to `rgb`."""
    return (rgb - 0.5) / C0


def sh0_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    """The colour a DC coefficient shades to."""
    return sh * C0 + 0.5


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """(…, 3) unit directions → (…, (degree+1)^2) SH basis values."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, C0)]
    if degree >= 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz, C2[4] * (xx - yy)]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        out += [C3[0] * y * (3.0 * xx - yy),
                C3[1] * xy * z,
                C3[2] * y * (4.0 * zz - xx - yy),
                C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                C3[4] * x * (4.0 * zz - xx - yy),
                C3[5] * z * (xx - yy),
                C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(out, dim=-1)


def degree_mask(max_degree: int, active_degree: int,
                device=None) -> torch.Tensor:
    """Per-coefficient 0/1 float mask selecting coefficients of degree <=
    active_degree."""
    coeff_deg = torch.tensor(
        [d for d in range(max_degree + 1) for _ in range(2 * d + 1)],
        dtype=torch.int32, device=device)
    return (coeff_deg <= active_degree).to(torch.float32)


def eval_sh(coeffs: torch.Tensor, dirs: torch.Tensor, max_degree: int,
            active_degree: int) -> torch.Tensor:
    """(…, K, 3) coefficients, (…, 3) unit view dirs → (…, 3) raw SH sum
    (no +0.5 offset / clamp; callers apply those).  The sum over the K
    coefficients runs left to right, one elementwise op per term (an order
    a per-Gaussian kernel reproduces bit for bit); masked coefficients
    enter it as 0·c."""
    basis = sh_basis(dirs, max_degree)
    basis = basis * degree_mask(max_degree, active_degree, dirs.device)
    out = basis[..., 0, None] * coeffs[..., 0, :]
    for k in range(1, basis.shape[-1]):
        out = out + basis[..., k, None] * coeffs[..., k, :]
    return out
