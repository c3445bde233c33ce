"""Per-Gaussian view preprocessing: projection, EWA splatting, shading
(counterpart of ibgs_tpu/ops/preprocess.py).

Behaviour and float32 op order follow the JAX package:
  * near-plane cull at view z <= 0.2,
  * EWA Jacobian with ±1.3·tan(fov) frustum clamping of the view-space mean,
  * +0.3 px low-pass dilation of the 2D covariance,
  * radius = ceil(3·sqrt(lambda_max)), lambda via mid ± sqrt(max(0.1, mid²-det)),
  * opacity-aware per-axis tile rectangles,
  * SH→RGB with +0.5 offset and clamp-to-positive,
  * camera-space plane normal and offset.

`preprocess` is one differentiable op (`_Preprocess`): on CUDA tensors
the two hand-written kernels of csrc/preprocess.cu (`preprocess_fwd_cuda`,
`preprocess_bwd_cuda`, counted in LAUNCHES), on CPU tensors the plain
version `preprocess_plain` and torch autograd of it
(`preprocess_bwd_plain`).  There is no fallback: a CUDA input the kernels
do not take raises.  The plain version's sums run left to right, one
elementwise op per term (core/transforms.py, core/sh.py; `camera_plane`'s
as fused multiply-adds), so the kernels reproduce its float ops one by
one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ibgs_tpu_torch.core import sh as shlib
from ibgs_tpu_torch.core import transforms as tf
from ibgs_tpu_torch.core.camera import Camera
from ibgs_tpu_torch.utils import profiling

NEAR_CULL_Z = 0.2
COV2D_DILATION = 0.3
# kernel launches (counted by the wrappers where they launch)
LAUNCHES = {"preprocess_fwd": 0, "preprocess_bwd": 0}
# SH coefficient counts the kernels take (degrees 0..3)
SH_COEFFS = (1, 4, 9, 16)


@dataclasses.dataclass
class Splats2D:
    """Screen-space Gaussians for one camera (all arrays length P)."""
    mean2d: torch.Tensor        # (P, 2) pixel coords
    depth: torch.Tensor         # (P,) view-space z
    conic: torch.Tensor         # (P, 3) inverse 2D covariance (a, b, c)
    opacity: torch.Tensor       # (P,)
    rgb: torch.Tensor           # (P, 3)
    plane_normal: torch.Tensor  # (P, 3) camera-space plane normal
    plane_dist: torch.Tensor    # (P,) camera-space |plane offset|
    radius: torch.Tensor        # (P,) int32 screen radius (0 = culled)
    rect_min: torch.Tensor      # (P, 2) int32 tile rect (x, y), inclusive
    rect_max: torch.Tensor      # (P, 2) int32 tile rect, exclusive
    n_tiles: torch.Tensor       # (P,) int32 tiles touched


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """float → int32 truncation that saturates out-of-range values and maps
    NaN to 0, like XLA's convert (a bare `.to(int32)` is undefined there)."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 128.0)
    return x.to(torch.int32)


def _cov3d_sym6(scale: torch.Tensor, quat: torch.Tensor):
    """Activated scales + unit quats → packed world covariance
    (xx, xy, xz, yy, yz, zz), elementwise."""
    w, x, y, z = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    R = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    s2 = [scale[:, k] * scale[:, k] for k in range(3)]

    def sig(i, j):
        return (R[i][0] * R[j][0] * s2[0] + R[i][1] * R[j][1] * s2[1]
                + R[i][2] * R[j][2] * s2[2])

    return [sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)]


def frustum_limits(cam: Camera):
    """The EWA clamp's ±limits of x/z and y/z: 1.3·tan(fov/2), a float32
    product as in the JAX package."""
    return (float(np.float32(1.3) * np.float32(cam.tan_fovx)),
            float(np.float32(1.3) * np.float32(cam.tan_fovy)))


def ewa_project(scale: torch.Tensor, quat: torch.Tensor,
                mean_view: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Scales/quats + view-space means → packed 2D covariance (a, b, c)
    with the low-pass dilation."""
    tz = mean_view[:, 2]
    lim_x, lim_y = frustum_limits(cam)
    tx = torch.clamp(mean_view[:, 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(mean_view[:, 1] / tz, -lim_y, lim_y) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = cam.fx * inv_z
    j02 = -cam.fx * tx * inv_z2
    j11 = cam.fy * inv_z
    j12 = -cam.fy * ty * inv_z2
    Wm = cam.view[:3, :3]
    # U = J @ W with J = [[j00, 0, j02], [0, j11, j12]]
    U0 = [j00 * Wm[0, k] + j02 * Wm[2, k] for k in range(3)]
    U1 = [j11 * Wm[1, k] + j12 * Wm[2, k] for k in range(3)]

    S = _cov3d_sym6(scale, quat)
    Sm = [[S[0], S[1], S[2]], [S[1], S[3], S[4]], [S[2], S[4], S[5]]]

    def quad(Ua, Ub):
        out = 0.0
        for i in range(3):
            for j in range(3):
                out = out + Ua[i] * Sm[i][j] * Ub[j]
        return out

    a = quad(U0, U0) + COV2D_DILATION
    b = quad(U0, U1)
    c = quad(U1, U1) + COV2D_DILATION
    return torch.stack([a, b, c], dim=-1)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once more to a's type: the product is exact in
    float64, so this is a fused multiply-add (up to a rare double
    rounding)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _dot3(a0, a1, a2, b0, b1, b2) -> torch.Tensor:
    """a·b of 3-vectors as a chain of fused multiply-adds, left to right."""
    return _fma(a2, b2, _fma(a1, b1, a0 * b0))


def camera_plane(normal_world: torch.Tensor, offset: torch.Tensor,
                 xyz: torch.Tensor, cam: Camera):
    """World plane (camera-facing normal + scalar offset) → camera-space
    plane normal and |offset|.  Its dot products are chains of fused
    multiply-adds, left to right, as XLA computes the JAX package's plane
    distance on the CPU: the median depth of an ill-conditioned view
    follows the plane to the ulp (tests/test_torch_band.py)."""
    V, n = cam.view, normal_world
    n_cam = [_dot3(n[:, 0], n[:, 1], n[:, 2], V[r, 0], V[r, 1], V[r, 2])
             for r in range(3)]
    dist_world = -_dot3(n[:, 0], n[:, 1], n[:, 2],
                        xyz[:, 0], xyz[:, 1], xyz[:, 2]) + offset
    dist_cam = dist_world - _dot3(*n_cam, V[0, 3], V[1, 3], V[2, 3])
    return torch.stack(n_cam, dim=-1), torch.abs(dist_cam)


def preprocess_plain(
    xyz: torch.Tensor,              # (P,3)
    scale: torch.Tensor,            # (P,3) activated
    quat: torch.Tensor,             # (P,4) unit
    opacity: torch.Tensor,          # (P,) activated
    sh_coeffs: torch.Tensor,        # (P,K,3)
    active_sh_degree: int,
    plane_normal_world: torch.Tensor,  # (P,3) camera-facing
    plane_offset: torch.Tensor,     # (P,) sign-corrected learnt offset
    cam: Camera,
    tile_h: int,
    tile_w: int,
    alive: Optional[torch.Tensor] = None,
    rgb_override: Optional[torch.Tensor] = None,
) -> Splats2D:
    """The plain PyTorch version of `preprocess` (the Splats2D of one
    camera; `rgb_override` replaces the SH colour)."""
    tiles_x = -(-cam.width // tile_w)
    tiles_y = -(-cam.height // tile_h)

    mean_view = tf.apply_transform(cam.view, xyz)
    depth = mean_view[:, 2]
    in_front = depth > NEAR_CULL_Z

    ndc = tf.project_hom(cam.full_proj, xyz)
    mean2d = torch.stack([tf.ndc_to_pixel(ndc[:, 0], cam.width),
                          tf.ndc_to_pixel(ndc[:, 1], cam.height)], dim=-1)

    cov2d = ewa_project(scale, quat, mean_view, cam)
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b * b
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam_max))

    # Opacity-aware per-axis tile rectangle: the intersection of the
    # reference rect of the isotropic min(3, cutoff)*sigma_max radius and
    # the exact tile cover of the alpha >= 1/255 strip (see the JAX
    # package's preprocess for the derivation).
    cutoff = torch.sqrt(2.0 * torch.log(torch.clamp(255.0 * opacity,
                                                    min=1.000001)))
    rect_radius = torch.ceil(torch.clamp(cutoff, max=3.0) * torch.sqrt(lam_max))
    tr_x = cutoff * torch.sqrt(a)
    tr_y = cutoff * torch.sqrt(c)

    def _lo(m, tr, tile, n):
        old = (m - rect_radius) / tile
        return torch.clamp(torch.maximum(to_i32(old),
                                         to_i32(torch.floor((m - tr) / tile))),
                           0, n)

    def _hi(m, tr, tile, n):
        old = (m + rect_radius + tile - 1) / tile
        return torch.clamp(torch.minimum(to_i32(old),
                                         to_i32(torch.floor((m + tr) / tile)) + 1),
                           0, n)

    rect_min = torch.stack([_lo(mean2d[:, 0], tr_x, tile_w, tiles_x),
                            _lo(mean2d[:, 1], tr_y, tile_h, tiles_y)], dim=-1)
    rect_max = torch.stack([_hi(mean2d[:, 0], tr_x, tile_w, tiles_x),
                            _hi(mean2d[:, 1], tr_y, tile_h, tiles_y)], dim=-1)
    rect_max = torch.maximum(rect_max, rect_min)
    n_tiles = ((rect_max[:, 0] - rect_min[:, 0])
               * (rect_max[:, 1] - rect_min[:, 1]))

    valid = in_front & det_ok & (n_tiles > 0) & (opacity > 1.0 / 255.0)
    if alive is not None:
        valid = valid & alive
    radius = torch.where(valid, to_i32(radius_f), 0)
    n_tiles = torch.where(valid, n_tiles, 0)

    if rgb_override is not None:
        rgb = rgb_override
    else:
        d = xyz - cam.cam_pos
        view_dir = d * torch.rsqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                                   + d[:, 2] * d[:, 2] + 1e-24)[:, None]
        max_deg = int(round(sh_coeffs.shape[1] ** 0.5)) - 1
        rgb = torch.clamp(
            shlib.eval_sh(sh_coeffs, view_dir, max_deg, active_sh_degree)
            + 0.5, min=0.0)

    n_cam, dist_cam = camera_plane(plane_normal_world, plane_offset, xyz, cam)

    return Splats2D(
        mean2d=mean2d, depth=depth, conic=conic, opacity=opacity, rgb=rgb,
        plane_normal=n_cam, plane_dist=dist_cam, radius=radius,
        rect_min=rect_min, rect_max=rect_max,
        n_tiles=n_tiles.to(torch.int32),
    )


# the differentiable float outputs, in the order of the backward's
# cotangents, with their trailing widths
GRAD_OUTPUTS = (("mean2d", 2), ("conic", 3), ("rgb", 3), ("plane_normal", 3),
                ("plane_dist", None))


# the forward's outputs, in the order the kernel wrappers return them
OUTPUTS = ("mean2d", "depth", "conic", "rgb", "plane_normal", "plane_dist",
           "radius", "rect_min", "rect_max", "n_tiles")


def preprocess_fwd_plain(xyz, scale, quat, opacity, sh_coeffs,
                         active_sh_degree, plane_normal_world, plane_offset,
                         cam: Camera, tile_h: int, tile_w: int, alive=None):
    """`preprocess_plain`'s fields in the order of OUTPUTS, as
    `preprocess_fwd_cuda` returns them (rgb (P, 0) when `sh_coeffs` is
    None)."""
    sp = preprocess_plain(
        xyz, scale, quat, opacity, sh_coeffs, active_sh_degree,
        plane_normal_world, plane_offset, cam, tile_h, tile_w, alive=alive,
        rgb_override=(None if sh_coeffs is not None
                      else xyz.new_zeros(xyz.shape[0], 0)))
    return tuple(getattr(sp, k) for k in OUTPUTS)


def preprocess_bwd_plain(xyz, scale, quat, sh_coeffs, active_sh_degree,
                         plane_normal_world, plane_offset, cam: Camera, cts):
    """Torch autograd of `preprocess_plain`: `cts` are the cotangents of
    (mean2d, conic, rgb, plane_normal, plane_dist), None for 0 (rgb's is
    not read when `sh_coeffs` is None).  Returns the gradients of (xyz,
    scale, quat, sh_coeffs or None, plane_normal_world, plane_offset)."""
    ins = [xyz, scale, quat, sh_coeffs, plane_normal_world, plane_offset]
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(True)
                  for t in ins]
        x, s, q, sh, n, o = leaves
        P = xyz.shape[0]
        sp = preprocess_plain(
            x, s, q, torch.ones(P, dtype=xyz.dtype, device=xyz.device), sh,
            active_sh_degree, n, o, cam, 1, 1,
            rgb_override=None if sh is not None else x.new_zeros(P, 0))
        outs, grads = [], []
        for (name, _), ct in zip(GRAD_OUTPUTS, cts):
            if name == "rgb" and sh is None:
                continue
            out = getattr(sp, name)
            outs.append(out)
            grads.append(torch.zeros_like(out) if ct is None else ct)
        used = [t for t in leaves if t is not None]
        got = iter(torch.autograd.grad(outs, used, grads, allow_unused=True))
    res = []
    for t in leaves:
        if t is None:
            res.append(None)
            continue
        g = next(got)
        res.append(torch.zeros_like(t) if g is None else g)
    return tuple(res)


def _check_cuda(name, P, tensors, cam, cts=()):
    """Raise ValueError on what the kernels do not take: a tensor that is
    not float32 (alive: bool), of the wrong shape or not contiguous, an SH
    coefficient count outside SH_COEFFS, a cotangent of the wrong type or
    shape, or (checked last) a tensor off the camera's CUDA device."""
    for tname, t, shape in tensors:
        if t is None:
            continue
        want = torch.bool if tname == "alive" else torch.float32
        if t.dtype != want or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} must be {want} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if tname == "sh_coeffs" and shape[1] not in SH_COEFFS:
            raise ValueError(f"{name}: sh_coeffs must have K in {SH_COEFFS} "
                             f"coefficients, got {shape[1]}")
    for tname, t, shape in (("cam.view", cam.view, (4, 4)),
                            ("cam.full_proj", cam.full_proj, (4, 4)),
                            ("cam.cam_pos", cam.cam_pos, (3,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous float32 "
                             f"{shape}")
    for (cname, width), c in zip(GRAD_OUTPUTS, cts):
        shape = (P,) if width is None else (P, width)
        if c is not None and (c.dtype != torch.float32
                              or tuple(c.shape) != shape):
            raise ValueError(f"{name}: the {cname} cotangent must be float32 "
                             f"{shape}, got {c.dtype} {tuple(c.shape)}")
    dev = cam.view.device
    for t in [t for _, t, _ in tensors] + [cam.full_proj, cam.cam_pos,
                                            *cts]:
        if t is not None and (t.device.type != "cuda" or t.device != dev):
            raise ValueError(f"{name}: tensors must be on the camera's CUDA "
                             f"device, got {t.device} and {dev}")


def _inputs(xyz, scale, quat, opacity, sh_coeffs, normal, offset,
            alive=None):
    P = xyz.shape[0]
    K = 0 if sh_coeffs is None else sh_coeffs.shape[1]
    return [("xyz", xyz, (P, 3)), ("scale", scale, (P, 3)),
            ("quat", quat, (P, 4)), ("opacity", opacity, (P,)),
            ("sh_coeffs", sh_coeffs, (P, K, 3)),
            ("plane_normal_world", normal, (P, 3)),
            ("plane_offset", offset, (P,)), ("alive", alive, (P,))]


def _launched(name, err):
    from ibgs_tpu_torch.ops import _cuda
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_cuda.error_string(err)} ({err})")
    LAUNCHES[name] += 1


def preprocess_fwd_cuda(xyz, scale, quat, opacity, sh_coeffs,
                        active_sh_degree, plane_normal_world, plane_offset,
                        cam: Camera, tile_h: int, tile_w: int, alive=None):
    """`preprocess_fwd_plain` (same arguments and outputs) as the CUDA
    forward kernel (csrc/preprocess.cu) on the current stream, one count in
    LAUNCHES."""
    from ibgs_tpu_torch.ops import _cuda

    P = xyz.shape[0]
    _check_cuda("preprocess_fwd_cuda", P,
                _inputs(xyz, scale, quat, opacity, sh_coeffs,
                        plane_normal_world, plane_offset, alive), cam)
    dev = xyz.device
    f32, i32 = torch.float32, torch.int32
    outs = (torch.empty(P, 2, dtype=f32, device=dev),
            torch.empty(P, dtype=f32, device=dev),
            torch.empty(P, 3, dtype=f32, device=dev),
            torch.empty(P, 3 if sh_coeffs is not None else 0, dtype=f32,
                        device=dev),
            torch.empty(P, 3, dtype=f32, device=dev),
            torch.empty(P, dtype=f32, device=dev),
            torch.empty(P, dtype=i32, device=dev),
            torch.empty(P, 2, dtype=i32, device=dev),
            torch.empty(P, 2, dtype=i32, device=dev),
            torch.empty(P, dtype=i32, device=dev))
    with torch.cuda.device(dev):
        err = _cuda.preprocess_fwd(
            xyz, scale, quat, opacity, sh_coeffs, plane_normal_world,
            plane_offset, alive, int(active_sh_degree), cam,
            frustum_limits(cam), tile_h, tile_w, outs,
            torch.cuda.current_stream(dev).cuda_stream)
    _launched("preprocess_fwd", err)
    return outs


def preprocess_bwd_cuda(xyz, scale, quat, sh_coeffs, active_sh_degree,
                        plane_normal_world, plane_offset, cam: Camera, cts):
    """`preprocess_bwd_plain` (same arguments and outputs) as the CUDA
    backward kernel (csrc/preprocess.cu) on the current stream, one count
    in LAUNCHES.  The cotangents are read through their strides."""
    from ibgs_tpu_torch.ops import _cuda

    P = xyz.shape[0]
    cts = tuple(cts)
    _check_cuda("preprocess_bwd_cuda", P,
                _inputs(xyz, scale, quat, None, sh_coeffs,
                        plane_normal_world, plane_offset), cam, cts)
    grads = tuple(None if t is None else torch.empty_like(t)
                  for t in (xyz, scale, quat, sh_coeffs, plane_normal_world,
                            plane_offset))
    dev = xyz.device
    with torch.cuda.device(dev):
        err = _cuda.preprocess_bwd(
            xyz, scale, quat, sh_coeffs, plane_normal_world, plane_offset,
            int(active_sh_degree), cam, frustum_limits(cam), cts, grads,
            torch.cuda.current_stream(dev).cuda_stream)
    _launched("preprocess_bwd", err)
    return grads


class _Preprocess(torch.autograd.Function):
    """`preprocess` as one differentiable op of xyz, scale, quat,
    sh_coeffs, plane_normal_world and plane_offset.  CPU tensors go
    through the plain version and its autograd (`preprocess_fwd_plain`,
    `preprocess_bwd_plain`), CUDA tensors through the kernels
    (`preprocess_fwd_cuda`, `preprocess_bwd_cuda`), which raise on what
    they do not take.  depth and the integer outputs carry no gradient;
    opacity and alive get none."""

    @staticmethod
    def forward(ctx, xyz, scale, quat, opacity, sh_coeffs, normal, offset,
                alive, static):
        active, cam, tile_h, tile_w = static
        ctx.set_materialize_grads(False)
        fwd = (preprocess_fwd_plain if xyz.device.type == "cpu"
               else preprocess_fwd_cuda)
        out = fwd(xyz, scale, quat, opacity, sh_coeffs, active, normal,
                  offset, cam, tile_h, tile_w, alive)
        ctx.save_for_backward(xyz, scale, quat, sh_coeffs, normal, offset)
        ctx.static = (active, cam)
        ctx.mark_non_differentiable(out[1], *out[6:])
        if sh_coeffs is None:
            ctx.mark_non_differentiable(out[3])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_mean2d, _g_depth, g_conic, g_rgb, g_normal, g_dist,
                 *_g_int):
        xyz, scale, quat, sh, normal, offset = ctx.saved_tensors
        active, cam = ctx.static
        bwd = (preprocess_bwd_plain if xyz.device.type == "cpu"
               else preprocess_bwd_cuda)
        gx, gs, gq, gsh, gn, go = bwd(
            xyz, scale, quat, sh, active, normal, offset, cam,
            (g_mean2d, g_conic, g_rgb if sh is not None else None, g_normal,
             g_dist))
        return gx, gs, gq, None, gsh, gn, go, None, None


def preprocess(
    xyz: torch.Tensor,              # (P,3)
    scale: torch.Tensor,            # (P,3) activated
    quat: torch.Tensor,             # (P,4) unit
    opacity: torch.Tensor,          # (P,) activated
    sh_coeffs: Optional[torch.Tensor],  # (P,K,3)
    active_sh_degree: int,
    plane_normal_world: torch.Tensor,  # (P,3) camera-facing
    plane_offset: torch.Tensor,     # (P,) sign-corrected learnt offset
    cam: Camera,
    tile_h: int,
    tile_w: int,
    alive: Optional[torch.Tensor] = None,
    rgb_override: Optional[torch.Tensor] = None,
) -> Splats2D:
    """The Splats2D of one camera, differentiable w.r.t. xyz, scale, quat,
    sh_coeffs, plane_normal_world and plane_offset: the CUDA kernels on
    CUDA tensors, the plain version on CPU tensors.  `opacity` and
    `rgb_override` (which replaces the SH colour) pass through as they
    are."""
    with profiling.annotate("projection"):
        if rgb_override is not None:
            sh_coeffs = None
        (mean2d, depth, conic, rgb, n_cam, dist_cam, radius, rect_min,
         rect_max, n_tiles) = _Preprocess.apply(
            xyz, scale, quat, opacity, sh_coeffs, plane_normal_world,
            plane_offset, alive, (int(active_sh_degree), cam, tile_h, tile_w))
        return Splats2D(
            mean2d=mean2d, depth=depth, conic=conic, opacity=opacity,
            rgb=rgb if rgb_override is None else rgb_override,
            plane_normal=n_cam, plane_dist=dist_cam, radius=radius,
            rect_min=rect_min, rect_max=rect_max, n_tiles=n_tiles)
