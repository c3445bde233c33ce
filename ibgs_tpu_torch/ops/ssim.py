"""The SSIM map as hand-written CUDA kernels (csrc/ssim.cu).

`losses.ssim_map` takes the plain chain (`losses.ssim_map_plain`: five
`_blur`s of 11 shift-and-add taps along H and W, each tap a torch launch)
on CPU tensors and `ssim_map_cuda` on CUDA ones: one `ssim_fwd` launch a
call and, where an input needs a gradient, one `ssim_bwd` launch in the
backward, each through `_cuda`.  The map, and every term autograd adds to
an input's gradient through the plain chain, are the plain chain's bit for
bit, and autograd adds them in the same order (`_SsimMap`), so a training
step takes the same gradients as with the plain chain.  There is no
fallback: a CUDA input the kernels do not take raises.

Inputs are (H, W, C) frames or (B, H, W, C) stacks of the same shape,
float32, each frame contiguous; a stack's batch stride may be 0 (one
frame against a stack, as `multi_view_photometric` passes the ground
truth).  Where a gradient is wanted the forward also writes the five
blurred moments (20 bytes an element), held for the backward.
"""
from __future__ import annotations

import functools

import torch

from ibgs_tpu_torch.ops import _cuda

_TH = 16                        # the kernels' tile rows (csrc/ssim.cu)
_I32_MAX = 2 ** 31 - 1


def _frames(t: torch.Tensor):
    """(B, H, W, C) of an (H, W, C) or (B, H, W, C) tensor, and its batch
    stride in floats."""
    if t.dim() == 3:
        return (1, *t.shape), 0
    return tuple(t.shape), t.stride(0) if t.shape[0] > 1 else 0


def _check(img1: torch.Tensor, img2: torch.Tensor):
    """Raise ValueError on what the kernels do not take: a dtype other
    than float32, a rank other than 3 or 4, shapes that differ, sizes out
    of the kernels' range, a frame that is not contiguous or a batch
    stride other than the frame's size or 0, or (checked last) tensors
    that are not on one CUDA device."""
    for name, t in (("img1", img1), ("img2", img2)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssim_map: {name} must be float32, got "
                             f"{t.dtype}")
        if t.dim() not in (3, 4):
            raise ValueError(f"ssim_map: {name} must be (H, W, C) or (B, H, "
                             f"W, C), got shape {tuple(t.shape)}")
    if img1.shape != img2.shape:
        raise ValueError(f"ssim_map: the kernels take inputs of one shape, "
                         f"got {tuple(img1.shape)} and {tuple(img2.shape)}")
    (B, H, W, C), _ = _frames(img1)
    if min(B, H, W, C) < 1 or B > 65535 or -(-H // _TH) > 65535 or \
            H * W * C >= _I32_MAX:
        raise ValueError(f"ssim_map: the kernels take 1 to 65,535 frames of "
                         f"at least 1x1x1 and fewer than 2^31 - 1 elements, "
                         f"at most {65535 * _TH} rows, got {(B, H, W, C)}")
    for name, t in (("img1", img1), ("img2", img2)):
        batch = _frames(t)[1]
        frame = t if t.dim() == 3 else t[0]
        if not frame.is_contiguous() or batch not in (0, H * W * C):
            raise ValueError(f"ssim_map: {name} must be contiguous (a batch "
                             f"stride of 0 aside), got strides "
                             f"{t.stride()}")
    dev = img1.device
    for t in (img1, img2):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"ssim_map: the kernels take tensors on one "
                             f"CUDA device, got {img1.device} and "
                             f"{img2.device}")


@functools.lru_cache(maxsize=None)
def _constants():
    """The window as the kernels take it, and C1, C2 (rounded to float32
    where ctypes passes them, as torch rounds a Python scalar)."""
    from ibgs_tpu_torch.train import losses
    return _cuda.ssim_window(losses._gauss_window()), losses.C1, losses.C2


def _forward(img1, img2, moments: bool):
    """The map (img1's shape) and, where `moments`, the five moments (5,
    B, H, W, C), else None."""
    shape, b1 = _frames(img1)
    b2 = _frames(img2)[1]
    window, c1, c2 = _constants()
    dev = img1.device
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    mom = torch.empty((5, *shape), dtype=torch.float32, device=dev) \
        if moments else None
    _cuda.ssim_fwd(img1, b1, img2, b2, shape, window, c1, c2, out, mom)
    return out.view(img1.shape), mom


def _backward(img1, img2, g, mom, need1: bool, need2: bool):
    """The gradient terms of img1 and of img2, as autograd through the
    plain chain adds them to each (the cross product's, the square's, the
    mean's; the square's twice): three tensors in the map's shape each, or
    None where not wanted."""
    shape, b1 = _frames(img1)
    b2 = _frames(img2)[1]
    window, c1, c2 = _constants()
    g4 = g if g.dim() == 4 else g[None]
    strides = (g4.stride(0) if shape[0] > 1 else 0, *g4.stride()[1:])
    dev = img1.device

    def terms(need):
        return tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                     for _ in range(3)) if need else None
    dx, dy = terms(need1), terms(need2)
    _cuda.ssim_bwd(img1, b1, img2, b2, shape, window, c1, c2, g4, strides,
                   mom, dx, dy)
    return tuple(None if d is None else tuple(t.view(img1.shape) for t in d)
                 for d in (dx, dy))


class _SsimMap(torch.autograd.Function):
    """The map of (x, y).  Each input enters four times, once for each term
    autograd adds to its gradient through the plain chain (x's: the cross
    product's, the square's twice, the mean's), so that the backward hands
    them over apart and autograd adds them to the input's other gradients
    one by one, in the plain chain's order."""

    @staticmethod
    def forward(ctx, x0, x1, x2, x3, y0, y1, y2, y3, need1, need2):
        out, mom = _forward(x0, y0, True)
        ctx.need = (need1, need2)
        ctx.save_for_backward(x0, y0, mom)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, y, mom = ctx.saved_tensors
        out = []
        for d in _backward(x, y, g, mom, *ctx.need):
            out += (None,) * 4 if d is None else (d[0], d[1], d[1], d[2])
        return (*out, None, None)


def ssim_map_cuda(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """`losses.ssim_map_plain` (same arguments and map, bit for bit) as
    the kernels of csrc/ssim.cu on the current stream: one ssim_fwd launch
    and, in the backward, one ssim_bwd launch (autograd's gradients bit for
    bit); no host sync."""
    _check(img1, img2)
    grad = torch.is_grad_enabled()
    need1 = grad and img1.requires_grad
    need2 = grad and img2.requires_grad
    if not (need1 or need2):
        return _forward(img1, img2, False)[0]
    return _SsimMap.apply(*(img1,) * 4, *(img2,) * 4, need1, need2)
