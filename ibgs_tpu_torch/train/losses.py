"""Training losses (counterpart of ibgs_tpu/train/losses.py).

L1 / L2 / PSNR, exact-float32 SSIM with an 11-tap σ = 1.5 Gaussian window
(separable, zero padding, H pass then W pass, shift-and-add as the JAX
package does it), the 3DGS image loss, single-view normal consistency and
the multi-view photometric loss, whose `vmap` over the S source views is a
leading batch dimension here.  Images are (H, W, C), or (S, H, W, C) for
stacks.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def l1(a, b):
    return torch.abs(a - b).mean()


def l2(a, b):
    return ((a - b) ** 2).mean()


def psnr(a, b):
    mse = ((a - b) ** 2).mean()
    return -10.0 * torch.log10(mse + 1e-12)


@functools.lru_cache(maxsize=None)
def _gauss_window(size: int = 11, sigma: float = 1.5) -> tuple:
    """The normalised 1-D window as float32 values (Python floats)."""
    x = np.arange(size, dtype=np.float32) - size // 2
    w = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return tuple(float(v) for v in (w / w.sum()).astype(np.float32))


def _blur(img: torch.Tensor, size: int = 11, sigma: float = 1.5):
    """(…, H, W, C) zero-padded separable blur: H pass, then W pass."""
    w = _gauss_window(size, sigma)
    pad = size // 2
    for axis in (-3, -2):
        n = img.shape[axis]
        padw = [0, 0] * (-axis)
        padw[-2], padw[-1] = pad, pad
        xp = F.pad(img, padw)
        acc = None
        for k in range(size):
            t = xp.narrow(axis, k, n) * w[k]
            acc = t if acc is None else acc + t
        img = acc
    return img


def ssim_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-pixel, per-channel SSIM map (…, H, W, C)."""
    mu1 = _blur(img1)
    mu2 = _blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur(img1 * img1) - mu1_sq
    s2 = _blur(img2 * img2) - mu2_sq
    s12 = _blur(img1 * img2) - mu12
    return ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))


def ssim(img1, img2):
    return ssim_map(img1, img2).mean()


def photometric_ssim(ref, warped):
    """Per-pixel channel-mean SSIM map (…, H, W)."""
    return ssim_map(ref, warped).mean(-1)


def dssim_l1(pred, gt, lambda_dssim: float = 0.2):
    """The 3DGS image loss."""
    return (1.0 - lambda_dssim) * l1(pred, gt) + lambda_dssim * (
        1.0 - ssim(pred, gt))


def normal_consistency(rendered_normal, depth_normal, weight: float):
    """Single-view normal loss; inputs (H, W, 3)."""
    l1_term = torch.abs(depth_normal - rendered_normal).sum(-1).mean()
    cos_term = (1.0 - (depth_normal * rendered_normal).sum(-1)).mean()
    return weight * (0.4 * l1_term + 0.6 * cos_term)


def multi_view_photometric(gt, warped_stack, valid_mask,
                           photo_ssim_weight: float, photo_weight: float):
    """Multi-view photometric loss.  gt: (H, W, 3); warped_stack:
    (S, H, W, 3); valid_mask: (S, H, W) bool.  Invalid pixels are replaced
    by gt (zero residual)."""
    vm = valid_mask[..., None].to(gt.dtype)
    masked = vm * warped_stack + (1.0 - vm) * gt[None]
    valid = valid_mask.to(gt.dtype)
    any_valid = valid.sum()
    smap = photometric_ssim(gt[None].expand_as(masked), masked)  # (S, H, W)
    ssim_term = ((1.0 - smap) * valid).sum() / (any_valid + 1e-9)
    l1_map = torch.abs(gt[None] - masked).mean(-1)
    l1_term = (l1_map * valid).sum() / (any_valid + 1e-9)
    loss = ((1 - photo_ssim_weight) * l1_term
            + photo_ssim_weight * ssim_term) * photo_weight
    return torch.where(any_valid > 0, loss, 0.0)
