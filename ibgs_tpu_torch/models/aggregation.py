"""Colour-fusion residual network and exposure correction, forward
(counterpart of ibgs_tpu/models/aggregation.py).

The modules take and return the JAX package's (H, W, C) layouts and run
NCHW convolutions inside.  Sub-module names follow the Flax parameter tree
(`Dense_0`, `Dense_1`, `ConvDecoderAE_0`, `Conv_0`..`Conv_8`), so that
`ibgs_tpu_torch.convert.fusion_net_from_flax` can carry weights across.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ibgs_tpu_torch.ops.epilogue import bilinear_sample
from ibgs_tpu_torch.utils import profiling


def _nearest_index(m: int, n: int, device) -> torch.Tensor:
    """Source rows of a half-pixel-centre nearest resize m → n, computed in
    float32 as jax.image.resize(..., "nearest") computes them."""
    off = (np.arange(n, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(m) / np.float32(n)
    idx = np.minimum(np.floor(off.astype(np.float32)).astype(np.int64), m - 1)
    return torch.as_tensor(idx, device=device)


def resize_nearest(x: torch.Tensor, H2: int, W2: int) -> torch.Tensor:
    """(N, C, H, W) → (N, C, H2, W2) nearest resize with half-pixel
    centres."""
    H, W = x.shape[-2], x.shape[-1]
    x = x.index_select(-2, _nearest_index(H, H2, x.device))
    return x.index_select(-1, _nearest_index(W, W2, x.device))


class ConvDecoderAE(nn.Module):
    """Two-level hourglass with input skip."""

    def __init__(self, hidden: int):
        super().__init__()
        h = hidden
        # (in, out, kernel) in the Flax module's call order
        specs = [(h, h, 3), (h, h // 2, 3), (h // 2, h // 4, 3),
                 (h // 4, h // 2, 3), (2 * (h // 2), h // 2, 3),
                 (h // 2, h, 3), (2 * h, h, 3), (2 * h, h, 1), (h, 3, 1)]
        for i, (cin, cout, k) in enumerate(specs):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, cout, k,
                                                   padding=k // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (H, W, C)
        c = [getattr(self, f"Conv_{i}") for i in range(9)]
        x = x.permute(2, 0, 1)[None]
        e1 = F.relu(c[0](x))
        p1 = F.max_pool2d(e1, 2)
        e2 = F.relu(c[1](p1))
        p2 = F.max_pool2d(e2, 2)
        bott = F.relu(c[2](p2))

        u2 = resize_nearest(bott, e2.shape[-2], e2.shape[-1])
        u2 = F.relu(c[3](u2))
        d2 = F.relu(c[4](torch.cat([u2, e2], 1)))

        u1 = resize_nearest(d2, e1.shape[-2], e1.shape[-1])
        u1 = F.relu(c[5](u1))
        d1 = F.relu(c[6](torch.cat([u1, e1], 1)))

        fused = F.relu(c[7](torch.cat([d1, x], 1)))
        return c[8](fused)[0].permute(1, 2, 0)


class ColorFusionResidualNet(nn.Module):
    """Aggregates per-view features into a per-pixel RGB residual."""

    def __init__(self, per_view_feat_dim: int = 32,
                 feat_aggregate_mode: str = "mean"):
        super().__init__()
        d = per_view_feat_dim
        self.feat_aggregate_mode = feat_aggregate_mode
        self.Dense_0 = nn.Linear(7, d)
        self.Dense_1 = nn.Linear(d, d)
        self.ConvDecoderAE_0 = ConvDecoderAE(hidden=d + 6)

    def forward(self, view_feats, ray_dir, rendered):
        """view_feats: (H, W, S, 7); ray_dir, rendered: (H, W, 3)."""
        f = F.relu(self.Dense_0(view_feats))
        f = F.relu(self.Dense_1(f))
        if self.feat_aggregate_mode == "max":
            agg = f.amax(dim=2)
        else:
            agg = f.mean(dim=2)
        x = torch.cat([agg, ray_dir.to(agg.dtype), rendered.to(agg.dtype)], -1)
        return self.ConvDecoderAE_0(x)


def init_fusion_net(net: ColorFusionResidualNet,
                    generator: torch.Generator) -> ColorFusionResidualNet:
    """Seeded initialisation in Flax's default scheme: LeCun-normal kernels
    (variance 1 / fan_in) and zero biases."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                w = mod.weight
                fan_in = w[0].numel()
                w.copy_(torch.randn(w.shape, generator=generator)
                        * float(np.sqrt(1.0 / fan_in)))
                mod.bias.zero_()
    return net


def exposure_affine(render, first_warped, valid_mask):
    """Fit I_warp ≈ A·[I_render; 1] on valid pixels (no grad through the
    fit) by float32 normal equations and apply A.  render/first_warped:
    (H, W, 3); valid_mask: (H, W).  Callers that compare with the JAX
    package keep TF32 off (torch.backends.cuda.matmul.allow_tf32)."""
    m = valid_mask.to(render.dtype).reshape(-1, 1)
    X = torch.cat([render.reshape(-1, 3), torch.ones_like(m)], dim=-1)
    Y = first_warped.reshape(-1, 3)
    Xs = X.detach() * m
    Ys = Y.detach() * m
    G = Xs.T @ Xs + 1e-6 * torch.eye(4, dtype=render.dtype,
                                     device=render.device)
    A = torch.linalg.solve(G, Xs.T @ Ys)
    return (X @ A).reshape(render.shape), A.T


def resize_align_corners(x: torch.Tensor, H2: int, W2: int) -> torch.Tensor:
    """Bilinear resize of (H, W, C) with the corner-to-corner convention."""
    H, W = x.shape[0], x.shape[1]
    dev = x.device
    u = (torch.linspace(0.0, W - 1.0, W2, device=dev) if W2 > 1
         else torch.zeros(1, device=dev))
    v = (torch.linspace(0.0, H - 1.0, H2, device=dev) if H2 > 1
         else torch.zeros(1, device=dev))
    gv, gu = torch.meshgrid(v, u, indexing="ij")
    return bilinear_sample(x, gu, gv)


def fuse_color(net: ColorFusionResidualNet, render, warped_image, cam_feat,
               camera_ray, min_depth_diff, use_first_src_mask,
               burned_in_gauss: float, nb_visible: int,
               enable_exposure_correction: bool = False,
               residual_resolution_scale: float = 1.0,
               enable_mix_precision: bool = False):
    """Fusion step: image_pred = burned_in·render + residual(net).  Until
    burn-in completes (`burned_in_gauss < 1`) the Gaussian branch is
    detached.  With `enable_mix_precision` the net runs under bf16
    autocast and its residual comes back as float32."""
    with profiling.annotate("net"):
        g = 1.0 if burned_in_gauss >= 1.0 else 0.0

        def gate(x):
            return g * x + (1.0 - g) * x.detach()

        render_g = gate(render)
        warped = gate(warped_image[:nb_visible])
        feat = gate(cam_feat[:nb_visible])
        ray = gate(camera_ray)
        mdd = min_depth_diff.detach()

        if enable_exposure_correction:
            first = warped_image[0] * use_first_src_mask[..., None]
            render_g, _A = exposure_affine(render_g, first, use_first_src_mask)

        valid = (feat.sum(-1, keepdim=True) > 0.0).to(render.dtype)
        residual_in = (warped - render_g[None]) * valid
        view_feats = torch.cat([residual_in, feat], dim=-1)     # (S',H,W,7)
        view_feats = view_feats.permute(1, 2, 0, 3)             # (H,W,S',7)

        def apply_net(vf, r, rg):
            if enable_mix_precision:
                with torch.autocast(device_type=render.device.type,
                                    dtype=torch.bfloat16):
                    return net(vf, r, rg).to(render.dtype)
            return net(vf, r, rg)

        H, W = render.shape[0], render.shape[1]
        if residual_resolution_scale != 1.0:
            H2 = int(H * residual_resolution_scale)
            W2 = int(W * residual_resolution_scale)
            Sv = view_feats.shape[2]
            vf = resize_align_corners(view_feats.reshape(H, W, Sv * 7), H2,
                                      W2).reshape(H2, W2, Sv, 7)
            render_n = resize_align_corners(render_g, H2, W2)
            ray_n = resize_align_corners(ray, H2, W2)
            ray_n = ray_n / (torch.linalg.norm(ray_n, dim=-1, keepdim=True)
                             + 1e-10)
            residual = resize_align_corners(apply_net(vf, ray_n, render_n),
                                            H, W)
        else:
            residual = apply_net(view_feats, ray, render_g)
        image_pred = burned_in_gauss * render_g + residual
        any_valid = (warped_image.sum(dim=(1, 2, 3)) != 0).sum() > 0
        return {
            "image_pred": image_pred,
            "residual": residual,
            "valid_warp_mask": (mdd < 0.999).to(render.dtype),
            "burned_in_gauss": burned_in_gauss,
            "any_valid": any_valid,
            "exposed_render": render_g,
        }
