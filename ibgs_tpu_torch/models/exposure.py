"""Exposure correction of the fusion step (counterpart of
`exposure_affine` in ibgs_tpu/models/aggregation.py).

With `enable_exposure_correction`, `aggregation.fuse_color` fits the
render to the first warped source before the net sees it: a masked
least-squares affine over the valid pixels, solved from float32 normal
equations, and applied to the render.  The call runs under the
`exposure` span, inside `net`.
"""
from __future__ import annotations

import torch


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
