"""Nearest-neighbour initial scales (counterpart of ibgs_tpu/core/knn.py).

An exact blocked brute-force 3-NN on the device: for each block of query
points, |q|² + |p|² - 2 q·p against every point in float32, the point
itself masked, then the 3 smallest by `torch.topk`.  Memory stays at
O(block x N).  The q·p product must be a true float32 matmul: TF32 rounds
the inputs to 10 mantissa bits, and the form cancels catastrophically for
near neighbours, so TF32 is switched off around the call.  Clouds of more
than 200k points go to the native host KNN instead
(`models/gaussians.init_from_points`).
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _full_float32_matmul():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@torch.no_grad()
def mean_sq_dist_to_3nn(points: torch.Tensor, block: int = 1024
                        ) -> torch.Tensor:
    """(N, 3) → (N,) mean squared distance to each point's 3 nearest
    neighbours (excluding itself).  Exact; O(N²) work."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    sq = (pts * pts).sum(-1)
    cols = torch.arange(n, device=pts.device)
    out = []
    with _full_float32_matmul():
        for s in range(0, n, block):
            q, qsq = pts[s:s + block], sq[s:s + block]
            d = qsq[:, None] + sq[None, :] - 2.0 * (q @ pts.T)
            d = torch.clamp(d, min=0.0)
            d = torch.where(cols[None, :] == cols[s:s + block, None],
                            torch.inf, d)
            out.append(torch.topk(d, 3, dim=1, largest=False).values
                       .mean(-1))
    return torch.cat(out)


def initial_log_scales(points: torch.Tensor) -> torch.Tensor:
    """log sqrt(clamped mean 3-NN squared distance), isotropic: (N, 3)."""
    d2 = torch.clamp(mean_sq_dist_to_3nn(points), min=1e-7)
    return torch.log(torch.sqrt(d2))[:, None].repeat(1, 3)
