"""Drive the port's public API end to end on a synthetic scene and save a
PNG (counterpart of the JAX package's examples/render_synthetic.py).

    python -m ibgs_tpu_torch.examples.render_synthetic --out render.png \\
        [--size 128 96] [--device cuda]

Renders a coloured grid of Gaussians through the full IBGS geometry path
(plane depths, the median buffer, the warp into two source views).  On
the card the render goes through the CUDA kernels and is held to the
plain path (the same scene rendered on the CPU); it then checks the
depths, takes a finite gradient with respect to the centres, and writes
the image.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ibgs_tpu_torch.core.camera import look_at_camera
from ibgs_tpu_torch.models.gaussians import init_from_points
from ibgs_tpu_torch.ops.epilogue import SourceViews
from ibgs_tpu_torch.ops.rasterize import RasterConfig
from ibgs_tpu_torch.renderer import render_view

CAP = 1 << 14
N_SRC = 2


def grid_scene(width: int = 128, height: int = 96, device="cuda") -> dict:
    """The example's scene: a 7x7 grid of Gaussians on a wavy plane at
    the origin, a camera 3 units away looking at it, two random source
    views at depth 3, and the background colour."""
    dev = torch.device(device)
    g = np.mgrid[-3:4, -3:4].reshape(2, -1).T.astype(np.float32) * 0.22
    pts = np.concatenate([g, np.full((len(g), 1), 0.0, np.float32)], axis=1)
    pts[:, 2] += 0.05 * np.sin(3 * pts[:, 0])
    cols = np.stack([(g[:, 0] + 1) / 2 % 1, (g[:, 1] + 1) / 2 % 1,
                     np.full(len(g), 0.6)], axis=1).astype(np.float32)
    model = init_from_points(pts, cols, max_sh_degree=2, device=dev)
    cam = look_at_camera([0.0, 0.0, -3.0], [0.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                         0.8, 0.8, width, height, dev)
    rng = np.random.default_rng(0)
    src = SourceViews(
        images=torch.as_tensor(rng.random((N_SRC, height, width, 3)),
                               dtype=torch.float32).to(dev),
        depths=torch.full((N_SRC, height, width), 3.0, device=dev),
        ref_to_src=torch.eye(4, device=dev).repeat(N_SRC, 1, 1),
        cam_pos=torch.as_tensor(rng.random((N_SRC, 3)) * 0.1,
                                dtype=torch.float32).to(dev),
        count=N_SRC)
    return dict(model=model, cam=cam, src=src,
                bg=torch.tensor([0.1, 0.1, 0.15], device=dev))


def render(scene: dict, model=None):
    """The geometry render with the warp (RenderResult)."""
    res, _ = render_view(model or scene["model"], scene["cam"],
                         RasterConfig(instance_cap=CAP), scene["bg"],
                         src=scene["src"], render_geo=True)
    return res


def xyz_grad(scene: dict) -> torch.Tensor:
    """d(mean colour + 1e-3 mean median depth) / d(centres)."""
    import dataclasses
    m = scene["model"]
    xyz = m.params.xyz.detach().requires_grad_(True)
    model = dataclasses.replace(
        m, params=dataclasses.replace(m.params, xyz=xyz))
    r = render(scene, model)
    loss = r.render.mean() + r.median_depth.mean() * 1e-3
    (g,) = torch.autograd.grad(loss, [xyz])
    return g


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="render_synthetic.png")
    ap.add_argument("--size", type=int, nargs=2, default=(128, 96))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the render (default cuda)")
    args = ap.parse_args(argv)
    W, H = args.size

    scene = grid_scene(W, H, args.device)
    a = render(scene)
    b = render(grid_scene(W, H, "cpu"))          # the plain path
    for name, r in ((args.device, a), ("cpu", b)):
        print(f"[{name}] render mean={float(r.render.mean()):.4f} "
              f"median_depth mean={float(r.median_depth.mean()):.3f} "
              f"n_instances={int(r.n_instances)}")
    np.testing.assert_allclose(a.render.cpu().numpy(), b.render.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(a.median_depth.cpu().numpy(),
                               b.median_depth.numpy(), rtol=1e-3, atol=1e-4)
    print("device / plain parity OK")

    depth = a.median_depth.cpu().numpy()
    covered = a.final_t.cpu().numpy() < 0.9    # init opacity is 0.1 (3DGS)
    assert covered.any(), "no splat coverage"
    d = depth[covered]
    assert 2.0 < d.mean() < 4.0, f"depth off: {d.mean()}"  # camera at z≈3

    gx = xyz_grad(scene)
    assert bool(torch.isfinite(gx).all()), "non-finite grads"
    print(f"grad finite OK  |dxyz| max={float(gx.abs().max()):.2e}")

    from ibgs_tpu_torch.utils.image_io import write_png
    img = np.clip(a.render.detach().cpu().numpy() * 255, 0, 255).astype(
        np.uint8)
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
