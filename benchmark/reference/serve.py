"""The served view of `EvalRenderer.render_one` (a frozen copy of the
port's sequence): a depth-only re-render of each source view, the
geometry render of the target view with the image-based warp into the
sources, and the colour-fusion net.  Returns the source depths too."""
from __future__ import annotations

import torch

from benchmark.reference import aggregation
from benchmark.reference.renderer import (render_depth_view, render_view,
                                          source_views_from_stacks)


@torch.no_grad()
def render_one(model, net, stacks, train_cameras, opt, rcfg, cam, nearest
               ) -> dict:
    """stacks: dict of the train views' images (N, H, W, 3), w2v (N, 4,
    4) and centers (N, 3)."""
    dev = cam.view.device
    H, W = stacks["images"].shape[1:3]
    nbrs = list(nearest[: opt.number_src_frames])
    depths = [render_depth_view(model, train_cameras[i], rcfg,
                                opt.learnt_normal) for i in nbrs]
    S = rcfg.max_src
    idx = torch.zeros(S, dtype=torch.long)
    idx[: len(nbrs)] = torch.as_tensor(nbrs, dtype=torch.long)
    idx = idx.to(dev)
    dstack = torch.stack(depths + [torch.zeros(H, W, device=dev)]
                         * (S - len(depths)))
    src = source_views_from_stacks(
        stacks["images"][idx], dstack, stacks["w2v"][idx],
        stacks["centers"][idx], torch.arange(S, device=dev), len(nbrs), cam)
    res, _ = render_view(model, cam, rcfg, torch.zeros(3, device=dev),
                         src=src, learnt_normal=opt.learnt_normal,
                         render_geo=True, return_depth_normal=True)
    out = dict(render=res.render, depth=res.median_depth,
               warped=res.ibr.warped_image, source_depths=depths)
    fusion = aggregation.fuse_color(
        net, res.render, res.ibr.warped_image, res.ibr.cam_feat,
        res.ibr.camera_ray, res.ibr.min_depth_diff,
        res.ibr.use_first_src_mask, 1.0, opt.nb_visible_src_frames,
        opt.enable_exposure_correction, opt.residual_resolution_scale,
        opt.enable_mix_precision)
    out["aggregate"] = torch.where(fusion["any_valid"], fusion["image_pred"],
                                   res.render)
    return out
