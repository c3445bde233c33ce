"""Carry a model, cameras and fusion-net weights across from the JAX
package's numpy forms.

* `gaussians_from_numpy`: the eight `GaussianParams` fields as numpy
  arrays (the key names of `bench_bundle.npz`).
* `fusion_net_from_flax`: a Flax parameter tree of
  `ColorFusionResidualNet` → the PyTorch module (Dense kernels (in, out) →
  Linear weights (out, in), Conv kernels HWIO → OIHW, biases as they are).
* `camera_from_numpy` / `source_cameras`: cameras from a pose, and source
  cameras from reference-to-source transforms.
* `bundle_scene`: the serving inputs of a converged-scene bundle.
* `train_state_from_numpy`: a training state from the parameter fields,
  optional Adam moments, the exposure table and the fusion net, so that
  both packages can start a step from one state.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ibgs_tpu_torch.core.camera import Camera, camera_from_view, make_camera
from ibgs_tpu_torch.models.aggregation import ColorFusionResidualNet
from ibgs_tpu_torch.models.gaussians import (GaussianModel, GaussianParams,
                                             with_train_state)

PARAM_FIELDS = ("xyz", "sh_dc", "sh_rest", "log_scale", "quat",
                "opacity_logit", "normal", "offset")
_SH_DEGREE = {0: 0, 3: 1, 8: 2, 15: 3}


def gaussians_from_numpy(d, device="cuda") -> GaussianModel:
    """GaussianModel with every row alive and the SH degree read from the
    shape of `sh_rest`."""
    params = GaussianParams(**{
        k: torch.as_tensor(np.asarray(d[k], np.float32)).to(device)
        for k in PARAM_FIELDS})
    n = params.xyz.shape[0]
    deg = _SH_DEGREE[params.sh_rest.shape[1]]
    return GaussianModel(params=params,
                         alive=torch.ones(n, dtype=torch.bool, device=device),
                         active_sh_degree=deg, max_sh_degree=deg)


def fusion_net_from_flax(params_np, feat_aggregate_mode: str = "mean",
                         device="cuda") -> ColorFusionResidualNet:
    """ColorFusionResidualNet holding the weights of a Flax parameter tree
    (with or without the top-level "params" key)."""
    p = params_np.get("params", params_np)
    d = np.asarray(p["Dense_0"]["kernel"]).shape[1]
    net = ColorFusionResidualNet(d, feat_aggregate_mode)
    sd = {}
    for name in ("Dense_0", "Dense_1"):
        sd[f"{name}.weight"] = np.asarray(p[name]["kernel"]).T
        sd[f"{name}.bias"] = np.asarray(p[name]["bias"])
    dec = p["ConvDecoderAE_0"]
    for i in range(9):
        c = dec[f"Conv_{i}"]
        sd[f"ConvDecoderAE_0.Conv_{i}.weight"] = \
            np.asarray(c["kernel"]).transpose(3, 2, 0, 1)
        sd[f"ConvDecoderAE_0.Conv_{i}.bias"] = np.asarray(c["bias"])
    net.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                         for k, v in sd.items()})
    return net.to(device)


def camera_from_numpy(R, t, fovx: float, fovy: float, width: int,
                      height: int, device="cuda") -> Camera:
    """Camera from a COLMAP-style pose (R cam→world, t world→cam)."""
    return make_camera(np.asarray(R), np.asarray(t), float(fovx),
                       float(fovy), width, height, device)


def source_cameras(ref_view, ref_to_src, fovx: float, fovy: float,
                   width: int, height: int, device="cuda"):
    """Source cameras with the reference camera's intrinsics and
    projection: view_src = ref_to_src @ view_ref."""
    ref_view = np.asarray(ref_view, np.float32)
    return [camera_from_view(np.asarray(m, np.float32) @ ref_view, fovx,
                             fovy, width, height, device)
            for m in np.asarray(ref_to_src, np.float32)]


def _resize(x: np.ndarray, H: int, W: int, device) -> torch.Tensor:
    """(…, h, w, C) numpy → (…, H, W, C) tensor, bilinear with half-pixel
    centres (align_corners=False)."""
    t = torch.as_tensor(np.asarray(x, np.float32)).to(device)
    if t.shape[-3:-1] == (H, W):
        return t
    lead = t.shape[:-3]
    t = t.reshape((-1,) + t.shape[-3:]).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(H, W), mode="bilinear", align_corners=False)
    return t.permute(0, 2, 3, 1).reshape(lead + (H, W, t.shape[1]))


def bundle_scene(d, width: int, height: int, device="cuda") -> dict:
    """Serving inputs of a converged-scene bundle at width x height: the
    model, the reference camera, its ground truth, and the source views as
    train-view stacks (images, w2v, centers, cameras) plus their cached
    depths.  Images and depths are resized bilinearly when the size
    differs from the bundle's."""
    fovx, fovy = float(d["fovx"]), float(d["fovy"])
    cam = camera_from_numpy(d["cam_R"], d["cam_t"], fovx, fovy, width,
                            height, device)
    ref_view = cam.view.cpu().numpy()
    cams = source_cameras(ref_view, d["src_ref_to_src"], fovx, fovy, width,
                          height, device)
    return dict(
        model=gaussians_from_numpy(d, device),
        cam=cam,
        gt=_resize(d["gt"], height, width, device),
        images=_resize(d["src_images"], height, width, device),
        src_depths=_resize(np.asarray(d["src_depths"])[..., None], height,
                           width, device)[..., 0],
        w2v=torch.stack([c.view for c in cams]),
        centers=torch.as_tensor(np.asarray(d["src_cam_pos"], np.float32)
                                ).to(device),
        train_cameras=cams,
        count=int(d["src_count"]),
    )


def cameras_extent(centers) -> float:
    """Scene extent of the nerf++ normalisation: 1.1 x the largest distance
    of a camera centre from their mean."""
    c = np.asarray(centers, np.float64)
    return float(1.1 * np.linalg.norm(c - c.mean(0), axis=-1).max())


def train_state_from_numpy(d, net=None, mu=None, nu=None, app_ab=None,
                           step: int = 0, spatial_lr_scale: float = 1.0,
                           feat_aggregate_mode: str = "mean",
                           device="cuda"):
    """TrainState from the eight `GaussianParams` fields of `d`, optional
    Adam moments `mu` / `nu` (dicts of the same fields, zeros when absent),
    the (APP_CAPACITY, 2) exposure table `app_ab` (zeros when absent) and
    the fusion net: a ColorFusionResidualNet, a Flax parameter tree, or
    None.  Side-optimiser moments start at zero."""
    from ibgs_tpu_torch.train.trainer import (APP_CAPACITY, SideOptState,
                                              TrainState)

    def moments(m):
        if m is None:
            return None
        return GaussianParams(**{
            k: torch.as_tensor(np.asarray(m[k], np.float32)).to(device)
            for k in PARAM_FIELDS})

    model = with_train_state(gaussians_from_numpy(d, device), moments(mu),
                             moments(nu), step)
    app = (torch.zeros(APP_CAPACITY, 2) if app_ab is None
           else torch.as_tensor(np.asarray(app_ab, np.float32))).to(device)
    if net is not None and not isinstance(net, ColorFusionResidualNet):
        net = fusion_net_from_flax(net, feat_aggregate_mode, device)
    if net is not None:
        net = net.to(device)
    return TrainState(
        model=model, app_ab=app, app_opt=SideOptState.init([app]), net=net,
        net_opt=(SideOptState.init(list(net.parameters()))
                 if net is not None else None),
        spatial_lr_scale=float(spatial_lr_scale))
