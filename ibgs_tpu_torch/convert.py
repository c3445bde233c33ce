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
* `ring_source_cameras` / `bundle_train_scene` / `bundle_eval_scene`:
  the bundle's cameras rebuilt exactly, a training scene (5 views, the
  seed cloud) from a converged-scene bundle, and that scene with the
  bundle view as its one test view.
* `train_state_from_jax_checkpoint`: a JAX package `chkpnt<N>.npz`
  (positional leaves) as a port training state, so a JAX run can be
  resumed by the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ibgs_tpu_torch.core.camera import (Camera, camera_from_view,
                                        look_at_camera, make_camera)
from ibgs_tpu_torch.core.sh import C0
from ibgs_tpu_torch.models.aggregation import ColorFusionResidualNet
from ibgs_tpu_torch.models.gaussians import (STAT_FIELDS, GaussianModel,
                                             GaussianParams,
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


RING_TARGET, RING_UP = (0.0, 0.0, 0.0), (0.0, -1.0, 0.0)


def ring_source_cameras(d, width: int, height: int, device="cuda"):
    """The bundle's reference and source cameras, rebuilt exactly.  The
    bundle holds a view of `data/synthetic`'s ring (scripts/
    make_bench_bundle.py), whose cameras look at the origin with up
    (0, -1, 0); its `src_ref_to_src` products carry the bf16 rounding of
    the TPU matmul that made them (source views off by 3.4e-3 to 3.7e-3),
    while `src_cam_pos` is exact.  So the source cameras are the look-at
    cameras at `src_cam_pos`.  Raises ValueError for a bundle of another
    scene (the reference camera not a ring camera, or a source camera more
    than 1e-2 from its stored transform)."""
    fovx, fovy = float(d["fovx"]), float(d["fovy"])
    ref = camera_from_numpy(d["cam_R"], d["cam_t"], fovx, fovy, width,
                            height, device)
    ref_view = ref.view.cpu().numpy()

    def ring(eye):
        return look_at_camera(np.asarray(eye, np.float64), RING_TARGET,
                              RING_UP, fovx, fovy, width, height, device)

    cams = [ring(c) for c in np.asarray(d["src_cam_pos"])]
    stored = source_cameras(ref_view, d["src_ref_to_src"], fovx, fovy,
                            width, height, device)
    off_ref = float(np.abs(ring(ref.cam_pos.cpu().numpy()).view.cpu()
                           .numpy() - ref_view).max())
    off_src = max(float((a.view - b.view).abs().max())
                  for a, b in zip(cams, stored))
    if off_ref > 1e-5 or off_src > 1e-2:
        raise ValueError(f"not a ring bundle: reference camera {off_ref} "
                         f"and source cameras {off_src} off their look-at "
                         f"cameras")
    return ref, cams


def bundle_train_scene(d, width: int, height: int, device="cuda"):
    """A training SceneData from a converged-scene bundle at width x
    height: 5 train views (the bundle camera with `gt`, the source cameras
    of `ring_source_cameras` with `src_images`, resized bilinearly), the
    bundle's splat centres as the seed cloud with colours sh_dc·C0 + 0.5
    clipped to [0, 1], each view's nearest ids the other four by centre
    distance, and the nerf++ extent of the 5 centres.  No test views."""
    from ibgs_tpu_torch.data.dataset import (CameraInfo, SceneData,
                                             _nerfpp_extent,
                                             nearest_by_centre)

    ref, src = ring_source_cameras(d, width, height, device)
    cams = [ref] + src
    infos = []
    for k, c in enumerate(cams):
        view = c.view.cpu().numpy()
        infos.append(CameraInfo(
            uid=k, R=view[:3, :3].T, T=view[:3, 3], fovx=float(d["fovx"]),
            fovy=float(d["fovy"]), width=width, height=height,
            image_path=f"bundle_{k}", image_name=f"bundle_{k}"))
    images = _resize(np.concatenate([np.asarray(d["gt"])[None],
                                     np.asarray(d["src_images"])]),
                     height, width, "cpu").numpy()
    centers = np.stack([c.cam_pos.cpu().numpy() for c in cams])
    sh_dc = np.asarray(d["sh_dc"], np.float32).reshape(-1, 3)
    return SceneData(
        train_cameras=cams, test_cameras=[], train_infos=infos,
        test_infos=[], images=images.astype(np.float32),
        test_images=np.zeros((0, height, width, 3), np.float32),
        points=np.asarray(d["xyz"], np.float32),
        colors=np.clip(sh_dc * np.float32(C0) + np.float32(0.5), 0.0,
                       1.0).astype(np.float32),
        cameras_extent=_nerfpp_extent(infos),
        nearest_ids=nearest_by_centre(centers),
        test_nearest_ids=[], white_background=False)


def bundle_eval_scene(d, width: int, height: int, device="cuda"):
    """`bundle_train_scene` with one test view: the bundle camera with
    `gt`, whose nearest ids are the 4 ring sources (train views 1-4)."""
    scene = bundle_train_scene(d, width, height, device)
    return dataclasses.replace(
        scene, test_cameras=scene.train_cameras[:1],
        test_infos=scene.train_infos[:1], test_images=scene.images[:1],
        test_nearest_ids=[list(range(1, scene.n_train))])


def _flax_net_leaves() -> list:
    """The fusion net's Flax parameter paths in the order jax.tree
    flattens them (dict keys sorted)."""
    names = []
    for i in range(9):
        names += [f"ConvDecoderAE_0.Conv_{i}.bias",
                  f"ConvDecoderAE_0.Conv_{i}.kernel"]
    for k in ("Dense_0", "Dense_1"):
        names += [f"{k}.bias", f"{k}.kernel"]
    return names


def _jax_leaf_names(with_net: bool) -> list:
    """The names of the positional leaves of a JAX package checkpoint, in
    the order of its TrainState's flattening: the GaussianModel fields in
    declaration order (params, mu, nu as 8 fields each, step, alive, the
    five statistics, active_sh_degree), app_ab, app_opt (mu, nu, step),
    the Flax net tree, net_opt (mu tree, nu tree, step) and
    spatial_lr_scale."""
    names = [f"{tree}.{k}" for tree in ("params", "mu", "nu")
             for k in PARAM_FIELDS]
    names += ["step", "alive", *STAT_FIELDS, "active_sh_degree", "app_ab",
              "app_opt.mu", "app_opt.nu", "app_opt.step"]
    if with_net:
        net = _flax_net_leaves()
        names += [f"net.{n}" for n in net]
        names += [f"net_opt.mu.{n}" for n in net]
        names += [f"net_opt.nu.{n}" for n in net]
        names += ["net_opt.step"]
    return names + ["spatial_lr_scale"]


def _flax_tree(d: dict, prefix: str) -> dict:
    """The nested Flax parameter tree of the leaves `prefix`<path> of d."""
    tree = {}
    for name in _flax_net_leaves():
        *mods, leaf = name.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = d[prefix + name]
    return tree


def train_state_from_jax_checkpoint(path: str, net=None, device="cuda"):
    """(TrainState, iteration) from a JAX package checkpoint.  `net` is a
    ColorFusionResidualNet whose aggregation mode the restored net takes
    (None for a run without colour aggregation); the saved weights and
    moments go through `fusion_net_from_flax`."""
    from ibgs_tpu_torch.train.trainer import SideOptState, TrainState

    with np.load(path) as data:
        n = sum(k.startswith("leaf_") for k in data.files)
        names = _jax_leaf_names(net is not None)
        if n != len(names):
            raise ValueError(f"{path}: {n} leaves, expected {len(names)} "
                             f"for a run {'with' if net else 'without'} "
                             f"the fusion net")
        d = {name: data[f"leaf_{i}"] for i, name in enumerate(names)}
        iteration = int(data["__iteration"])

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def tree(prefix):
        return GaussianParams(**{k: t(d[f"{prefix}.{k}"])
                                 for k in PARAM_FIELDS})

    params = tree("params")
    model = GaussianModel(
        params=params, alive=t(d["alive"]),
        active_sh_degree=int(d["active_sh_degree"]),
        max_sh_degree=_SH_DEGREE[params.sh_rest.shape[1]],
        mu=tree("mu"), nu=tree("nu"), step=int(d["step"]),
        **{k: t(d[k]) for k in STAT_FIELDS})
    app_opt = SideOptState(mu=[t(d["app_opt.mu"])], nu=[t(d["app_opt.nu"])],
                           step=int(d["app_opt.step"]))
    net_opt = None
    if net is not None:
        def as_net(prefix):
            return fusion_net_from_flax(_flax_tree(d, prefix),
                                        net.feat_aggregate_mode, device)

        def moments(prefix):
            return [p.detach() for p in as_net(prefix).parameters()]

        net = as_net("net.")
        net_opt = SideOptState(mu=moments("net_opt.mu."),
                               nu=moments("net_opt.nu."),
                               step=int(d["net_opt.step"]))
    state = TrainState(model=model, app_ab=t(d["app_ab"]), app_opt=app_opt,
                       net=net, net_opt=net_opt,
                       spatial_lr_scale=float(d["spatial_lr_scale"]))
    return state, iteration
