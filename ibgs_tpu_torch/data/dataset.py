"""Scene loading: COLMAP / Blender datasets → the scene container
(counterpart of ibgs_tpu/data/dataset.py).

* COLMAP scenes from `sparse[/0]`, an optional `split.json`, else every
  8th image held out under --eval;
* Blender `transforms_train.json` scenes with white-background
  compositing;
* resolution: -1 caps the width at 1600, 1/2/4/8 are downsample factors,
  another positive value is a target width;
* the camera extent of the nerf++ normalisation;
* each camera's nearest training views by (distance, angle), with the
  exposure-aware reordering.

All images of a scene share one resolution: stragglers are resized to the
most common one.  PNG files are read by `utils/image_io` (no PIL
needed); other formats, and a resize, need PIL.  Cameras are port
`Camera`s on the scene's device; the images stay numpy float32
(N, H, W, 3) on the host.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ibgs_tpu_torch.core import transforms as tf
from ibgs_tpu_torch.core.camera import Camera, make_camera
from ibgs_tpu_torch.data import colmap
from ibgs_tpu_torch.utils import image_io


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray          # (3, 3) camera → world rotation
    T: np.ndarray          # (3,) world → camera translation
    fovx: float
    fovy: float
    width: int
    height: int
    image_path: str
    image_name: str


@dataclass
class SceneData:
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    train_infos: List[CameraInfo]
    test_infos: List[CameraInfo]
    images: np.ndarray             # (N, H, W, 3) float32 train images
    test_images: np.ndarray        # (M, H, W, 3)
    points: np.ndarray             # (P0, 3) seed cloud
    colors: np.ndarray             # (P0, 3) in [0, 1]
    cameras_extent: float
    nearest_ids: List[List[int]]        # per train camera
    test_nearest_ids: List[List[int]]   # per test camera
    white_background: bool = False

    @property
    def n_train(self):
        return len(self.train_cameras)

    def poses_stack(self):
        """(N, 4, 4) world → view, (N, 3) centres and (N, 3) unit central
        rays of the train cameras, float32 tensors on their device."""
        w2v = torch.stack([c.view for c in self.train_cameras])
        centers = torch.stack([c.cam_pos for c in self.train_cameras])
        rays = np.stack([i.R[:, 2] for i in self.train_infos])
        rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
        return w2v, centers, torch.as_tensor(
            rays.astype(np.float32)).to(w2v.device)


def _resolve_resolution(width, height, resolution, resolution_scale=1.0):
    if resolution in (1, 2, 4, 8):
        scale = resolution_scale * resolution
        return round(width / scale), round(height / scale)
    if resolution == -1:
        global_down = width / 1600 if width > 1600 else 1
    else:
        global_down = width / resolution
    scale = float(global_down) * resolution_scale
    return int(width / scale), int(height / scale)


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        raise ImportError("PIL is needed to read images other than PNG and "
                          "to resize images; it does not import") from None
    return Image


def _load_image(path, size, white_background=False):
    if path.lower().endswith(".png") and image_io.png_size(path) == size:
        arr = image_io.read_png(path)
    else:
        Image = _pil_image()
        img = Image.open(path)
        if img.size != size:
            img = img.resize(size, Image.LANCZOS)
        arr = np.asarray(img)
    arr = arr.astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    if arr.shape[-1] == 4:
        alpha = arr[..., 3:4]
        bgv = 1.0 if white_background else 0.0
        arr = arr[..., :3] * alpha + bgv * (1 - alpha)
    return arr[..., :3]


def _nerfpp_extent(infos: List[CameraInfo]) -> float:
    centers = np.stack([-(i.R @ i.T) for i in infos])
    center = centers.mean(0, keepdims=True)
    dist = np.linalg.norm(centers - center, axis=-1)
    return float(dist.max() * 1.1)


def _read_colmap_infos(source: str, images_dir: str, eval_split: bool):
    sparse = os.path.join(source, "sparse", "0")
    if not os.path.exists(sparse):
        sparse = os.path.join(source, "sparse")
    cams, imgs, pts, rgb = colmap.load_sparse(sparse)

    infos = []
    for iid in sorted(imgs, key=lambda k: imgs[k].name):
        im = imgs[iid]
        cam = cams[im.camera_id]
        R = colmap.qvec_to_rotmat(im.qvec).T     # camera → world
        if cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
        elif cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model == "SIMPLE_RADIAL" and abs(cam.params[3]) < 1e-8:
            # zero radial distortion is a pinhole camera (params f, cx, cy, k)
            fx = fy = cam.params[0]
        else:
            raise ValueError(
                f"COLMAP camera model {cam.model!r} (camera {cam.cam_id}) is "
                "not supported: only undistorted datasets (PINHOLE / "
                "SIMPLE_PINHOLE) are. Run `colmap image_undistorter` (or "
                "scripts/preprocess_colmap.py) first.")
        infos.append(CameraInfo(
            uid=len(infos), R=R, T=im.tvec,
            fovx=tf.focal_to_fov(fx, cam.width),
            fovy=tf.focal_to_fov(fy, cam.height),
            width=cam.width, height=cam.height,
            image_path=os.path.join(source, images_dir, im.name),
            image_name=os.path.splitext(im.name)[0],
        ))

    split_path = os.path.join(source, "split.json")
    if eval_split and os.path.exists(split_path):
        # both lists count: a name in neither is left out
        with open(split_path) as f:
            split = json.load(f)
        test_names = set(split.get("test", []))
        train_names = set(split.get("train", [])) or {
            i.image_name for i in infos if i.image_name not in test_names}
        train = [i for i in infos if i.image_name in train_names]
        test = [i for i in infos if i.image_name in test_names]
    elif eval_split:
        train = [i for k, i in enumerate(infos) if k % 8 != 0]
        test = [i for k, i in enumerate(infos) if k % 8 == 0]
    else:
        train, test = infos, []
    return train, test, pts, rgb.astype(np.float32) / 255.0


def _read_blender_infos(source: str, white_background: bool,
                        eval_split: bool):
    def read(split):
        path = os.path.join(source, f"transforms_{split}.json")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        infos = []
        for fr in meta["frames"]:
            c2w = np.array(fr["transform_matrix"])
            c2w[:3, 1:3] *= -1            # blender → colmap convention
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            fp = os.path.join(source, fr["file_path"] + ".png")
            w, h = image_io.png_size(fp)
            fovy = tf.focal_to_fov(tf.fov_to_focal(fovx, w), h)
            infos.append(CameraInfo(
                uid=len(infos), R=R, T=T, fovx=fovx, fovy=fovy,
                width=w, height=h, image_path=fp,
                image_name=os.path.splitext(os.path.basename(fp))[0]))
        return infos

    train = read("train")
    test = read("test") if eval_split else []
    n = 100_000
    rng = np.random.default_rng(0)
    pts = rng.random((n, 3)) * 2.6 - 1.3
    rgb = rng.random((n, 3)).astype(np.float32)
    return train, test, pts, rgb


def _neighbor_ids(centers, rays, w2v, q_centers, q_rays, q_w2v, cfg):
    """Each query camera's nearest training cameras: sorted by distance,
    then angle; within max_angle and (min_dis, max_dis); the first `num`;
    with `exposure_reorder` the one of the most similar pose first."""
    out = []
    inv_w2v = np.linalg.inv(w2v)
    for qi in range(q_centers.shape[0]):
        dist = np.linalg.norm(q_centers[qi][None] - centers, axis=-1)
        dots = np.clip((q_rays[qi][None] * rays).sum(-1), -1.0, 1.0)
        ang = np.degrees(np.arccos(dots))
        order = np.lexsort((ang, dist))
        mask = ((ang[order] < cfg["max_angle"])
                & (dist[order] > cfg["min_dis"])
                & (dist[order] < cfg["max_dis"]))
        sel = order[mask][: cfg["num"]]
        if len(sel) and cfg.get("exposure_reorder"):
            rel = q_w2v[qi][None] @ inv_w2v[sel]
            diff = np.abs(rel - np.eye(4)[None]).mean(axis=(1, 2))
            best = sel[np.argmin(diff)]
            sel = np.concatenate([[best], sel[sel != best]])
        out.append([int(s) for s in sel])
    return out


def nearest_by_centre(centers: np.ndarray, num: int = 4) -> List[List[int]]:
    """Each camera's `num` nearest other cameras by centre distance (the
    synthetic and bundle scenes' neighbour lists)."""
    out = []
    for c in centers:
        dist = np.linalg.norm(c[None] - centers, axis=-1)
        out.append([int(o) for o in np.argsort(dist)[1:num + 1]])
    return out


def _pose_arrays(cams, infos):
    w2v = np.stack([c.view.cpu().numpy() for c in cams])
    centers = np.stack([c.cam_pos.cpu().numpy() for c in cams])
    rays = np.stack([i.R[:, 2] for i in infos])
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return centers, rays, w2v


def load_scene(
    source_path: str,
    images_dir: str = "images",
    resolution: int = -1,
    eval_split: bool = False,
    white_background: bool = False,
    multi_view_num: int = 8,
    multi_view_max_angle: float = 30.0,
    multi_view_min_dis: float = 0.01,
    multi_view_max_dis: float = 1.5,
    exposure_reorder: bool = False,
    resolution_scale: float = 1.0,
    device="cuda",
) -> SceneData:
    if os.path.exists(os.path.join(source_path, "sparse")):
        train_i, test_i, pts, rgb = _read_colmap_infos(
            source_path, images_dir, eval_split)
    elif os.path.exists(os.path.join(source_path, "transforms_train.json")):
        train_i, test_i, pts, rgb = _read_blender_infos(
            source_path, white_background, eval_split)
    else:
        raise ValueError(f"unrecognised scene layout: {source_path}")

    extent = _nerfpp_extent(train_i)

    # one common resolution for the whole scene
    sizes = [_resolve_resolution(i.width, i.height, resolution,
                                 resolution_scale) for i in train_i + test_i]
    W, H = max(set(sizes), key=sizes.count)

    def build(infos):
        cams, imgs = [], []
        for i in infos:
            cams.append(make_camera(i.R, i.T, i.fovx, i.fovy, W, H, device))
            imgs.append(_load_image(i.image_path, (W, H), white_background))
        return cams, (np.stack(imgs) if imgs
                      else np.zeros((0, H, W, 3), np.float32))

    train_c, train_imgs = build(train_i)
    test_c, test_imgs = build(test_i)

    centers, rays, w2v = _pose_arrays(train_c, train_i)
    ncfg = dict(num=multi_view_num, max_angle=multi_view_max_angle,
                min_dis=multi_view_min_dis, max_dis=multi_view_max_dis,
                exposure_reorder=exposure_reorder)
    nearest = _neighbor_ids(centers, rays, w2v, centers, rays, w2v, ncfg)
    if test_c:
        t_nearest = _neighbor_ids(centers, rays, w2v,
                                  *_pose_arrays(test_c, test_i), ncfg)
    else:
        t_nearest = []

    return SceneData(
        train_cameras=train_c, test_cameras=test_c,
        train_infos=train_i, test_infos=test_i,
        images=train_imgs, test_images=test_imgs,
        points=pts.astype(np.float32), colors=rgb.astype(np.float32),
        cameras_extent=extent,
        nearest_ids=nearest, test_nearest_ids=t_nearest,
        white_background=white_background,
    )


def write_multiview_json(scene: SceneData, model_path: str):
    """The neighbour lists as multi_view.json / multi_view_test.json (one
    JSON record per camera: its name and its neighbours' names)."""
    os.makedirs(model_path, exist_ok=True)
    for fname, infos, nbr in (
            ("multi_view.json", scene.train_infos, scene.nearest_ids),
            ("multi_view_test.json", scene.test_infos,
             scene.test_nearest_ids)):
        if not infos:
            continue
        with open(os.path.join(model_path, fname), "w") as f:
            for info, ids in zip(infos, nbr):
                rec = {"ref_name": info.image_name,
                       "nearest_name": [scene.train_infos[i].image_name
                                        for i in ids]}
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
