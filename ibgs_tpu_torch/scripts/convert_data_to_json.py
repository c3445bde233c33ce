"""COLMAP sparse model → transforms.json + split.json (counterpart of the
JAX package's scripts/preprocess/convert_data_to_json.py, on the port's
`data/colmap.py`).

transforms.json carries per-frame GL-convention c2w matrices plus the scene
bounds (sphere centre/radius + AABB), chosen per scene type exactly like the
reference: `object` bounds by camera poses, `indoor` by the sparse points,
`outdoor` by poses when the trajectory is concentric else by points.

--write_split additionally emits the split.json the training loader
consumes ({"train": [...], "test": [...]} image-stem lists, every-Nth
holdout).

    python -m ibgs_tpu_torch.scripts.convert_data_to_json --data_dir <scene> \
        [--scene_type outdoor|indoor|object] [--write_split] [--hold 8]
"""
import argparse
import json
import math
import os

import numpy as np

from ibgs_tpu_torch.data import colmap


def _c2w_stack(imgs):
    names, mats = [], []
    for iid in sorted(imgs, key=lambda k: imgs[k].name):
        im = imgs[iid]
        R = colmap.qvec_to_rotmat(im.qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = im.tvec
        names.append(im.name)
        mats.append(np.linalg.inv(w2c))
    return names, np.stack(mats)


def _closest_point(p1, d1, p2, d2):
    """Midpoint of the shortest segment between two rays (reference
    find_closest_point, least squares on the two ray parameters)."""
    d1 = d1 / np.linalg.norm(d1)
    d2 = d2 / np.linalg.norm(d2)
    A = np.stack([d1, -d2], axis=1)
    t = np.linalg.lstsq(A, p2 - p1, rcond=None)[0]
    return 0.5 * ((p1 + d1 * t[0]) + (p2 + d2 * t[1]))


def bound_by_pose(c2w):
    """Centre = mean pairwise look-at ray intersection; radius = mean
    camera-centre norm (reference bound_by_pose)."""
    centers, looks = c2w[:, :3, 3], c2w[:, :3, 2]
    acc = np.zeros(3)
    for i in range(len(c2w)):
        for j in range(len(c2w)):
            acc += _closest_point(centers[i], looks[i], centers[j], looks[j])
    center = acc / len(c2w) ** 2
    radius = float(np.linalg.norm(centers, axis=-1).mean())
    bb = [[center[k] - radius, center[k] + radius] for k in range(3)]
    return center, radius, bb


def bound_by_points(pts):
    """Centre/std of the sparse cloud; radius = 2σ, box = ±3σ (reference
    bound_by_points)."""
    center = pts.mean(0)
    std = pts.std(0)
    radius = float(std.max() * 2)
    bb = [[center[k] - 3 * std[k], center[k] + 3 * std[k]] for k in range(3)]
    return center, radius, bb


def check_concentric(c2w, ang_tol=np.pi / 6, radii_tol=0.5, pose_tol=0.5):
    """Fraction of cameras that look at their common centre from a common
    radius (reference check_concentric)."""
    centers, looks = c2w[:, :3, 3], c2w[:, :3, 2]
    looks = looks / np.linalg.norm(looks, axis=-1, keepdims=True)
    mid = centers.mean(0)
    vec = mid - centers
    radii = np.linalg.norm(vec, axis=-1)
    ang = np.arccos(np.clip((looks * (vec / (radii[:, None] + 1e-12))
                             ).sum(-1), -1, 1))
    valid = (ang < ang_tol) & np.isclose(radii.mean(), radii, rtol=radii_tol)
    return valid.mean() > pose_tol


def export_transforms(data_dir, scene_type="outdoor"):
    sparse = os.path.join(data_dir, "sparse")
    if os.path.isdir(os.path.join(sparse, "0")):
        sparse = os.path.join(sparse, "0")
    cams, imgs, pts, _ = colmap.load_sparse(sparse, filter_points=False)
    names, c2w = _c2w_stack(imgs)

    if scene_type == "object":
        center, radius, bb = bound_by_pose(c2w)
    elif scene_type == "indoor":
        center, radius, bb = bound_by_points(pts)
    elif scene_type == "outdoor":
        center, radius, bb = (bound_by_pose(c2w) if check_concentric(c2w)
                              else bound_by_points(pts))
    else:
        raise ValueError(scene_type)

    cam = cams[min(cams)]
    if cam.model == "PINHOLE":
        fx, fy, cx, cy = cam.params[:4]
    else:
        fx = fy = cam.params[0]
        cx, cy = cam.params[1:3]
    w, h = cam.width, cam.height
    gl = np.array([1, -1, -1, 1])[:, None]   # CV → GL row signs

    out = {
        "camera_angle_x": math.atan(w / (fx * 2)) * 2,
        "camera_angle_y": math.atan(h / (fy * 2)) * 2,
        "fl_x": float(fx), "fl_y": float(fy),
        "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0,
        "is_fisheye": False,
        "cx": float(cx), "cy": float(cy), "w": int(w), "h": int(h),
        "aabb_scale": float(np.exp2(np.rint(np.log2(max(radius, 1e-6))))),
        "aabb_range": bb,
        "sphere_center": list(map(float, center)),
        "sphere_radius": float(radius),
        "frames": [{"file_path": "images/" + n,
                    "transform_matrix": (c2w[i] * gl).tolist()}
                   for i, n in enumerate(names)],
    }
    path = os.path.join(data_dir, "transforms.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print("wrote", path)
    return out


def write_split(data_dir, hold=8):
    """split.json with an every-`hold`th test holdout over name-sorted
    stems — the file the loader consumes (data/dataset.py)."""
    sparse = os.path.join(data_dir, "sparse")
    if os.path.isdir(os.path.join(sparse, "0")):
        sparse = os.path.join(sparse, "0")
    _, imgs, _, _ = colmap.load_sparse(sparse, filter_points=False)
    stems = sorted(os.path.splitext(imgs[i].name)[0] for i in imgs)
    split = {"train": [s for k, s in enumerate(stems) if k % hold != 0],
             "test": [s for k, s in enumerate(stems) if k % hold == 0]}
    path = os.path.join(data_dir, "split.json")
    with open(path, "w") as f:
        json.dump(split, f, indent=2)
    print(f"wrote {path} ({len(split['train'])} train / "
          f"{len(split['test'])} test)")
    return split


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--scene_type", default="outdoor",
                   choices=["outdoor", "indoor", "object"])
    p.add_argument("--write_split", action="store_true")
    p.add_argument("--hold", type=int, default=8)
    args = p.parse_args(argv)
    export_transforms(args.data_dir, args.scene_type)
    if args.write_split:
        write_split(args.data_dir, args.hold)


if __name__ == "__main__":
    main()
