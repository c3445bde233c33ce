"""COLMAP sparse-reconstruction parsers, binary and text (counterpart of
ibgs_tpu/data/colmap.py).

Covers what the scene loader reads: cameras (PINHOLE / SIMPLE_PINHOLE /
zero-distortion SIMPLE_RADIAL), images (poses and names) and points3D
(xyz, rgb, reprojection error, track length).  points3D.bin goes through
the native parser (utils/native.py), whose variable-length records are
slow in Python; the Python reader stays for a file the native parser
reports as corrupt.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class ColmapCamera:
    cam_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray   # (4,) wxyz
    tvec: np.ndarray   # (3,)
    camera_id: int
    name: str


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> dict:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{np_}d"))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_cameras_txt(path: str) -> dict:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]))
    return cams


def read_images_bin(path: str) -> dict:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            q = np.array(_read(f, "<4d"))
            t = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            f.seek(24 * npts, os.SEEK_CUR)   # skip the 2D point tracks
            out[iid] = ColmapImage(iid, q, t, cam_id, name.decode())
    return out


def read_images_txt(path: str) -> dict:
    out = {}
    # keep empty lines: each image header is followed by a 2D-points line
    # that may be empty (known-pose files have no tracks)
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.lstrip().startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        el = lines[i].split()
        out[int(el[0])] = ColmapImage(
            int(el[0]), np.array([float(x) for x in el[1:5]]),
            np.array([float(x) for x in el[5:8]]), int(el[8]), el[9])
        i += 2   # skip the (possibly empty) points line
    return out


def read_points3d_bin_python(path: str):
    """→ (xyz f64 (N, 3), rgb u8 (N, 3), err f64 (N,), track_len i64 (N,)),
    record by record."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty((n,), np.float64)
        tl = np.empty((n,), np.int64)
        for i in range(n):
            _read(f, "<Q")                   # point id
            xyz[i] = _read(f, "<3d")
            rgb[i] = _read(f, "<3B")
            (err[i],) = _read(f, "<d")
            (tlen,) = _read(f, "<Q")
            tl[i] = tlen
            f.seek(8 * tlen, os.SEEK_CUR)
    return xyz, rgb, err, tl


def read_points3d_bin(path: str):
    """→ (xyz, rgb, err, track_len) through the native parser."""
    from ibgs_tpu_torch.utils import native

    out = native.parse_colmap_points3d(path)
    return out if out is not None else read_points3d_bin_python(path)


def read_points3d_txt(path: str):
    """→ (xyz, rgb, err, track_len); text rows are
    POINT3D_ID X Y Z R G B ERROR (IMAGE_ID POINT2D_IDX)*."""
    xyz, rgb, err, tl = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([int(x) for x in el[4:7]])
            err.append(float(el[7]))
            tl.append((len(el) - 8) // 2)
    return (np.array(xyz, np.float64), np.array(rgb, np.uint8),
            np.array(err, np.float64), np.array(tl, np.int64))


# The seed-point quality filter: reprojection error > 2.0 px or a track of
# fewer than 3 observations drops the point.
MAX_POINT_ERROR = 2.0
MIN_TRACK_LEN = 3


def load_sparse(sparse_dir: str, filter_points: bool = True):
    """Cameras, images, points and colours of a COLMAP sparse directory
    (bin or txt).  `filter_points` applies the seed-quality filter; when it
    would drop every point (tracks absent from a synthetic export) the
    unfiltered cloud is kept."""
    def pick(stem):
        b = os.path.join(sparse_dir, stem + ".bin")
        t = os.path.join(sparse_dir, stem + ".txt")
        return (b, "bin") if os.path.exists(b) else (t, "txt")

    cpath, cfmt = pick("cameras")
    ipath, ifmt = pick("images")
    ppath, pfmt = pick("points3D")
    cams = read_cameras_bin(cpath) if cfmt == "bin" else read_cameras_txt(cpath)
    imgs = read_images_bin(ipath) if ifmt == "bin" else read_images_txt(ipath)
    pts, rgb, err, tl = (read_points3d_bin(ppath) if pfmt == "bin"
                         else read_points3d_txt(ppath))
    if filter_points and len(pts):
        keep = (err <= MAX_POINT_ERROR) & (tl >= MIN_TRACK_LEN)
        if keep.any():
            pts, rgb = pts[keep], rgb[keep]
    return cams, imgs, pts, rgb
