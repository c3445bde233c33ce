"""PLY import / export of Gaussian point clouds (counterpart of
ibgs_tpu/data/ply.py; the files are byte-identical to the JAX package's).

Binary little-endian PLY with the reference attribute layout: x, y, z,
nx, ny, nz, nd (the IBGS plane fields), f_dc_*, f_rest_*, opacity,
scale_*, rot_*, so that snapshots open in standard 3DGS viewers.  Plain
numpy, no plyfile dependency.
"""
from __future__ import annotations

import numpy as np


def _field_names(n_rest: int):
    names = ["x", "y", "z", "nx", "ny", "nz", "nd"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_gaussian_ply(path, xyz, normal, offset, sh_dc, sh_rest,
                      opacity_logit, log_scale, quat):
    """All inputs raw (pre-activation) numpy arrays; sh_dc (N, 1, 3) and
    sh_rest (N, K-1, 3) in the (coeff, channel) layout, written
    channel-major."""
    n = xyz.shape[0]
    f_dc = np.ascontiguousarray(sh_dc.transpose(0, 2, 1)).reshape(n, -1)
    f_rest = np.ascontiguousarray(sh_rest.transpose(0, 2, 1)).reshape(n, -1)
    cols = np.concatenate(
        [xyz, normal, offset.reshape(n, 1), f_dc, f_rest,
         opacity_logit.reshape(n, 1), log_scale, quat], axis=1
    ).astype("<f4")
    names = _field_names(f_rest.shape[1])
    assert cols.shape[1] == len(names)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        header += [f"property float {nm}" for nm in names]
        header += ["end_header", ""]
        f.write("\n".join(header).encode())
        f.write(cols.tobytes())


def load_gaussian_ply(path):
    """A dict of the raw parameter arrays (the reverse of save)."""
    with open(path, "rb") as f:
        names = []
        n = 0
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(n * len(names) * 4), dtype="<f4")
    data = data.reshape(n, len(names))
    col = {nm: i for i, nm in enumerate(names)}

    def take(prefix, count):
        return data[:, [col[f"{prefix}_{i}"] for i in range(count)]]

    n_rest = sum(1 for nm in names if nm.startswith("f_rest_"))
    f_dc = take("f_dc", 3).reshape(n, 3, 1).transpose(0, 2, 1)
    f_rest = take("f_rest", n_rest).reshape(n, 3, n_rest // 3).transpose(
        0, 2, 1)
    return dict(
        xyz=data[:, [col["x"], col["y"], col["z"]]],
        normal=data[:, [col["nx"], col["ny"], col["nz"]]],
        offset=data[:, [col["nd"]]],
        sh_dc=f_dc,
        sh_rest=f_rest,
        opacity_logit=data[:, [col["opacity"]]],
        log_scale=take("scale", 3),
        quat=take("rot", 4),
    )
