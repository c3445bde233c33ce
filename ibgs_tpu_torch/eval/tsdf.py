"""TSDF depth-map fusion and mesh extraction (counterpart of
ibgs_tpu/eval/tsdf.py).

* `TSDFVolume.integrate`: dense truncated-SDF fusion of rendered median
  depth maps and colours; `tsdf`, `weight` and `color` are tensors on the
  volume's device, updated in chunks of `CHUNK_VOXELS` voxels (every voxel
  is independent, so the chunking changes no value);
* `marching_cubes` (marching tetrahedra), `post_process_mesh` (scipy) and
  the mesh PLY reader / writer: numpy on the host, the JAX package's code
  line for line, so meshes are byte-identical and
  `scripts/eval_geometry.py` reads the port's meshes unchanged.

Arithmetic follows the JAX package's float32 steps as XLA compiles them
on the CPU, so that both packages give the same voxel positions bit for
bit: XLA fuses the x and y voxel centres' index * voxel + origin into one
rounding and leaves z in two, and forms the world-to-camera product as a
chain of fused multiply-adds over the three inputs in order, then adds
the translation.  A fused multiply-add is formed here in float64, where
the product is exact, and rounded once to float32; being plain IEEE
arithmetic it gives the same bits on the card.  Pixel indices round half
to even, then clip, then gather; the SDF divides by the truncation
through a 0-dim tensor (IEEE division on the card too); the running
weighted means keep the JAX order.
"""
from __future__ import annotations

import numpy as np
import torch

from ibgs_tpu_torch.core.camera import device_scalar

CHUNK_VOXELS = 1 << 24


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 round(a * b + c) of float64 operands holding float32
    values: the product is exact in float64, so the sum rounds once there
    and once more to float32 (the two roundings differ from one only when
    the float64 sum lands on a float32 tie)."""
    return (a * b + c).float()


class TSDFVolume:
    def __init__(self, bounds_min, bounds_max, voxel_size=0.02,
                 sdf_trunc=None, device="cuda"):
        self.origin = np.asarray(bounds_min, np.float32)
        self.voxel = float(voxel_size)
        self.trunc = float(sdf_trunc if sdf_trunc is not None
                           else 4.0 * voxel_size)
        dims = np.ceil((np.asarray(bounds_max) - self.origin)
                       / self.voxel).astype(int) + 1
        self.dims = tuple(int(d) for d in dims)
        self.device = torch.device(device)
        self.tsdf = torch.ones(self.dims, dtype=torch.float32,
                               device=self.device)
        self.weight = torch.zeros(self.dims, dtype=torch.float32,
                                  device=self.device)
        self.color = torch.zeros(self.dims + (3,), dtype=torch.float32,
                                 device=self.device)

    def _camera_points(self, lo: int, hi: int, w2c: torch.Tensor):
        """Camera-space x, y and z, each (hi - lo,), of the flat voxels
        [lo, hi) (grid C order) under the float32 world-to-camera w2c."""
        _, Y, Z = self.dims
        i = torch.arange(lo, hi, device=self.device)
        vox = float(np.float32(self.voxel))
        org = [float(o) for o in self.origin]
        gx = _fma((i // (Y * Z)).double(), vox, org[0])
        gy = _fma(((i // Z) % Y).double(), vox, org[1])
        gz = (i % Z).float() * vox + org[2]
        w = w2c.double()
        pc = []
        for r in range(3):
            acc = gx * w2c[r, 0]
            acc = _fma(gy.double(), w[r, 1], acc.double())
            acc = _fma(gz.double(), w[r, 2], acc.double())
            pc.append(acc + w2c[r, 3])
        return pc

    @torch.no_grad()
    def integrate(self, depth, image, K, w2c):
        """Fuse one view: depth (H, W), image (H, W, 3), K (3, 3)
        intrinsics and w2c (4, 4) world-to-camera, as tensors or arrays."""
        dev = self.device

        def t(x):
            if torch.is_tensor(x):
                return x.to(device=dev, dtype=torch.float32)
            return torch.as_tensor(np.array(x, np.float32)).to(dev)

        depth, image, K, w2c = t(depth), t(image), t(K), t(w2c)
        H, W = depth.shape
        trunc = device_scalar(self.trunc, dev)
        tsdf_f = self.tsdf.view(-1)
        w_f = self.weight.view(-1)
        c_f = self.color.view(-1, 3)
        n = tsdf_f.numel()
        for lo in range(0, n, CHUNK_VOXELS):
            hi = min(lo + CHUNK_VOXELS, n)
            x, y, z = self._camera_points(lo, hi, w2c)
            u = x * K[0, 0] / z + K[0, 2]
            v = y * K[1, 1] / z + K[1, 2]
            ui = torch.clamp(torch.round(u).to(torch.int32), 0, W - 1)
            vi = torch.clamp(torch.round(v).to(torch.int32), 0, H - 1)
            ui, vi = ui.long(), vi.long()
            d = depth[vi, ui]
            valid = ((z > 0.05) & (u >= 0) & (u <= W - 1) & (v >= 0)
                     & (v <= H - 1) & (d > 0))
            sdf = (d - z) / trunc
            valid = valid & (sdf > -1.0)
            sdf = torch.clamp(sdf, -1.0, 1.0)
            wnew = valid.to(torch.float32)
            w_old = w_f[lo:hi]
            wsum = w_old + wnew
            denom = torch.clamp(wsum, min=1e-9)
            tsdf_f[lo:hi] = torch.where(
                wnew > 0, (tsdf_f[lo:hi] * w_old + sdf * wnew) / denom,
                tsdf_f[lo:hi])
            col = image[vi, ui]
            c_f[lo:hi] = torch.where(
                (wnew > 0)[:, None],
                (c_f[lo:hi] * w_old[:, None] + col * wnew[:, None])
                / denom[:, None], c_f[lo:hi])
            w_f[lo:hi] = wsum

    def extract_mesh(self, min_weight=1.0):
        """Marching tetrahedra over the voxels of weight >= min_weight, on
        the host (the volume is copied there once)."""
        vol = self.tsdf.cpu().numpy()
        w = self.weight.cpu().numpy()
        vol = np.where(w >= min_weight, vol, np.nan)
        verts, faces = marching_cubes(vol, 0.0)
        verts = verts * self.voxel + self.origin
        return verts, faces


# ---------------------------------------------------------------------------
# Marching tetrahedra (table-free, vectorised)
# ---------------------------------------------------------------------------

_CORNER = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
# six tetrahedra around the 0-6 cube diagonal
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])


def _tet_case_table():
    """Derive the 16-case marching-tetrahedra triangulation.

    Each case maps the 4-bit inside mask to up to 2 triangles; a triangle
    is 3 edges, an edge a (lo, hi) pair of tet-vertex ids.  (Orientation is
    not made globally consistent — the geometry evals are orientation
    agnostic.)"""
    edges = {}
    eid = []
    for a in range(4):
        for b in range(a + 1, 4):
            edges[(a, b)] = len(eid)
            eid.append((a, b))

    def E(a, b):
        return edges[(min(a, b), max(a, b))]

    table = []
    for mask in range(16):
        inside = [i for i in range(4) if mask >> i & 1]
        out = [i for i in range(4) if i not in inside]
        tris = []
        if len(inside) == 1:
            v = inside[0]
            tris = [[E(v, out[0]), E(v, out[1]), E(v, out[2])]]
        elif len(inside) == 3:
            v = out[0]
            tris = [[E(v, inside[0]), E(v, inside[1]), E(v, inside[2])]]
        elif len(inside) == 2:
            a, b = inside
            c, d = out
            tris = [[E(a, c), E(a, d), E(b, d)],
                    [E(a, c), E(b, d), E(b, c)]]
        row = (tris + [[-1, -1, -1]] * 2)[:2]
        table.append(row)
    return np.array(table), np.array(eid)


_TET_TABLE, _TET_EDGES = _tet_case_table()


def marching_cubes(vol: np.ndarray, level: float = 0.0):
    """Isosurface of vol (X, Y, Z); NaN marks unobserved voxels.  Returns
    (verts (V,3) in voxel coords, faces (F,3))."""
    vol = np.asarray(vol, np.float32)
    X, Y, Z = vol.shape
    cell = np.stack([
        vol[c[0]:X - 1 + c[0], c[1]:Y - 1 + c[1], c[2]:Z - 1 + c[2]]
        for c in _CORNER], axis=-1).reshape(-1, 8)         # (C, 8)
    finite = np.isfinite(cell).all(-1)
    has_lo = (np.nanmin(cell, axis=-1, initial=np.inf) < level)
    has_hi = (np.nanmax(cell, axis=-1, initial=-np.inf) >= level)
    active = np.nonzero(finite & has_lo & has_hi)[0]
    if len(active) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    cz = active % (Z - 1)
    cy = (active // (Z - 1)) % (Y - 1)
    cx = active // ((Z - 1) * (Y - 1))
    origin = np.stack([cx, cy, cz], -1).astype(np.float32)  # (A, 3)
    vals = cell[active]                                      # (A, 8)

    all_tris = []
    for tet in _TETS:
        tv = vals[:, tet]                                    # (A, 4)
        tp = _CORNER[tet].astype(np.float32)                 # (4, 3)
        mask = ((tv < level) << np.arange(4)).sum(-1)        # (A,)
        # interpolated point on each of the 6 tet edges
        a, b = _TET_EDGES[:, 0], _TET_EDGES[:, 1]
        va, vb = tv[:, a], tv[:, b]
        t = np.clip((level - va) / np.where(np.abs(vb - va) < 1e-12,
                                            1e-12, vb - va), 0.0, 1.0)
        ep = tp[a][None] + t[..., None] * (tp[b] - tp[a])[None]  # (A, 6, 3)
        tris = _TET_TABLE[mask]                              # (A, 2, 3)
        keep_a, keep_t = np.nonzero(tris[:, :, 0] >= 0)
        if len(keep_a) == 0:
            continue
        eidx = tris[keep_a, keep_t]                          # (K, 3)
        pts = ep[keep_a[:, None], eidx]                      # (K, 3, 3)
        pts = pts + origin[keep_a][:, None, :]
        all_tris.append(pts)
    if not all_tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tri_pts = np.concatenate(all_tris).reshape(-1, 3)
    faces = np.arange(len(tri_pts), dtype=np.int64).reshape(-1, 3)
    key = np.round(tri_pts / 1e-4).astype(np.int64)
    _, uniq_idx, inv = np.unique(key, axis=0, return_index=True,
                                 return_inverse=True)
    verts = tri_pts[uniq_idx].astype(np.float32)
    faces = inv[faces]
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts, faces[good]


def post_process_mesh(verts, faces, cluster_to_keep=1000):
    """Drop small connected triangle clusters (reference render.py
    post_process_mesh semantics: keep clusters at least half the size of the
    cluster_to_keep-th largest)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    if len(faces) == 0:
        return verts, faces
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [0, 2]]])
    g = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                   shape=(len(verts), len(verts)))
    _, labels = connected_components(g, directed=False)
    flab = labels[faces[:, 0]]
    sizes = np.bincount(flab)
    order = np.sort(sizes)[::-1]
    thresh = max(order[min(cluster_to_keep, len(order)) - 1] * 0.5, 50)
    keep = sizes[flab] >= thresh
    faces = faces[keep]
    used = np.unique(faces)
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def save_mesh_ply(path, verts, faces, colors=None):
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(verts)}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {len(faces)}",
                "property list uchar int vertex_indices", "end_header", ""]
        f.write("\n".join(hdr).encode())
        if colors is not None:
            v = np.empty(len(verts), dtype=[("xyz", "<f4", 3),
                                            ("rgb", "u1", 3)])
            v["xyz"] = verts
            v["rgb"] = np.clip(colors * 255, 0, 255).astype(np.uint8)
            f.write(v.tobytes())
        else:
            f.write(verts.astype("<f4").tobytes())
        fdata = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        fdata["n"] = 3
        fdata["idx"] = faces
        f.write(fdata.tobytes())


def load_mesh_ply(path):
    """Minimal binary/ascii PLY mesh reader (verts + faces)."""
    with open(path, "rb") as f:
        n_v = n_f = 0
        props = 0
        binary = True
        while True:
            line = f.readline().decode().strip()
            if line.startswith("format ascii"):
                binary = False
            elif line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line.startswith("property float") or \
                    line.startswith("property uchar"):
                if n_f == 0:
                    props += 1
            elif line == "end_header":
                break
        if binary:
            fmt = [("xyz", "<f4", 3)]
            extra = props - 3
            if extra > 0:
                fmt.append(("extra", "u1", extra))  # assume uchar colours
            v = np.frombuffer(f.read(np.dtype(fmt).itemsize * n_v),
                              dtype=np.dtype(fmt))
            verts = v["xyz"].copy()
            faces = np.empty((n_f, 3), np.int64)
            fd = np.frombuffer(f.read((1 + 12) * n_f),
                               dtype=[("n", "u1"), ("idx", "<i4", 3)])
            faces = fd["idx"].astype(np.int64)
        else:
            rows = [f.readline().split() for _ in range(n_v)]
            verts = np.array([[float(x) for x in r[:3]] for r in rows],
                             np.float32)
            rows = [f.readline().split() for _ in range(n_f)]
            faces = np.array([[int(x) for x in r[1:4]] for r in rows],
                             np.int64)
    return verts, faces
