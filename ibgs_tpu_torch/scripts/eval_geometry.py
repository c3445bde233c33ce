"""Geometry evaluation of the port (counterpart of the JAX package's
scripts/eval_geometry.py): DTU chamfer distance, DTU mask culling and the
TnT-style F-score, self-contained in numpy / scipy, with meshes read and
written by `ibgs_tpu_torch.eval.tsdf` and masks by `utils/image_io`.  No
card is needed.

    python -m ibgs_tpu_torch.scripts.eval_geometry chamfer --mesh mesh.ply \
        --gt gt.ply [--max_dist 20] [--downsample 0.2] \
        [--obsmask_dir <dir> --scan <n>]
    python -m ibgs_tpu_torch.scripts.eval_geometry cull --mesh mesh.ply \
        --instance_dir <scan> --out culled.ply
    python -m ibgs_tpu_torch.scripts.eval_geometry fscore --mesh mesh.ply \
        --gt gt.ply --threshold 0.05 [--align [--traj t --gt_traj g]]
"""
import argparse
import json
import os

import numpy as np
from scipy.spatial import cKDTree

from ibgs_tpu_torch.eval.tsdf import load_mesh_ply, save_mesh_ply


def sample_mesh(verts, faces, n=1_000_000, seed=0):
    """Uniform area-weighted surface sampling."""
    if len(faces) == 0:
        return verts
    rng = np.random.default_rng(seed)
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    probs = area / max(area.sum(), 1e-12)
    fi = rng.choice(len(faces), size=n, p=probs)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return a[fi] + u * (b[fi] - a[fi]) + v * (c[fi] - a[fi])


def voxel_downsample(pts, voxel):
    if voxel <= 0:
        return pts
    key = np.floor(pts / voxel).astype(np.int64)
    _, idx = np.unique(key, axis=0, return_index=True)
    return pts[idx]


def load_points(path):
    """Mesh PLY → sampled points; point-cloud PLY → points."""
    verts, faces = load_mesh_ply(path)
    if len(faces):
        return sample_mesh(verts, faces)
    return verts


def cull_mesh(args):
    """DTU mask culling (reference scripts/eval_dtu/evaluate_single_scene.py
    cull_scan): project mesh vertices into every view, keep those landing on
    a dilated foreground mask in ALL views (points outside a view count as
    kept for that view), then apply the scan's scale_mat and export."""
    from scipy.ndimage import binary_dilation
    from ibgs_tpu_torch.utils.image_io import read_image

    verts, faces = load_mesh_ply(args.mesh)
    cams = np.load(os.path.join(args.instance_dir, "cameras.npz"))
    n_images = len([k for k in cams.files if k.startswith("world_mat_")])
    mask_dir = os.path.join(args.instance_dir, "mask")
    mask_paths = sorted(
        os.path.join(mask_dir, f) for f in os.listdir(mask_dir)
        if f.endswith(".png")) if os.path.isdir(mask_dir) else []

    keep = np.ones(len(verts), bool)
    if args.mask_cull and mask_paths:
        # disk(24) dilation structuring element (unisurf convention)
        r = 24
        yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
        disk = (xx * xx + yy * yy) <= r * r
        hom = np.concatenate([verts, np.ones((len(verts), 1))], -1).T
        for i in range(n_images):
            P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
            # K,R,t from P by RQ decomposition (rend_util.load_K_Rt_from_P)
            K, Rt = _decompose_projection(P)
            cp = K @ Rt @ hom
            u = cp[0] / (cp[2] + 1e-6)
            v = cp[1] / (cp[2] + 1e-6)
            m = read_image(mask_paths[i])
            if m.ndim == 3:
                m = m[..., 0]
            H, W = m.shape
            md = binary_dilation(m.astype(np.float32) / 256.0 > 0, disk)
            inside = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
            ui = np.clip(np.rint(u).astype(np.int64), 0, W - 1)
            vi = np.clip(np.rint(v).astype(np.int64), 0, H - 1)
            keep &= md[vi, ui] | ~inside
        vkeep = keep
        remap = np.cumsum(vkeep) - 1
        fkeep = vkeep[faces].all(1)
        verts = verts[vkeep]
        faces = remap[faces[fkeep]]
    sm = cams["scale_mat_0"]
    verts = verts * sm[0, 0] + sm[:3, 3][None]
    save_mesh_ply(args.out, verts, faces)
    print(json.dumps({"vertices": int(len(verts)),
                      "faces": int(len(faces)), "out": args.out}))


def _decompose_projection(P):
    """P (3,4) → K (3,3), [R|t] (3,4) with K upper-triangular, diag>0
    (rend_util.load_K_Rt_from_P semantics via RQ decomposition)."""
    from scipy.linalg import rq
    K, R = rq(P[:, :3])
    s = np.diag(np.sign(np.diag(K)))
    K, R = K @ s, s @ R
    if np.linalg.det(R) < 0:
        R = -R
    t = np.linalg.inv(K) @ P[:, 3]
    return K / K[2, 2], np.concatenate([R, t[:, None]], -1)


def chamfer(args):
    """DTU-style: mean data→GT and GT→data distances, max_dist culled
    (reference scripts/eval_dtu/eval.py semantics).  With --obsmask_dir and
    --scan, applies the official ObsMask/BB/Res observability culling to the
    data→GT direction and the ground-plane cut to GT→data
    (eval.py:98-133)."""
    data = load_points(args.mesh)
    gt = load_points(args.gt)
    data = voxel_downsample(data, args.downsample)
    gt = voxel_downsample(gt, args.downsample)

    data_in = data
    if args.obsmask_dir and args.scan is not None:
        from scipy.io import loadmat
        om = loadmat(os.path.join(args.obsmask_dir,
                                  f"ObsMask{args.scan}_10.mat"))
        ObsMask, BB, Res = om["ObsMask"], om["BB"].astype(np.float32), \
            om["Res"]
        patch = args.patch_size
        inb = ((data >= BB[:1] - patch)
               & (data < BB[1:] + patch * 2)).all(-1)
        data_in = data[inb]
        grid = np.around((data_in - BB[:1]) / Res).astype(np.int32)
        ginb = ((grid >= 0) & (grid < np.array(ObsMask.shape)[None])).all(-1)
        gi = grid[ginb]
        in_obs = ObsMask[gi[:, 0], gi[:, 1], gi[:, 2]].astype(bool)
        data = data_in[ginb][in_obs]
        plane = loadmat(os.path.join(args.obsmask_dir,
                                     f"Plane{args.scan}.mat"))["P"]
        gt_h = np.concatenate([gt, np.ones_like(gt[:, :1])], -1)
        gt = gt[(plane.reshape(1, 4) * gt_h).sum(-1) > 0]

    # upper-bounded parallel NN queries: distances past max_dist are culled
    # anyway, and the bound keeps far-outlier queries from degenerating
    d2g = cKDTree(gt).query(data, k=1, workers=-1,
                            distance_upper_bound=args.max_dist)[0]
    g2d = cKDTree(data_in).query(gt, k=1, workers=-1,
                                 distance_upper_bound=args.max_dist)[0]
    d2g = d2g[d2g < args.max_dist]
    g2d = g2d[g2d < args.max_dist]
    acc = float(d2g.mean())
    comp = float(g2d.mean())
    out = {"accuracy": acc, "completeness": comp,
           "overall": (acc + comp) / 2}
    print(json.dumps(out, indent=2))
    return out


def _umeyama(src, dst, with_scale=True):
    """Closed-form similarity transform T (4,4) minimising
    ||dst − (s·R·src + t)||² — the TransformationEstimationPointToPoint
    (with_scaling=True) step of the reference toolbox."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (sc ** 2).sum() / len(src)
    s = float((D * np.diag(S)).sum() / max(var_s, 1e-12)) if with_scale \
        else 1.0
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = mu_d - s * R @ mu_s
    return T


def icp_align(src, dst, threshold, max_iter=50, with_scale=True, init=None):
    """Point-to-point ICP with scale (reference registration_vol_ds /
    registration_unif: o3d registration_icp with
    TransformationEstimationPointToPoint(True), ICPConvergenceCriteria
    1e-6).  Correspondences beyond `threshold` are rejected each sweep."""
    T = np.eye(4) if init is None else init.copy()
    tree = cKDTree(dst)
    prev = np.inf
    for _ in range(max_iter):
        cur = src @ T[:3, :3].T + T[:3, 3]
        d, idx = tree.query(cur, k=1, workers=-1,
                            distance_upper_bound=threshold)
        m = np.isfinite(d)
        if m.sum() < 10:
            break
        T = _umeyama(cur[m], dst[idx[m]], with_scale) @ T
        rmse = float(np.sqrt((d[m] ** 2).mean()))
        if abs(prev - rmse) <= 1e-6 * max(rmse, 1e-12):
            break
        prev = rmse
    return T


def _pca_inits(src, dst):
    """Coarse global inits when no trajectory is available: centroid +
    RMS-radius scale + principal-axes rotation, over the 4 proper-rotation
    axis-sign combinations (PCA axes have sign ambiguity)."""
    def frame(p):
        c = p.mean(0)
        q = p - c
        _, _, Vt = np.linalg.svd(q[np.random.default_rng(0).choice(
            len(q), size=min(len(q), 20000), replace=False)], full_matrices=False)
        scale = np.sqrt((q ** 2).sum(-1).mean())
        return c, Vt, scale
    cs, Vs, ss = frame(src)
    cd, Vd, sd = frame(dst)
    inits = []
    for sx in (1, -1):
        for sy in (1, -1):
            sg = np.diag([sx, sy, sx * sy])  # det=+1 sign flips
            R = Vd.T @ sg @ Vs
            if np.linalg.det(R) < 0:
                R = Vd.T @ (sg * -1) @ Vs
            s = sd / max(ss, 1e-12)
            T = np.eye(4)
            T[:3, :3] = s * R
            T[:3, 3] = cd - s * R @ cs
            inits.append(T)
    return inits


def align_points(data, gt, threshold, traj=None, gt_traj=None):
    """Reference tnt_eval/run.py:100-107 pipeline: trajectory-based init
    (correspondence Umeyama instead of RANSAC — the correspondences are
    index-matched), then staged ICP at decreasing thresholds
    (dTau → dTau/2 → 2·dTau uniform in the reference; here 4τ → 2τ → τ)."""
    rng = np.random.default_rng(0)
    sub = data[rng.choice(len(data), size=min(len(data), 30_000),
                          replace=False)]
    # alignment only needs a representative target: voxel-downsample GT so
    # the per-sweep KD queries stay cheap
    gt = voxel_downsample(gt, threshold / 2)
    if traj is not None and gt_traj is not None:
        n = min(len(traj), len(gt_traj))
        init = _umeyama(traj[:n], gt_traj[:n], with_scale=True)
        cands = [init]
    else:
        cands = _pca_inits(sub, gt)
    tree = cKDTree(gt)

    def score(T):
        cur = sub @ T[:3, :3].T + T[:3, 3]
        d, _ = tree.query(cur, k=1, workers=-1)
        return float(np.median(d))

    best = min(cands, key=score)
    T = best
    for th in (4 * threshold, 2 * threshold, threshold):
        T = icp_align(sub, gt, th, init=T)
    return T


def _load_traj(path):
    """Camera centres: .npy (N,3), .txt whitespace (N,3), or a TnT .log
    trajectory (5-line blocks: meta + 4x4 pose, centre = pose[:3,3])."""
    if path.endswith(".npy"):
        return np.load(path).reshape(-1, 3)
    if path.endswith(".log"):
        rows = [l.split() for l in open(path) if l.strip()]
        mats = []
        i = 0
        while i < len(rows):
            block = rows[i + 1:i + 5]
            mats.append(np.array(block, np.float64))
            i += 5
        return np.stack(mats)[:, :3, 3]
    return np.loadtxt(path).reshape(-1, 3)


def fscore(args):
    """TnT-style precision/recall/F at threshold τ
    (reference scripts/tnt_eval/evaluation.py).  --align first registers
    the reconstruction to GT with scale-aware ICP (reference
    registration.py), optionally seeded by --traj/--gt_traj camera
    trajectories."""
    data = load_points(args.mesh)
    gt = load_points(args.gt)
    if args.align:
        traj = _load_traj(args.traj) if args.traj else None
        gt_traj = _load_traj(args.gt_traj) if args.gt_traj else None
        T = align_points(data, gt, args.threshold, traj, gt_traj)
        data = data @ T[:3, :3].T + T[:3, 3]
    data = voxel_downsample(data, args.threshold / 2)
    gt = voxel_downsample(gt, args.threshold / 2)
    # only the (d < τ) booleans matter — bounding the query at τ keeps
    # badly misregistered inputs from degenerating the KD search
    d2g = cKDTree(gt).query(data, k=1, workers=-1,
                            distance_upper_bound=args.threshold)[0]
    g2d = cKDTree(data).query(gt, k=1, workers=-1,
                              distance_upper_bound=args.threshold)[0]
    precision = float((d2g < args.threshold).mean())
    recall = float((g2d < args.threshold).mean())
    f = 2 * precision * recall / max(precision + recall, 1e-12)
    out = {"precision": precision, "recall": recall, "fscore": f,
           "threshold": args.threshold}
    print(json.dumps(out, indent=2))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("chamfer")
    c.add_argument("--mesh", required=True)
    c.add_argument("--gt", required=True)
    c.add_argument("--max_dist", type=float, default=20.0)
    c.add_argument("--downsample", type=float, default=0.2)
    c.add_argument("--obsmask_dir", type=str, default=None,
                   help="DTU ObsMask dir (ObsMask{scan}_10.mat, "
                        "Plane{scan}.mat)")
    c.add_argument("--scan", type=int, default=None)
    c.add_argument("--patch_size", type=float, default=60.0)
    cu = sub.add_parser("cull")
    cu.add_argument("--mesh", required=True)
    cu.add_argument("--instance_dir", required=True,
                    help="dir with cameras.npz and mask/*.png")
    cu.add_argument("--out", required=True)
    cu.add_argument("--mask_cull", action="store_true", default=True)
    f = sub.add_parser("fscore")
    f.add_argument("--mesh", required=True)
    f.add_argument("--gt", required=True)
    f.add_argument("--threshold", type=float, default=0.05)
    f.add_argument("--align", action="store_true",
                   help="register the mesh to GT first (scale-aware ICP, "
                        "reference tnt_eval/registration.py)")
    f.add_argument("--traj", type=str, default=None,
                   help="reconstruction camera centres (.npy/.txt/.log) "
                        "for correspondence-seeded alignment")
    f.add_argument("--gt_traj", type=str, default=None)
    args = p.parse_args(argv)
    if args.cmd == "chamfer":
        return chamfer(args)
    if args.cmd == "cull":
        return cull_mesh(args)
    return fscore(args)


if __name__ == "__main__":
    main()
