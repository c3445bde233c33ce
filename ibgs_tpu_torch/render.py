"""Evaluation rendering CLI of the port (counterpart of the root
render.py: the same flags, output tree and JSON keys).

    python -m ibgs_tpu_torch.render -m <model_dir> [-s <scene>] \\
        [--skip_train] [--skip_test] [--render_geo] [--synthetic] \\
        [--device cuda]

For the newest (or `--iteration`) `point_cloud/iteration_N/point_cloud.ply`
of a model directory trained by either package, with the fusion net of
its newest `chkpnt*.npz` (a port or a JAX checkpoint), it writes:

    test_time_data/ours_N/{images/*.jpg, test_intrinsic.npy,
                           test_extrinsic.npy}
    test/ours_N/{renders, renders_aggregate, gt, depth, normal}/*.png
    train/ours_N/{renders, renders_aggregate, gt, depth, normal}/*.png
    mesh.ply                          (--render_geo)
    result_fps_mem.json               (FPS, fps, n_gaussians,
                                       num_gaussians, model_mb, memory)

The saved training config (`cfg_args.json`) is merged with the command
line as in the root CLI; `--device` is taken from the command line only
(default cuda).  The test-time source dump is JPEG unless
`--src_image_ext png`; JPEG needs PIL or cv2.
"""
from __future__ import annotations

import json
import os
import sys
import zipfile

import numpy as np
import torch

from ibgs_tpu_torch import config as C


def build_parser():
    parser = C.build_parser("ibgs_tpu_torch rendering")
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--render_geo", action="store_true",
                        help="TSDF-fuse depths and extract a mesh")
    parser.add_argument("--voxel_size", type=float, default=0.01)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic_spec", nargs=5, type=int,
                        default=[12, 64, 64, 1200, 400],
                        metavar=("VIEWS", "W", "H", "N_GT", "N_SEED"))
    parser.add_argument("--measure_fps", action="store_true", default=True)
    parser.add_argument("--use_depth_filter", action="store_true",
                        help="zero grazing-angle depths before TSDF fusion")
    parser.add_argument("--src_image_ext", type=str, default="jpg")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (default cuda)")
    return parser


def model_from_ply(path: str, sh_degree: int, device="cuda"):
    """(model, n): the PLY's n Gaussians in a model of capacity the next
    power of two (at least 8), dead slots zero, at SH degree
    `sh_degree`."""
    from ibgs_tpu_torch.data.ply import load_gaussian_ply
    from ibgs_tpu_torch.models.gaussians import (PARAM_FIELDS, GaussianModel,
                                                 GaussianParams)
    from ibgs_tpu_torch.core import sh as shlib

    d = load_gaussian_ply(path)
    n = d["xyz"].shape[0]
    cap = 1 << int(np.ceil(np.log2(max(n, 8))))
    widths = dict(xyz=(3,), sh_dc=(1, 3),
                  sh_rest=(shlib.num_coeffs(sh_degree) - 1, 3),
                  log_scale=(3,), quat=(4,), opacity_logit=(1,),
                  normal=(3,), offset=(1,))

    def fill(k):
        out = np.zeros((cap,) + widths[k], np.float32)
        out[:n] = d[k].reshape(out[:n].shape)
        return torch.as_tensor(out).to(device)

    return GaussianModel(
        params=GaussianParams(**{k: fill(k) for k in PARAM_FIELDS}),
        alive=torch.arange(cap, device=device) < n,
        active_sh_degree=sh_degree, max_sh_degree=sh_degree), n


def _last_checkpoint(model_path: str):
    ckpts = [f for f in os.listdir(model_path) if f.startswith("chkpnt")]
    if not ckpts:
        return None
    return sorted(ckpts, key=lambda s: int(s[6:-4]))[-1]


def restore_net(model, opt, model_path: str, device="cuda"):
    """The fusion net of the newest checkpoint (port or JAX format), or
    None without colour aggregation, without a checkpoint, or (with a
    warning) when the checkpoint holds no net that loads."""
    from ibgs_tpu_torch.models.aggregation import ColorFusionResidualNet
    from ibgs_tpu_torch.train import checkpoint as ckpt
    from ibgs_tpu_torch.train.trainer import (APP_CAPACITY, SideOptState,
                                              TrainState)

    last = _last_checkpoint(model_path)
    if not opt.use_color_aggregation or last is None:
        return None, None
    app = torch.zeros(APP_CAPACITY, 2, device=device)
    template = TrainState(
        model=model, app_ab=app, app_opt=SideOptState.init([app]),
        net=ColorFusionResidualNet(32, opt.feat_aggregate_mode),
        net_opt=None, spatial_lr_scale=1.0)
    try:
        st, _ = ckpt.load_state(template, os.path.join(model_path, last))
    except (KeyError, ValueError, RuntimeError, OSError,
            zipfile.BadZipFile) as e:
        print(f"[warn] could not restore net from {last}: {e}")
        return None, None
    return st.net, last


def render_model(scene, mp, opt, pipe, model_path: str, iteration: int = -1,
                 skip_train=False, skip_test=False, render_geo=False,
                 voxel_size=0.01, measure_fps=True, use_depth_filter=False,
                 src_image_ext="jpg", device="cuda") -> dict:
    """Everything the CLI does after building `scene` (its cameras on
    `device`): returns and writes result_fps_mem.json's dict."""
    from ibgs_tpu_torch.eval.render_driver import (EvalRenderer,
                                                   dump_test_time_data,
                                                   extract_tsdf_mesh,
                                                   folder_size_mb,
                                                   render_split)
    from ibgs_tpu_torch.ops.rasterize import RasterConfig

    dev = torch.device(device)
    pc_root = os.path.join(model_path, "point_cloud")
    it = iteration
    if it == -1:
        it = max(int(d.split("_")[-1]) for d in os.listdir(pc_root))
    pc_dir = os.path.join(pc_root, f"iteration_{it}")
    model, n = model_from_ply(os.path.join(pc_dir, "point_cloud.ply"),
                              mp.sh_degree, dev)
    net, ckpt_name = restore_net(model, opt, model_path, dev)
    rcfg = RasterConfig(instance_cap=pipe.instance_cap,
                        buffer_len=opt.buffer_length,
                        depth_error_threshold=opt.depth_error_threshold,
                        staircase_cull=pipe.staircase_cull,
                        row_cap=pipe.row_cap)
    ev = EvalRenderer.from_scene(model, net, scene, opt, rcfg, dev)

    results = {}
    misc_path = None
    if not skip_test and scene.test_cameras:
        # store and reload the lossy source data first, as a deployment
        # would hold it
        misc_path = dump_test_time_data(ev, model_path, it,
                                        ext=src_image_ext)
        fps = render_split(
            ev, scene.test_cameras,
            [scene.test_images[k] for k in range(len(scene.test_cameras))],
            scene.test_nearest_ids,
            os.path.join(model_path, "test", f"ours_{it}"),
            measure_fps=measure_fps)
        results["FPS"] = results["fps"] = fps
    if not skip_train:
        render_split(
            ev, scene.train_cameras,
            [scene.images[k] for k in range(scene.n_train)],
            scene.nearest_ids,
            os.path.join(model_path, "train", f"ours_{it}"))
    if render_geo:
        mesh_path = os.path.join(model_path, "mesh.ply")
        extract_tsdf_mesh(ev, mesh_path, voxel_size=voxel_size,
                          use_depth_filter=use_depth_filter)
        print("mesh written to", mesh_path)

    results["n_gaussians"] = results["num_gaussians"] = n
    results["model_mb"] = folder_size_mb(pc_dir)
    # the deployment: stored source data, the PLY and the net's checkpoint
    total_mb = results["model_mb"]
    if misc_path is not None:
        total_mb += folder_size_mb(misc_path)
    if net is not None:
        total_mb += os.path.getsize(os.path.join(model_path, ckpt_name)) / 1e6
    results["memory"] = total_mb
    with open(os.path.join(model_path, "result_fps_mem.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


def main(argv=None):
    parser = build_parser()
    device = parser.parse_args(argv).device
    args = C.load_combined(parser, argv)
    mp = C.extract(args, C.ModelParams)
    opt = C.extract(args, C.OptimizationParams)
    pipe = C.extract(args, C.PipelineParams)

    if args.synthetic:
        from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
        v, w, h, ngt, nseed = args.synthetic_spec
        scene = make_synthetic_scene(n_views=v, width=w, height=h,
                                     n_gt=ngt, n_seed=nseed,
                                     eval_every=max(v // 2, 2),
                                     device=device)
    else:
        from ibgs_tpu_torch.data.dataset import load_scene
        scene = load_scene(
            mp.source_path, images_dir=mp.images, resolution=mp.resolution,
            eval_split=mp.eval, white_background=mp.white_background,
            multi_view_num=mp.multi_view_num,
            multi_view_max_angle=mp.multi_view_max_angle,
            multi_view_min_dis=mp.multi_view_min_dis,
            multi_view_max_dis=mp.multi_view_max_dis,
            exposure_reorder=opt.enable_exposure_correction, device=device)
    render_model(scene, mp, opt, pipe, mp.model_path, args.iteration,
                 skip_train=args.skip_train, skip_test=args.skip_test,
                 render_geo=args.render_geo, voxel_size=args.voxel_size,
                 measure_fps=args.measure_fps,
                 use_depth_filter=args.use_depth_filter,
                 src_image_ext=args.src_image_ext, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
