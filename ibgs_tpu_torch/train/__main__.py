"""Training CLI of the port (the counterpart of the root train.py, without
the Gaussian-sharded mesh).

    python -m ibgs_tpu_torch.train -s <scene_dir> -m <model_dir> [-r 2 ...]
    python -m ibgs_tpu_torch.train --synthetic \\
        --synthetic_spec 4 32 32 300 150 --iterations 3 --device cpu \\
        -m <model_dir>

Every field of the config groups is a flag (ibgs_tpu_torch/config.py).
The run goes to the card unless `--device cpu` is given.
"""
from __future__ import annotations

import os
import sys
import uuid

from ibgs_tpu_torch import config as C


def build_parser():
    parser = C.build_parser("ibgs_tpu_torch training")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 15_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--port", type=int, default=None,
                        help="serve the SIBR network viewer on this port")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on the built-in synthetic scene")
    parser.add_argument("--synthetic_spec", nargs=5, type=int,
                        default=[12, 64, 64, 1200, 400],
                        metavar=("VIEWS", "W", "H", "N_GT", "N_SEED"),
                        help="synthetic scene shape (with --synthetic)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (default cuda)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    mp = C.extract(args, C.ModelParams)
    opt = C.extract(args, C.OptimizationParams)
    pipe = C.extract(args, C.PipelineParams)
    if not mp.model_path:
        mp.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
    args.model_path = mp.model_path
    C.save_config(args, mp.model_path)

    if args.synthetic:
        from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
        v, w, h, ngt, nseed = args.synthetic_spec
        scene = make_synthetic_scene(n_views=v, width=w, height=h,
                                     n_gt=ngt, n_seed=nseed,
                                     eval_every=max(v // 2, 2),
                                     device=args.device)
    else:
        from ibgs_tpu_torch.data.dataset import load_scene
        scene = load_scene(
            mp.source_path, images_dir=mp.images, resolution=mp.resolution,
            eval_split=mp.eval, white_background=mp.white_background,
            multi_view_num=mp.multi_view_num,
            multi_view_max_angle=mp.multi_view_max_angle,
            multi_view_min_dis=mp.multi_view_min_dis,
            multi_view_max_dis=mp.multi_view_max_dis,
            exposure_reorder=opt.enable_exposure_correction,
            device=args.device)
    print(f"scene: {scene.n_train} train / {len(scene.test_cameras)} test "
          f"cams, {scene.images.shape[1:3]} px, "
          f"{len(scene.points)} seed points, extent {scene.cameras_extent:.2f}")

    from ibgs_tpu_torch.train.loop import train
    if opt.iterations not in args.save_iterations:
        args.save_iterations.append(opt.iterations)
    train(scene, mp, opt, pipe, mp.model_path,
          save_iterations=tuple(args.save_iterations),
          test_iterations=tuple(args.test_iterations),
          checkpoint_iterations=tuple(args.checkpoint_iterations),
          start_checkpoint=args.start_checkpoint, quiet=args.quiet,
          viewer_port=args.port, device=args.device)
    print("\nTraining complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
