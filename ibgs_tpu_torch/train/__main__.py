"""Training CLI of the port (the counterpart of the root train.py).

    python -m ibgs_tpu_torch.train -s <scene_dir> -m <model_dir> [-r 2 ...]
    python -m ibgs_tpu_torch.train --synthetic \\
        --synthetic_spec 4 32 32 300 150 --iterations 3 --device cpu \\
        -m <model_dir>
    torchrun --nproc_per_node D*N -m ibgs_tpu_torch.train \\
        --gsp_shards N --dp D -s <scene_dir> -m <model_dir>

Every field of the config groups is a flag (ibgs_tpu_torch/config.py).
The run goes to the card unless `--device cpu` is given.  With
`--gsp_shards N` it trains Gaussian-sharded on a (D, N) mesh, one process
per rank (NCCL on cards, gloo with `--device cpu`); the process group
comes from torchrun's environment or COORDINATOR_ADDRESS /
NUM_PROCESSES / PROCESS_ID (parallel/distributed.py), and a 1 x 1 mesh
needs neither.
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
    parser.add_argument("--gsp_shards", type=int, default=0,
                        help="train Gaussian-sharded on a (dp, N) mesh, "
                             "one process per rank")
    parser.add_argument("--dp", type=int, default=1,
                        help="cameras per step on the mesh's dp dim "
                             "(with --gsp_shards; dp*N processes)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    mp = C.extract(args, C.ModelParams)
    opt = C.extract(args, C.OptimizationParams)
    pipe = C.extract(args, C.PipelineParams)
    mesh = None
    if args.gsp_shards:
        # before the scene loads, as in the JAX package
        from ibgs_tpu_torch.parallel import distributed
        distributed.initialize(device=args.device)
        mesh = distributed.global_mesh(args.dp, args.gsp_shards,
                                       ("dp", "gs"), args.device)
        print(f"GSP mesh: {args.dp} x {args.gsp_shards} devices across "
              f"{distributed.world_size()} process(es)")
        if distributed.world_size() > 1 and not mp.model_path:
            raise ValueError("a multi-process run needs -m: each process "
                             "would draw its own output directory")
    if not mp.model_path:
        mp.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
    args.model_path = mp.model_path
    if mesh is None or distributed.rank() == 0:
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
          viewer_port=args.port, device=args.device, mesh=mesh)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    print("\nTraining complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
