"""Configuration (counterpart of ibgs_tpu/config.py).

Dataclass-backed parameter groups exposed reflectively as argparse flags:
every field becomes --<name>; the parsed arguments are saved to
<model_path>/cfg_args.json and re-merged with CLI flags at eval time
(`load_combined`).  Defaults are the JAX package's, with two exceptions:

* `PipelineParams` has no `backend` field: the port has one route (the
  CUDA kernels on the card, their plain versions on the CPU);
* `PipelineParams.instance_cap` and `row_cap` default to 0, which sizes
  the instance and row lists exactly (`ops/rasterize.RasterConfig`).  A
  cap the user sets keeps the JAX package's prefix-truncation semantics,
  and the training loop grows it when a step overflows it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List


@dataclass
class ModelParams:
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    sh_degree: int = 2
    multi_view_num: int = 8
    multi_view_max_angle: float = 30.0
    multi_view_min_dis: float = 0.01
    multi_view_max_dis: float = 1.5
    # slot capacity at init (0 = 4x the seed points, rounded up to a power
    # of two, at least 4096); the training loop doubles it on demand
    init_capacity: int = 0


@dataclass
class PipelineParams:
    # 0 = exact-size instance list (no cap)
    instance_cap: int = 0
    # staircase-interval binning (RasterConfig.staircase_cull); output-
    # preserving, default on as in the JAX package.  row_cap = 0 →
    # instance_cap // 2, no cap when both are 0.
    staircase_cull: bool = True
    row_cap: int = 0
    # per-step non-finite check; dumps the step's inputs and raises
    debug: bool = False
    # torch.profiler capture window (Chrome trace); off when
    # profile_num_steps == 0.  The trace lands in <model_path>/trace
    # unless profile_dir is set.
    profile_from_iter: int = 100
    profile_num_steps: int = 0
    profile_dir: str = ""


@dataclass
class OptimizationParams:
    iterations: int = 30_000
    # learning rates (per-group Adam)
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.025
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    normal_lr: float = 0.001
    # densification
    percent_dense: float = 0.001
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    densify_abs_grad_threshold: float = 0.0008
    abs_split_radii2D_threshold: float = 20.0
    max_abs_split_points: int = 50_000
    max_all_points: int = 5_000_000
    opacity_cull_threshold: float = 0.05
    opacity_decay: float = 1.0
    opacity_decay_interval: int = 50
    # loss terms
    lambda_dssim: float = 0.2
    single_view_weight: float = 0.03
    single_view_weight_from_iter: int = 7000
    multi_view_weight_from_iter: int = 7000
    photo_ssim_weight: float = 1.0
    photo_weight: float = 0.3
    # schedule
    exposure_compensation: bool = False
    random_background: bool = False
    use_color_aggregation: bool = True
    start_color_aggregation_iter: int = 10_000
    color_aggregate_burnin_steps: int = 3000
    color_aggregation_reduce_lr_iter: List[int] = field(
        default_factory=lambda: [18_000, 25_000])
    shuffle_source_frame: bool = False
    # rendering and fusion
    learnt_normal: bool = True
    buffer_length: int = 4
    depth_error_threshold: float = 0.01
    enable_exposure_correction: bool = False
    number_src_frames: int = 4
    nb_visible_src_frames: int = 3
    residual_resolution_scale: float = 1.0
    feat_aggregate_mode: str = "mean"
    enable_mix_precision: bool = True


def add_group(parser: argparse.ArgumentParser, dc_cls, shorthand=()):
    g = parser.add_argument_group(dc_cls.__name__)
    for f in dataclasses.fields(dc_cls):
        flags = [f"--{f.name}"]
        if f.name in shorthand:
            flags.append(f"-{f.name[0]}")
        if f.type in ("bool", bool):
            g.add_argument(*flags, action="store_true", default=f.default)
        elif f.type in ("List[int]",):
            g.add_argument(*flags, nargs="+", type=int,
                           default=f.default_factory())
        else:
            typ = {int: int, float: float, str: str,
                   "int": int, "float": float, "str": str}[f.type]
            g.add_argument(*flags, type=typ, default=f.default)
    return g


def extract(args, dc_cls):
    names = {f.name for f in dataclasses.fields(dc_cls)}
    return dc_cls(**{k: v for k, v in vars(args).items() if k in names})


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    add_group(p, ModelParams, shorthand=("source_path", "model_path",
                                         "resolution", "white_background",
                                         "images"))
    add_group(p, OptimizationParams)
    add_group(p, PipelineParams)
    return p


def save_config(args, model_path: str):
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(vars(args), f, indent=2, default=str)


def load_combined(parser: argparse.ArgumentParser, argv=None):
    """Merge the saved training config with CLI flags: a flag given on the
    command line (differing from its default) wins over the saved value."""
    args = parser.parse_args(argv)
    cfg_path = os.path.join(args.model_path, "cfg_args.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            merged = dict(json.load(f))
        defaults = {a.dest: parser.get_default(a.dest)
                    for g in parser._action_groups for a in g._group_actions}
        for k, v in vars(args).items():
            if k not in merged or v != defaults.get(k):
                merged[k] = v
        args = argparse.Namespace(**merged)
    return args
