"""The training options the reference reads: a frozen copy of the
port's `OptimizationParams` defaults."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


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
