"""Configuration fields that serving and the training step read
(counterpart of the matching fields of ibgs_tpu/config.py, with the same
defaults)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PipelineParams:
    # staircase-interval binning (RasterConfig.staircase_cull); output-
    # preserving, default on as in the JAX package.  row_cap = 0 → no cap.
    staircase_cull: bool = True
    row_cap: int = 0


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
