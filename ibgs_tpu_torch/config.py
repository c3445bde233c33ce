"""Configuration fields that serving reads (counterpart of the matching
fields of ibgs_tpu/config.py, with the same defaults)."""
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
    learnt_normal: bool = True
    buffer_length: int = 4
    depth_error_threshold: float = 0.01
    enable_exposure_correction: bool = False
    number_src_frames: int = 4
    nb_visible_src_frames: int = 3
    residual_resolution_scale: float = 1.0
    feat_aggregate_mode: str = "mean"
    enable_mix_precision: bool = True
