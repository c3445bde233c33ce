"""Shared definitions for the blend stage (plain version and CUDA kernel)."""
from __future__ import annotations

import dataclasses

import torch

ALPHA_CLAMP = 0.99           # max per-splat alpha
ALPHA_MIN = 1.0 / 255.0      # contribution cutoff
T_STOP = 1.0e-4              # transmittance early-stop
PLANE_EPS = 1.0e-8           # ray·normal denominator epsilon
MAX_BUFFER = 8               # compiled max median-buffer length


@dataclasses.dataclass(frozen=True)
class BlendConfig:
    """Static configuration of the blend stage."""
    tile_h: int = 8
    tile_w: int = 16
    buffer_len: int = 4
    render_geo: bool = True
    depth_only: bool = False

    @property
    def before_cap(self) -> int:
        # circular "above the median" sub-buffer capacity
        return (self.buffer_len + 1) // 2

    @property
    def below_cap(self) -> int:
        return self.buffer_len - self.before_cap


@dataclasses.dataclass
class BlendOutputs:
    """Per-pixel blend results. H, W are the padded tile-aligned dims."""
    color: torch.Tensor        # (H, W, 3) alpha-composited splat color (no bg)
    normal: torch.Tensor       # (H, W, 3) alpha-composited plane normals
    final_t: torch.Tensor      # (H, W) remaining transmittance
    n_contrib: torch.Tensor    # (H, W) int32 1-based index of last contributor
    buf_depth: torch.Tensor    # (H, W, B) median-buffer plane depths
    buf_weight: torch.Tensor   # (H, W, B) median-buffer blend weights (αT)
    buf_contrib: torch.Tensor  # (H, W, B) int32 1-based contributor positions

    def crop(self, H: int, W: int) -> "BlendOutputs":
        return BlendOutputs(*(getattr(self, f.name)[:H, :W]
                              for f in dataclasses.fields(self)))
