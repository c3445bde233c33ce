"""Gaussian scene model, serving subset (counterpart of
ibgs_tpu/models/gaussians.py: parameters, activations and plane normals).

The state keeps the JAX package's fixed-capacity layout: arrays of length
P plus an `alive` mask.  Adam, learning-rate schedules, densification and
point-cloud initialisation belong to the training slice.
"""
from __future__ import annotations

import dataclasses

import torch

from ibgs_tpu_torch.core import transforms as tf


@dataclasses.dataclass
class GaussianParams:
    xyz: torch.Tensor            # (P, 3)
    sh_dc: torch.Tensor          # (P, 1, 3)
    sh_rest: torch.Tensor        # (P, K-1, 3)
    log_scale: torch.Tensor      # (P, 3)
    quat: torch.Tensor           # (P, 4) unnormalised
    opacity_logit: torch.Tensor  # (P, 1)
    normal: torch.Tensor         # (P, 3) learnable plane normal
    offset: torch.Tensor         # (P, 1) learnable plane offset


@dataclasses.dataclass
class GaussianModel:
    params: GaussianParams
    alive: torch.Tensor          # (P,) bool
    active_sh_degree: int
    max_sh_degree: int

    # ---- activations -----------------------------------------------------
    @property
    def scale(self) -> torch.Tensor:
        return torch.exp(self.params.log_scale)

    @property
    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity_logit[:, 0])

    @property
    def quat_unit(self) -> torch.Tensor:
        # eps keeps dead (zero-padded) slots NaN-free
        return tf.normalize(self.params.quat, eps=1e-12)

    @property
    def sh_coeffs(self) -> torch.Tensor:
        return torch.cat([self.params.sh_dc, self.params.sh_rest], dim=1)

    def smallest_axis(self) -> torch.Tensor:
        """Principal axis with the smallest scale."""
        R = tf.quat_to_rotmat(self.quat_unit)
        idx = torch.argmin(self.params.log_scale, dim=-1)
        return torch.take_along_dim(
            R, idx[:, None, None].expand(-1, 3, 1), dim=2)[..., 0]

    def oriented_normal(self, cam_pos: torch.Tensor, learnt: bool = True):
        """Camera-facing plane normal and signed plane offset."""
        if learnt:
            n = tf.normalize(self.params.normal, eps=1e-12)
            off = self.params.offset[:, 0]
        else:
            n = self.smallest_axis()
            off = torch.zeros_like(self.params.offset[:, 0])
        to_cam = cam_pos - self.params.xyz
        flip = torch.where((n * to_cam).sum(-1) < 0.0, -1.0, 1.0)
        return n * flip[:, None], off * flip
