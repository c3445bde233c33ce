"""The 1M production deployment with its density control: the scene,
seed state and 1,310,720 slots of `prod-1m`, made by prod-1m.py's own
`build` from the same numbers, so the same seed gives the same scene.
What this configuration adds is its `options`: the fields of
`OptimizationParams` that govern clone, split, prune, the opacity reset
and the pool's growth, as the 1M run sets them.
"""
from __future__ import annotations

from benchmark import harness

PROD = harness.load_module(harness.HERE / "configs" / "prod-1m.py")


def build(cfg: dict, traffic: dict, seed: int, device):
    return PROD.build(cfg, traffic, seed, device)
