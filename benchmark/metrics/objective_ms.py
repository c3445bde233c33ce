"""objective_ms.train: device ms per step charged to the
`objective` span itself (`trainer.ibgs_objective`: SSIM, L1, normal,
photometric and aggregation losses; the `net` inside it excluded), its
forward and its `.bwd` half (benchmark/spans.py)."""
from benchmark import spans


def read(ctx: dict):
    return spans.per_unit(ctx, ("objective", "objective.bwd"), 0, 1e3)
