"""net_ms.<train|serve>: device ms per step or view under the `net` span
(`models/aggregation.fuse_color`: the fusion net and the exposure
affine), its forward and its `.bwd` half (benchmark/spans.py)."""
from benchmark import spans


def read(ctx: dict):
    return spans.per_unit(ctx, ("net", "net.bwd"), 0, 1e3)
