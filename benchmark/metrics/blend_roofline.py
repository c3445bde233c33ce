"""blend_roofline.<train|serve>: the bound of rooflines/blend.py over the
device time charged to the layer's module file (benchmark/layers.py), per
step or view, in %."""
from benchmark import layers


def read(ctx: dict):
    return layers.roofline_share(ctx, "blend")
