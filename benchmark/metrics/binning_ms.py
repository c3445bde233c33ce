"""binning_ms.<train|serve>: device ms per step or view charged to
`ops/binning.py` (binning and instance assembly, its backward included);
it has no hand kernel, so no roofline yet."""
from benchmark import layers


def read(ctx: dict):
    s = layers.device_s(ctx, "binning")
    return None if s is None else 1e3 * s
