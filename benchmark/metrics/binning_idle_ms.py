"""binning_idle_ms.<train|serve>: card idle ms per step or view put down
to the `binning` span and its `.bwd` half (`ops/binning.bin_splats` and
`pack_rows`: the host's depth order, staircase, `_expand`'s syncs and
tile ranges; benchmark/spans.py)."""
from benchmark import spans


def read(ctx: dict):
    return spans.per_unit(ctx, ("binning", "binning.bwd"), 1, 1e3)
