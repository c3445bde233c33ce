"""optimizer_ms.train: device ms per step under the `optimizer`
span (Adam on the Gaussians, the densification statistics, the side Adam
of the exposure table and the net; benchmark/spans.py)."""
from benchmark import spans


def read(ctx: dict):
    return spans.per_unit(ctx, ("optimizer",), 0, 1e3)
