"""objective_idle_ms.train: card idle ms per step put down to the
`objective` span and its `.bwd` half: the host issuing the loss stack or
its backward while the card waited (benchmark/spans.py)."""
from benchmark import spans


def read(ctx: dict):
    return spans.per_unit(ctx, ("objective", "objective.bwd"), 1, 1e3)
