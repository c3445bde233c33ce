"""mfu.<train|serve>: the whole step's or view's share of the card's peak,
in %: the counted ops of every layer in rooflines/ (projection, blend,
warp at the float32 peak; the fusion net at the bf16 peak, as it runs
under autocast) over the untraced time per step or view of the traced
run."""
from benchmark import peaks


def read(ctx: dict):
    t = sum(peaks.ops_s(w) for w in ctx["work"].values())
    if t <= 0 or ctx["wall_s"] <= 0:
        return None
    return 100.0 * t / ctx["wall_s"]
