"""idle_share.<train|serve>: the share of the traced window (no Python
stacks recorded) in which no kernel, copy or set ran on the card, in %."""


def read(ctx: dict):
    p = ctx["plain"]
    if p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
