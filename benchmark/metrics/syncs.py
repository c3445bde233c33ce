"""syncs.<train|serve>: blocking host calls (benchmark/spans.py
SYNC_CALLS) per step or view inside the top span, `train_step` or
`render_one`; None where the traced window has no such span."""


def read(ctx: dict):
    red = ctx["plain"].get("spans")
    if not red or not red["units"]:
        return None
    return red["in_units"][2] / ctx["units"]
