"""densify_ms.train: device ms per densify event of the launches made
while `train/maintenance.py` was open on the launching thread (the
event's clone, split and prune, its growths and the counts' transfer),
read from the traced window with Python stacks over the events that
window held (`events`, as drivers/densify.py records it); None where that
file launched nothing or no event was recorded, as in a program without
the module."""
FILE = "train/maintenance.py"


def read(ctx: dict):
    n = ctx.get("events")
    s = sum(sec for files, sec in ctx["stacked"]["stacks"] if FILE in files)
    return 1e3 * s / n if n and s > 0 else None
