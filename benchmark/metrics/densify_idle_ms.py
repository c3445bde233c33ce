"""densify_idle_ms.train: the card's idle ms per densify event while a
frame of `train/maintenance.py` was open on the host's main thread (the
event's syncs, and the host issuing its clone, split, prune and growths
while the card waited), read from the traced window with Python stacks
as drivers/densify.py records it (`maintenance_idle_s` over `events`);
None where no event was recorded, as in a program without the module."""


def read(ctx: dict):
    n, s = ctx.get("events"), ctx.get("maintenance_idle_s")
    return 1e3 * s / n if n and s is not None else None
