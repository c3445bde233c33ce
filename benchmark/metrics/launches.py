"""launches.<train|serve>: device events (kernels, copies, sets) per step
or view in the traced window without Python stacks."""


def read(ctx: dict):
    n = ctx["plain"]["launches"]
    return n / ctx["units"] if n else None
