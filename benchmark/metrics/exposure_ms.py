"""exposure_ms.train: device ms per step of the launches made while
`models/exposure.py` was open on the launching thread (the exposure
correction's fit, solve and apply, forward; its backward runs on the
autograd thread, which has no frames of its own), read from the traced
window with Python stacks; None where that file launched nothing, as in
a program without the module."""
FILE = "models/exposure.py"


def read(ctx: dict):
    s = sum(sec for files, sec in ctx["stacked"]["stacks"] if FILE in files)
    return 1e3 * s / ctx["units"] if s > 0 else None
