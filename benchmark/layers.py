"""The layers the per-layer metrics read, by the port's module file, and
the share of a layer's bound in their device time.  A launch is charged
to the outermost of these files open on the launching thread's stack: the
hand kernels launch from `ops/_cuda.py` inside their layer's frames, and
one layer calls helpers of another (binning and the epilogue call
`preprocess.to_i32`), which stay with the caller."""
from __future__ import annotations

from benchmark import peaks

FILES = {"preprocess": "ops/preprocess.py", "binning": "ops/binning.py",
         "blend": "ops/blend.py", "warp": "ops/epilogue.py"}


def device_s(ctx: dict, layer: str):
    """The device seconds per step or view charged to the layer's module
    file, or None where the traced window charged it nothing."""
    want = FILES[layer]
    known = set(FILES.values())
    s = 0.0
    for files, sec in ctx["stacked"]["stacks"]:
        outer = next((f for f in files if f in known), None)
        if outer == want:
            s += sec
    return s / ctx["units"] if s > 0 else None


def roofline_share(ctx: dict, layer: str):
    """100 x the bound of rooflines/<layer>.py over the layer's device
    time, or None."""
    t = device_s(ctx, layer)
    work = ctx["work"].get(layer)
    if t is None or not work:
        return None
    return 100.0 * peaks.bound_s(work) / t
