"""The control's lower precision.

Inside `lowered(dtype)` the reference rounds its float tensors to `dtype`
at each layer boundary: the Gaussians' activated parameters entering the
render, the instance table, the blend's float outputs, the warp's sums and
the median, the fusion net's residual and the losses' maps.  The
arithmetic between two boundaries stays float32; gradients flowing back
through a boundary are rounded the same way (the casts' own backward).
Outside it `q` is the identity.
"""
from __future__ import annotations

import contextlib

import torch

_LOW = []


def q(x):
    """x rounded to the active lower precision (identity outside
    `lowered`)."""
    if not _LOW or not torch.is_tensor(x) or not x.is_floating_point():
        return x
    return x.to(_LOW[-1]).to(x.dtype)


@contextlib.contextmanager
def lowered(dtype=torch.bfloat16):
    _LOW.append(dtype)
    try:
        yield
    finally:
        _LOW.pop()
