"""The optimizer's pass as one hand-written CUDA kernel (csrc/optim.cu).

A train step's Adam updates (the Gaussians' eight fields with the alive
mask, the exposure table, the fusion net), its densification statistics
and its count of non-finite gradients are segments of one `OptimPass`.
On CUDA tensors the pass checks each segment, allocates its outputs and
records it; `run` then launches the kernel once over all of them (at most
36 Adam and count segments: a step has 31) through `_cuda`, with no host
sync and no copy to the device.  Inputs may be row-strided views (the SH
gradient's DC and rest terms are slices of one tensor); outputs are
contiguous.  On CPU tensors every segment is the plain chain at once
(`adam_plain`, `stats_plain`, `nonfinite_plain`: the steps as the JAX
package writes them) and `run` does nothing.  Every output of the kernel
is the plain chain's on the card bit for bit (the note in csrc/optim.cu),
and the count is exact.  There is no fallback: a CUDA tensor the kernel
does not take raises.

`models.gaussians.adam_step`, `accumulate_stats` and
`train.trainer.side_adam` add their segments to a pass handed to them, or
run one of their own; `trainer.apply_grads`, a train step's optimizer,
gathers all of the step's into one.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ibgs_tpu_torch.ops import _cuda

# segment flags (csrc/optim.cu)
_ADAM, _COUNT, _COUNT_ABS = 1, 2, 4
_MAX_N = 2 ** 31 - 1


def adam_plain(p, m, v, g, lr, bc1, bc2, b1, b2, eps, alive=None):
    """One Adam update of p with moments m, v and gradient g: (p', m',
    v').  bc1, bc2 are the bias corrections 1 - b^step; where `alive` (a
    (P,) bool mask of p's leading axis) is given, the gradients of dead
    slots are zeroed first (their reverse-mode values can be 0·nan).
    Returns new tensors and leaves the inputs as they are."""
    if alive is not None:
        g = torch.where(alive.reshape((-1,) + (1,) * (g.dim() - 1)), g, 0.0)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    return p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps), m, v


def stats_plain(stats, screen_grad, screen_grad_abs, radii, width: int,
                height: int):
    """The densification statistics after one view: `stats` = (max_radii2d,
    grad_accum, grad_accum_abs, denom, denom_abs), (P,) each;
    screen_grad[_abs] (P, 2) pixel-unit screen-space gradients, rescaled
    to the NDC convention (x 0.5·W/H) whose thresholds densification
    uses.  Visible Gaussians (radius > 0) accumulate the norms and their
    counts and raise max_radii2d.  Returns the five new tensors."""
    max_radii2d, grad_accum, grad_accum_abs, denom, denom_abs = stats
    vis = radii > 0
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                         device=screen_grad.device)
    sgrad = screen_grad * scale
    sabs = screen_grad_abs * scale
    visf = vis.to(torch.float32)
    return (torch.where(vis, torch.maximum(
                max_radii2d, radii.to(torch.float32)), max_radii2d),
            grad_accum + torch.where(
                vis, torch.linalg.vector_norm(sgrad, dim=-1), 0.0),
            grad_accum_abs + torch.where(
                vis, torch.linalg.vector_norm(sabs, dim=-1), 0.0),
            denom + visf, denom_abs + visf)


def nonfinite_plain(tensors):
    """The number of non-finite entries of `tensors`, a 0-dim int64."""
    return sum((~torch.isfinite(x)).sum() for x in tensors)


def on_kernel(device) -> bool:
    """Whether a pass on `device` takes the kernel (a CUDA device)."""
    return torch.device(device).type == "cuda"


@functools.lru_cache(maxsize=256)
def _hyper(lr, b1, b2, eps, bc1, bc2):
    """The kernel's hyper-parameters as float32 values: lr, b1, 1 - b1 and
    b2, 1 - b2 (each formed in double, then rounded), the float
    reciprocals of the bias corrections, eps."""
    f = np.float32
    return tuple(float(f(x)) for x in (
        lr, b1, 1 - b1, b2, 1 - b2, f(1) / f(bc1), f(1) / f(bc2), eps))


class OptimPass:
    """The segments of one optimizer launch on `device`."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.kernel = on_kernel(self.device)
        # ((p, m, v, g, p', m', v'), alive, hyper, row width, strides)
        self._adam = []
        # (ins, sg, sa, radii, outs, 0.5·W, 0.5·H, sg's and sa's strides)
        self._stats = None
        self._counted = []
        self._count = None

    # ---------------------------------------------------------- checks
    def _check(self, what, t, dtype=torch.float32, numel=None, rows=False):
        """Raise ValueError unless t is on the pass's device, of `dtype`,
        with `numel` elements (if given, else fewer than 2^31 in its
        span) and contiguous, or with `rows`, row-strided (each t[i]
        contiguous, the rows at least a row apart).  Returns t's (row
        width, row stride) in elements."""
        if t.device != self.device:
            raise ValueError(f"optim: {what} is on {t.device}, the pass on "
                             f"{self.device}")
        if t.dtype != dtype:
            raise ValueError(f"optim: {what} must be {dtype}, got {t.dtype}")
        n_rows = t.shape[0] if t.dim() else 1
        width = t.numel() // n_rows if n_rows else 1
        stride = width
        if not t.is_contiguous():
            stride = t.stride(0) if n_rows > 1 else width
            inner, expect = True, 1
            for n, st in zip(reversed(t.shape[1:]),
                             reversed(t.stride()[1:])):
                inner = inner and (n == 1 or st == expect)
                expect *= n
            if not (rows and inner and stride >= width):
                raise ValueError(f"optim: {what} must be contiguous"
                                 f"{' (a row stride aside)' if rows else ''}"
                                 f", got strides {t.stride()} of shape "
                                 f"{tuple(t.shape)}")
        span = max(n_rows - 1, 0) * stride + width
        if span > _MAX_N or (numel is not None and t.numel() != numel):
            raise ValueError(f"optim: {what} has {t.numel()} elements, "
                             f"expected {numel or 'fewer than 2^31'}")
        return width, stride

    # -------------------------------------------------------- segments
    def adam(self, p, m, v, g, lr, bc, b1, b2, eps, alive=None,
             in_place=False):
        """Adam on p (adam_plain's arguments, `bc` = (bc1, bc2)): (p', m',
        v'), new contiguous tensors; with `in_place`, p' is p (contiguous),
        written over.  p, m, v and g may be row-strided."""
        if not self.kernel:
            new, m, v = adam_plain(p, m, v, g, lr, *bc, b1, b2, eps, alive)
            if in_place:
                p.copy_(new)
                new = p
            return new, m, v
        strides = []
        for what, t in (("p", p), ("m", m), ("v", v), ("g", g)):
            if t.shape != p.shape:
                raise ValueError(f"optim: Adam's {what} of shape "
                                 f"{tuple(t.shape)} for p of shape "
                                 f"{tuple(p.shape)}")
            width, stride = self._check(f"Adam's {what}", t,
                                        rows=not (in_place and what == "p"))
            strides.append(stride)
        if alive is not None:
            self._check("the alive mask", alive, torch.bool)
            if alive.dim() != 1 or p.dim() == 0 or \
                    p.shape[0] != alive.shape[0]:
                raise ValueError(f"optim: an alive mask of shape "
                                 f"{tuple(alive.shape)} for a tensor of "
                                 f"shape {tuple(p.shape)}")
        hyper = _hyper(lr, b1, b2, eps, *bc)

        def new():
            return torch.empty(p.shape, dtype=p.dtype, device=p.device)
        out = (p if in_place else new(), new(), new())
        self._adam.append(((p, m, v, g, *out), alive, hyper, width,
                           strides))
        return out

    def stats(self, stats, screen_grad, screen_grad_abs, radii, width: int,
              height: int):
        """stats_plain's five new statistics (its arguments), one segment
        of the pass at most; the screen gradients may be row-strided."""
        if not self.kernel:
            return stats_plain(stats, screen_grad, screen_grad_abs, radii,
                               width, height)
        if self._stats is not None:
            raise ValueError("optim: one statistics segment a pass")
        P = radii.shape[0]
        self._check("radii", radii, torch.int32, P)
        for k, t in enumerate(stats):
            self._check(f"statistic {k}", t, numel=P)
        strides = [self._check(what, t, numel=2 * P, rows=True)[1]
                   for what, t in (("screen_grad", screen_grad),
                                   ("screen_grad_abs", screen_grad_abs))]
        outs = tuple(torch.empty(P, dtype=torch.float32, device=self.device)
                     for _ in stats)
        self._stats = (stats, screen_grad, screen_grad_abs, radii, outs,
                       float(np.float32(0.5 * width)),
                       float(np.float32(0.5 * height)), strides)
        return outs

    def nonfinite(self, tensors):
        """nonfinite_plain of `tensors` (float32, row-strided), a 0-dim
        int64 on the device, written by the launch; one count a pass."""
        tensors = list(tensors)
        if not self.kernel:
            return nonfinite_plain(tensors)
        if self._count is not None:
            raise ValueError("optim: one count a pass")
        for k, t in enumerate(tensors):
            self._check(f"counted tensor {k}", t, rows=True)
        self._counted = tensors
        self._count = torch.empty((), dtype=torch.int64, device=self.device)
        return self._count

    # ---------------------------------------------------------- launch
    def _segments(self):
        """(the Adam and count segments as (p, m, v, g, p', m', v', alive,
        hyper, flags, row width, the inputs' row strides), the statistics'
        count flags): each counted tensor that a segment reads as its
        gradient is counted there, the others in a count segment of their
        own."""
        left = list(self._counted)

        def counted(t):
            for k, u in enumerate(left):
                if u is t:
                    del left[k]
                    return True
            return False
        segs = [(*ts, alive, hyper,
                 _ADAM | (_COUNT if counted(ts[3]) else 0), width, strides)
                for ts, alive, hyper, width, strides in self._adam]
        flags = 0
        if self._stats is not None:
            flags = ((_COUNT if counted(self._stats[1]) else 0)
                     | (_COUNT_ABS if counted(self._stats[2]) else 0))
        for t in left:
            width, stride = self._check("a counted tensor", t, rows=True)
            segs.append((None, None, None, t, None, None, None, None, None,
                         0, width, (0, 0, 0, stride)))
        return [s for s in segs if s[3].numel()], flags

    def run(self):
        """Launch the recorded segments (nothing on the CPU, where each
        was computed when added)."""
        if not self.kernel or not (self._adam or self._stats or
                                   self._count is not None):
            return
        segs, stats_flags = self._segments()
        if len(segs) > _cuda.OPTIM_MAX_SEGS:
            raise ValueError(f"optim: {len(segs)} Adam and count segments "
                             f"in a pass, at most {_cuda.OPTIM_MAX_SEGS}")
        table, hypers = _cuda.OptimTable(), {}
        for k, (*ts, alive, hyper, flags, width, strides) in enumerate(segs):
            table.seg[k] = _cuda.OptimSeg(
                *(None if t is None else t.data_ptr() for t in ts),
                None if alive is None else alive.data_ptr(), ts[3].numel(),
                width, *strides, 0,
                hypers.setdefault(hyper, len(hypers)) if hyper else 0, flags)
        if len(hypers) > _cuda.OPTIM_MAX_HYPER:
            raise ValueError(f"optim: {len(hypers)} sets of hyper-parameters "
                             f"in a pass, at most {_cuda.OPTIM_MAX_HYPER}")
        for hyper, h in hypers.items():
            table.hyper[h] = _cuda.OptimHyper(*hyper)
        table.nseg = len(segs)
        if self._stats is not None:
            ins, sg, sa, radii, outs, hw, hh, strides = self._stats
            st = table.stats
            st.sg, st.sa, st.radii = (sg.data_ptr(), sa.data_ptr(),
                                      radii.data_ptr())
            st.ins[:] = [t.data_ptr() for t in ins]
            st.outs[:] = [t.data_ptr() for t in outs]
            st.P, st.half_w, st.half_h = radii.shape[0], hw, hh
            st.ssg, st.ssa = strides
            st.flags = stats_flags
        if self._count is not None:
            table.count = self._count.data_ptr()
        _cuda.optim(table, self.device)
