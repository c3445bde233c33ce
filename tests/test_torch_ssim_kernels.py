"""The SSIM kernels (csrc/ssim.cu) on the CPU: the dispatch, the wrapper's
input checks, the C entries' bindings, and the kernels' tile code against
the plain chain.

The kernels run only on a card (tests/test_torch_gpu.py holds them to the
plain chain there).  Their CTA bodies are loops over a tile's items in
steps of the thread count; a host build of the same source (g++, no CUDA,
no multiply-add contraction) runs every CTA in sequence with one thread:
`ibgs_ssim_fwd_host` and `ibgs_ssim_bwd_host`.  On every seeded case (a
37x53 frame, frames of height and width under the 11-tap window, a
540-row frame off the 16-row tile grid, channel counts 1 and 4, a (3, H,
W, 3) stack, the stack with a stride-0 first argument as
`multi_view_photometric` passes the ground truth, constant and all-zero
images) the map must equal `losses.ssim_map_plain`'s bit for bit, and
each input's gradient autograd's through the plain chain in float32, bit
for bit, when its terms are added in autograd's order: with both inputs,
the first or the second needing one, and for a map gradient read through
strides.  Tolerance 0: the kernels repeat autograd's operations in its
order (csrc/ssim.cu).  Through the wrapper's autograd Function (the host
build standing in for the launches), the training objective's loss and
gradients equal the plain chain's bit for bit: autograd adds the
kernel's terms to the other losses' gradients in the plain chain's order.
"""
import contextlib
import types
import ctypes
import re
import subprocess
import zlib

import numpy as np
import pytest
import torch

from ibgs_tpu_torch.config import OptimizationParams
from ibgs_tpu_torch.ops import _cuda
from ibgs_tpu_torch.ops import ssim as tssim
from ibgs_tpu_torch.train import losses, trainer
from tests.test_torch_slice import one_torch_thread  # noqa: F401

_P, _LL, _INT, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_float)
_HOST = {"ibgs_ssim_fwd_host": [_P, _LL, _P, _LL] + [_INT] * 4
         + [_P, _F, _F] + [_P] * 2,
         "ibgs_ssim_bwd_host": [_P, _LL, _P, _LL] + [_INT] * 4
         + [_P, _F, _F, _P] + [_LL] * 4 + [_P] * 7}

# name: (shape, images); shapes (H, W, C) or (B, H, W, C)
CASES = {
    "frame_37x53": ((37, 53, 3), "random"),
    "under_window_5x7": ((5, 7, 3), "random"),
    "one_pixel": ((1, 1, 3), "random"),
    "under_window_10x3_c1": ((10, 3, 1), "random"),
    "under_window_3x40_c4": ((3, 40, 4), "random"),
    "rows_540": ((540, 40, 3), "random"),
    "stack": ((3, 23, 35, 3), "random"),
    "stack_stride0": ((3, 23, 35, 3), "stride0"),
    "constant": ((19, 45, 3), "constant"),
    "zeros": ((19, 45, 3), "zeros"),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """ssim.cu built for the host, without multiply-add contraction."""
    out = tmp_path_factory.mktemp("ssim") / "libssim_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-x", "c++", "-shared", "-fPIC", "-o", str(out),
                    str(_cuda.SOURCES["ssim"])], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _HOST.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _INT
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def images(name):
    """The seeded (img1, img2) of case `name` (img1 of the stride-0 case a
    frame expanded over the stack)."""
    shape, kind = CASES[name]
    r = np.random.default_rng(zlib.crc32(name.encode()))
    if kind == "constant":
        a = np.full(shape, 0.37, np.float32)
        return torch.as_tensor(a), torch.as_tensor(np.full(shape, 0.81,
                                                           np.float32))
    if kind == "zeros":
        return torch.zeros(shape), torch.zeros(shape)
    a = r.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + r.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if kind == "stride0":
        a = a[0][None].expand_as(b)
    return a, b


def host_fwd(lib, x, y, moments=False):
    """The host build's map and, where `moments`, the five moments."""
    shape, bx = tssim._frames(x)
    by = tssim._frames(y)[1]
    out = torch.empty(shape)
    mom = torch.empty((5, *shape)) if moments else None
    window, c1, c2 = tssim._constants()
    assert lib.ibgs_ssim_fwd_host(_ptr(x), bx, _ptr(y), by, *shape, window,
                                  c1, c2, _ptr(out), _ptr(mom)) == 0
    return out.view(x.shape), mom


def host_bwd_entry(lib, x, xb, y, yb, shape, window, c1, c2, g, strides,
                   mom, dx, dy):
    """The host build's backward entry, called with `_cuda.ssim_bwd`'s
    arguments."""
    terms = [_ptr(t) for d in (dx, dy)
             for t in (d if d is not None else (None,) * 3)]
    return lib.ibgs_ssim_bwd_host(_ptr(x), xb, _ptr(y), yb, *shape, window,
                                  c1, c2, _ptr(g), *strides, _ptr(mom),
                                  *terms)


def host_bwd(lib, x, y, g, mom, need1, need2):
    """The host build's gradients of x and y (None where not wanted), each
    its three terms added as autograd adds them: ((cross + square) +
    square) + mean."""
    shape, bx = tssim._frames(x)
    by = tssim._frames(y)[1]
    g4 = g if g.dim() == 4 else g[None]
    strides = (g4.stride(0) if shape[0] > 1 else 0, *g4.stride()[1:])
    dx, dy = (tuple(torch.empty(shape) for _ in range(3)) if n else None
              for n in (need1, need2))
    assert host_bwd_entry(lib, x, bx, y, by, shape, *tssim._constants(), g4,
                          strides, mom, dx, dy) == 0
    return [None if d is None else
            (((d[0] + d[1]) + d[1]) + d[2]).view(x.shape) for d in (dx, dy)]


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def plain_grads(x, y, g, need1=True, need2=True):
    """Autograd through the plain chain: d(Σ map·g) / dx and / dy (None
    where not wanted)."""
    xd = x.detach().requires_grad_(need1)
    yd = y.detach().requires_grad_(need2)
    ins = [t for t in (xd, yd) if t.requires_grad]
    got = iter(torch.autograd.grad(losses.ssim_map_plain(xd, yd), ins, g))
    return [next(got) if n else None for n in (need1, need2)]


@pytest.mark.parametrize("name", list(CASES))
def test_host_forward_matches_plain_bit_for_bit(name, host_lib):
    x, y = images(name)
    want = losses.ssim_map_plain(x, y)
    got, mom = host_fwd(host_lib, x, y)
    assert same_bits(got, want) and mom is None
    # writing the moments leaves the map as it is; they are the blurs
    got2, mom = host_fwd(host_lib, x, y, True)
    assert same_bits(got2, want)
    for m, img in zip(mom, (x, y, x * x, y * y, x * y)):
        assert same_bits(m.view(want.shape), losses._blur(img))
    if CASES[name][1] == "zeros":
        assert bool((want == 1.0).all())


@pytest.mark.parametrize("name", list(CASES))
def test_host_backward_matches_autograd_bit_for_bit(name, host_lib):
    """Both inputs, the first, the second needing a gradient; repeats."""
    x, y = images(name)
    x = x.contiguous() if CASES[name][1] == "stride0" else x
    g = torch.as_tensor(np.random.default_rng(zlib.crc32(name.encode())
                                              + 1).normal(
        size=tuple(x.shape)).astype(np.float32))
    _, mom = host_fwd(host_lib, x, y, True)
    for need in ((True, True), (True, False), (False, True)):
        got = host_bwd(host_lib, x, y, g, mom, *need)
        for k, want in zip(got, plain_grads(x, y, g, *need)):
            assert (k is None) == (want is None), need
            assert k is None or same_bits(k, want), need
    first, again = (host_bwd(host_lib, x, y, g, mom, True, True)
                    for _ in range(2))
    assert all(same_bits(a, b) for a, b in zip(first, again))


def test_host_backward_stride0_and_strided_gradient(host_lib):
    """The stride-0 first argument as the train step passes it (only the
    stack needs a gradient), and a map gradient read through strides (a
    channel mean's broadcast, stride 0 along C)."""
    x, y = images("stack_stride0")
    gm = torch.as_tensor(np.random.default_rng(7).normal(
        size=tuple(y.shape[:3])).astype(np.float32))
    g = gm[..., None].expand_as(y)
    assert g.stride(-1) == 0
    _, mom = host_fwd(host_lib, x, y, True)
    dx, dy = host_bwd(host_lib, x, y, g, mom, False, True)
    assert dx is None
    assert same_bits(dy, plain_grads(x, y, g, False, True)[1])
    assert same_bits(host_bwd(host_lib, x, y, g.contiguous(), mom, False,
                              True)[1], dy)


@pytest.fixture
def host_kernels(host_lib, monkeypatch):
    """`ssim_map_cuda`'s own path on CPU tensors, through `_cuda`'s launch
    wrappers: the host build's entries stand in for the C entries (the
    stream argument dropped), counted in a LAUNCHES of their own; the
    device check, the device guard and the stream are left out."""
    entries = types.SimpleNamespace(
        ibgs_ssim_fwd=lambda *a: host_lib.ibgs_ssim_fwd_host(*a[:-1]),
        ibgs_ssim_bwd=lambda *a: host_lib.ibgs_ssim_bwd_host(*a[:-1]))
    monkeypatch.setattr(_cuda, "load", lambda name: entries)
    monkeypatch.setattr(_cuda, "LAUNCHES", dict.fromkeys(_cuda.LAUNCHES, 0))
    monkeypatch.setattr(tssim, "_check", lambda a, b: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return monkeypatch


def _objective_inputs(seed=3, H=45, W=70, S=3):
    """Seeded leaves of a geometry step's objective: the render's
    pre-activation, the warped sources, the rendered normal, the exposure
    table; the ground truth, the source features, the depth normal."""
    r = np.random.default_rng(seed)

    def t(*shape, grad=False, lo=-1.0, hi=1.0):
        return torch.as_tensor(r.uniform(lo, hi, shape).astype(np.float32)
                               ).requires_grad_(grad)
    leaves = dict(x=t(H, W, 3, grad=True), warped=t(S, H, W, 3, grad=True,
                                                   lo=0.0),
                  normal=t(H, W, 3, grad=True),
                  app_ab=t(trainer.APP_CAPACITY, 2, grad=True, lo=-0.1,
                           hi=0.1))
    fixed = dict(gt=t(H, W, 3, lo=0.0), feat=t(S, H, W, 8, lo=-0.2),
                 dnormal=t(H, W, 3))
    return leaves, fixed


def _objective_grads(leaves, fixed):
    """trainer.ibgs_objective of a geometry step without the net: its
    loss and the gradients of every leaf."""
    opt = OptimizationParams()
    image = torch.sigmoid(leaves["x"])
    ibr = types.SimpleNamespace(warped_image=leaves["warped"],
                                cam_feat=fixed["feat"])
    total, _ = trainer.ibgs_objective(
        opt, trainer.StepPhase(render_geo=True, use_aggregation=False), None,
        leaves["app_ab"], 3, image, leaves["normal"], fixed["dnormal"], ibr,
        fixed["gt"], 13000, True, 1.0)
    return total, torch.autograd.grad(total, list(leaves.values()))


def test_objective_through_the_kernels_path_matches_plain(host_kernels):
    """The geometry step's objective (image loss with the exposure switch,
    normal consistency, the multi-view photometric loss over a stride-0
    ground truth stack) with `ssim_map` through the wrapper's autograd
    Function against the plain chain: the loss and every leaf's gradient
    bit for bit; 2 forward and 2 backward calls counted."""
    leaves, fixed = _objective_inputs()
    want_total, want = _objective_grads(leaves, fixed)
    host_kernels.setattr(losses, "ssim_map", tssim.ssim_map_cuda)
    got_total, got = _objective_grads(leaves, fixed)
    assert {k: n for k, n in _cuda.LAUNCHES.items() if n} == \
        {"ssim_fwd": 2, "ssim_bwd": 2}
    assert same_bits(got_total.detach(), want_total.detach())
    for name, a, b in zip(leaves, got, want):
        assert same_bits(a, b), name


def test_host_entries_refuse_sizes(host_lib):
    x = torch.zeros(4, 4, 3)
    window, c1, c2 = tssim._constants()
    out = torch.empty(4, 4, 3)
    for B, H, W, C in ((0, 4, 4, 3), (1, 0, 4, 3), (70000, 4, 4, 3)):
        assert host_lib.ibgs_ssim_fwd_host(
            _ptr(x), 0, _ptr(x), 0, B, H, W, C, window, c1, c2, _ptr(out),
            None) == 1
        assert host_lib.ibgs_ssim_bwd_host(
            _ptr(x), 0, _ptr(x), 0, B, H, W, C, window, c1, c2, _ptr(out),
            0, 0, 0, 0, _ptr(out), *(None,) * 6) == 1


def test_cpu_tensors_take_the_plain_path():
    """`losses.ssim_map` on CPU tensors is the plain chain, forward and
    backward, and launches nothing."""
    x, y = images("frame_37x53")
    before = dict(_cuda.LAUNCHES)
    xg = x.clone().requires_grad_(True)
    got = losses.ssim_map(xg, y)
    (g,) = torch.autograd.grad(got.sum(), xg)
    xp = x.clone().requires_grad_(True)
    want = losses.ssim_map_plain(xp, y)
    (gp,) = torch.autograd.grad(want.sum(), xp)
    assert same_bits(got.detach(), want.detach()) and same_bits(g, gp)
    assert float(losses.ssim(x, y)) == float(want.detach().mean())
    assert _cuda.LAUNCHES == before
    assert (before["ssim_fwd"], before["ssim_bwd"]) == (0, 0)


def test_cuda_wrapper_rejects_bad_inputs():
    """The kernels' wrapper raises ValueError, before any build or launch,
    on a dtype other than float32, a wrong rank, shapes that differ, sizes
    out of range, a non-contiguous frame or batch, and (checked last)
    tensors that are not on one CUDA device."""
    x, y = images("stack")
    f = x[0]
    meta = torch.empty(f.shape, device="meta")
    bad = [
        ((f.double(), y[0]), "img1 must be float32"),
        ((f, y[0].half()), "img2 must be float32"),
        ((f[..., 0], y[0, ..., 0]), "img1 must be \\(H, W, C\\)"),
        ((x[None], y[None]), "img1 must be \\(H, W, C\\)"),
        ((f, y), "one shape"),
        ((f[:, :0], y[0][:, :0]), "at least 1x1x1"),
        ((f.transpose(0, 1), y[0].transpose(0, 1).contiguous()),
         "img1 must be contiguous"),
        ((f, y[0].transpose(0, 1).contiguous().transpose(0, 1)),
         "img2 must be contiguous"),
        ((x[::2], y[::2]), "img1 must be contiguous"),
        ((f, y[0]), "one CUDA device"),
        ((f, meta), "one CUDA device"),
    ]
    before = dict(_cuda.LAUNCHES)
    for args, msg in bad:
        with pytest.raises(ValueError, match=msg):
            tssim.ssim_map_cuda(*args)
    # a CPU frame against a tensor of another device takes the kernels'
    # path in the dispatch, which refuses it
    with pytest.raises(ValueError, match="one CUDA device"):
        losses.ssim_map(f, meta)
    assert _cuda.LAUNCHES == before


def test_ssim_kernels_are_built_and_bound():
    """ssim.cu is among the sources `_cuda.build` compiles, each C entry's
    ctypes signature has as many arguments as its declaration, and the host
    entries the tests call have theirs."""
    assert _cuda.SOURCES["ssim"].name == "ssim.cu"
    text = _cuda.SOURCES["ssim"].read_text()
    for fn in ("ibgs_ssim_fwd", "ibgs_ssim_bwd", "ibgs_ssim_info"):
        assert fn in _cuda._SIGNATURES
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert m, fn
        assert len(m.group(1).split(",")) == len(_cuda._SIGNATURES[fn][0])
    for fn, argtypes in _HOST.items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert m, fn
        assert len(m.group(1).split(",")) == len(argtypes)
    assert 'extern "C" const char* ibgs_cuda_error_string' in text
    assert [k for k in _cuda.LAUNCHES if k.startswith("ssim")] == \
        ["ssim_fwd", "ssim_bwd"]
