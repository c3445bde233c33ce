"""The optimizer's pass (ops/optim.py, csrc/optim.cu) on the CPU.

The kernel runs only on a card; tests/test_torch_gpu.py holds it to the
plain chain there, bit for bit.  Here:

* On CPU tensors the pass is the plain chain: `trainer.apply_grads` (a
  step's optimizer) and `adam_step`, `accumulate_stats` and `side_adam`
  alone equal the composition the train step ran before the pass (written
  out below) bit for bit, with and without aggregation, on a small state
  (403 slots, SH 2, 10% dead) with NaN and infinities planted in the
  gradients of live and dead slots, of the table, of the net and of the
  screen gradients; the count exact.
* The kernel's own path through the wrapper, with a host build of
  csrc/optim.cu (g++, no multiply-add contraction; one thread walks the
  whole table) standing in for the launch, against the plain chain as the
  card computes it: there a division by a Python scalar is a multiply by
  the float reciprocal, a square root is correctly rounded (this CPU's
  torch.sqrt can be an ulp off it), and the norm of a (P, 2) row adds the
  two rounded squares (tests/test_torch_gpu.py holds the card's plain
  chain to the kernel).  Bit for bit on the step's segments with and without
  aggregation, and on views that are not 16-byte aligned, past 36
  segments (two launches, the count zeroed once).  Tolerance 0.
* The table's layout against the source's, the launch through the seam,
  and the wrapper refusing what the kernel does not take (more than 36
  segments in a pass among it).
"""
import contextlib
import ctypes
import dataclasses
import subprocess
import types

import numpy as np
import pytest
import torch

from ibgs_tpu_torch.models import gaussians as G
from ibgs_tpu_torch.ops import _cuda, optim
from ibgs_tpu_torch.train import trainer
from tests import torch_bundle_inputs as tbi
from tests.test_torch_slice import one_torch_thread  # noqa: F401

P_SMALL = 403


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """optim.cu built for the host, without multiply-add contraction."""
    out = tmp_path_factory.mktemp("optim") / "liboptim_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-x", "c++", "-shared", "-fPIC", "-o", str(out),
                    str(_cuda.SOURCES["optim"])], check=True)
    lib = ctypes.CDLL(str(out))
    lib.ibgs_optim_host.argtypes = [ctypes.c_void_p]
    lib.ibgs_optim_host.restype = ctypes.c_int
    lib.ibgs_optim_layout.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    return lib


@pytest.fixture
def host_kernel(host_lib, monkeypatch):
    """The pass's kernel path on CPU tensors: the host build's entry stands
    in for the launch (the stream dropped), counted in a fresh launch
    counter; the device guard and the stream are left out."""
    entries = types.SimpleNamespace(
        ibgs_optim=lambda table, stream: host_lib.ibgs_optim_host(table))
    monkeypatch.setattr(_cuda, "load", lambda name: entries)
    monkeypatch.setattr(_cuda, "LAUNCHES", dict.fromkeys(_cuda.LAUNCHES, 0))
    monkeypatch.setattr(optim, "on_kernel", lambda device: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return monkeypatch


# ------------------------------------------- the composition before the pass

@torch.no_grad()
def old_adam_step(model, grads, lrs, b1=0.9, b2=0.999, eps=1e-15):
    step = model.step + 1
    bc1, bc2 = G.bias_corrections(step, b1, b2)
    alive = model.alive

    def upd(p, m, v, g, lr):
        g = torch.where(alive.reshape((-1,) + (1,) * (g.dim() - 1)), g, 0.0)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        return p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps), m, v

    out = {k: upd(getattr(model.params, k), getattr(model.mu, k),
                  getattr(model.nu, k), getattr(grads, k), getattr(lrs, k))
           for k in G.PARAM_FIELDS}
    return dataclasses.replace(
        model, params=G.GaussianParams(**{k: o[0] for k, o in out.items()}),
        mu=G.GaussianParams(**{k: o[1] for k, o in out.items()}),
        nu=G.GaussianParams(**{k: o[2] for k, o in out.items()}), step=step)


@torch.no_grad()
def old_accumulate_stats(model, screen_grad, screen_grad_abs, radii, width,
                         height):
    vis = radii > 0
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                         device=screen_grad.device)
    sgrad = screen_grad * scale
    sabs = screen_grad_abs * scale
    visf = vis.to(torch.float32)
    return dataclasses.replace(
        model,
        max_radii2d=torch.where(vis, torch.maximum(
            model.max_radii2d, radii.to(torch.float32)), model.max_radii2d),
        grad_accum=model.grad_accum + torch.where(
            vis, torch.linalg.vector_norm(sgrad, dim=-1), 0.0),
        grad_accum_abs=model.grad_accum_abs + torch.where(
            vis, torch.linalg.vector_norm(sabs, dim=-1), 0.0),
        denom=model.denom + visf, denom_abs=model.denom_abs + visf)


@torch.no_grad()
def old_side_adam(params, opt, grads, lr, b1=0.9, b2=0.999, eps=1e-8):
    step = opt.step + 1
    bc1, bc2 = G.bias_corrections(step, b1, b2)
    new_p, new_m, new_v = [], [], []
    for p, m, v, g in zip(params, opt.mu, opt.nu, grads):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        new_p.append(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        new_m.append(m)
        new_v.append(v)
    return new_p, trainer.SideOptState(mu=new_m, nu=new_v, step=step)


def old_run(x):
    """make_train_step's optimizer before the pass, on optim_inputs `x`
    (a copy of its net): tbi.optim_run's outputs."""
    import copy
    state, g, net = x.state, x.g, copy.deepcopy(x.state.net)
    count = sum((~torch.isfinite(t)).sum() for t in g.tensors())
    model = old_adam_step(state.model, g.params, x.lrs)
    model = old_accumulate_stats(model, g.screen, g.screen_abs, x.radii,
                                 *x.wh)
    (app_ab,), app_opt = old_side_adam([state.app_ab], state.app_opt,
                                       [g.app_ab], lr=1e-3, b2=0.99)
    net_opt = state.net_opt
    if x.phase.use_aggregation:
        params = list(net.parameters())
        new, net_opt = old_side_adam(params, state.net_opt, g.net,
                                     lr=x.net_lr)
        with torch.no_grad():
            for p, q in zip(params, new):
                p.copy_(q)
    outs = [*(getattr(getattr(model, t), k) for t in ("params", "mu", "nu")
              for k in G.PARAM_FIELDS),
            *(getattr(model, k) for k in G.STAT_FIELDS), app_ab,
            *app_opt.mu, *app_opt.nu, *net.parameters(), *net_opt.mu,
            *net_opt.nu]
    return [t.detach() for t in outs], count


def assert_same(got, want):
    (a, a_count), (b, b_count) = got, want
    assert int(a_count) == int(b_count) > 0
    assert len(a) == len(b)
    for i, (u, w) in enumerate(zip(a, b)):
        assert tbi.same_bits(u, w), (i, tuple(u.shape))


@pytest.mark.parametrize("aggregation", [True, False],
                         ids=["aggregation", "colour"])
def test_cpu_pass_equals_the_composition_before_it(aggregation):
    """apply_grads on CPU tensors: every tensor bit for bit and the count
    of the step's optimizer before the pass."""
    x = tbi.optim_inputs(P_SMALL, "cpu", 11, aggregation)
    got = tbi.optim_run(x)
    assert_same(got, old_run(x))
    # 12 planted with aggregation (6 in the Gaussians' gradients, 2 in the
    # net's, 1 in the table's, 3 in the screen gradients), 10 without
    assert int(got[1]) == (12 if aggregation else 10)


def test_cpu_calls_alone_equal_the_composition_before_them():
    """adam_step, accumulate_stats and side_adam, each with a pass of its
    own, bit for bit as before."""
    x = tbi.optim_inputs(P_SMALL, "cpu", 12)
    s, g = x.state, x.g
    pairs = [
        (G.adam_step(s.model, g.params, x.lrs),
         old_adam_step(s.model, g.params, x.lrs)),
        (G.accumulate_stats(s.model, g.screen, g.screen_abs, x.radii, *x.wh),
         old_accumulate_stats(s.model, g.screen, g.screen_abs, x.radii,
                              *x.wh))]
    for a, b in pairs:
        for t in ("params", "mu", "nu"):
            for k in G.PARAM_FIELDS:
                assert tbi.same_bits(getattr(getattr(a, t), k),
                                     getattr(getattr(b, t), k)), (t, k)
        for k in G.STAT_FIELDS:
            assert tbi.same_bits(getattr(a, k), getattr(b, k)), k
    params = list(s.net.parameters())
    new, st = trainer.side_adam(params, s.net_opt, g.net, lr=2e-3, b2=0.99)
    old, old_st = old_side_adam(params, s.net_opt, g.net, lr=2e-3, b2=0.99)
    assert st.step == old_st.step == 5
    for u, w in zip(new + st.mu + st.nu, old + old_st.mu + old_st.nu):
        assert tbi.same_bits(u, w)


# ------------------------------------------------ the kernel's path, hosted

def card_sqrt(x):
    """The correctly rounded float32 square root (from float64)."""
    return torch.sqrt(x.double()).float()


def card_adam(p, m, v, g, lr, bc1, bc2, b1, b2, eps, alive=None):
    """optim.adam_plain as the card computes it: the divisions by the
    Python scalars bc1, bc2 are multiplies by their float reciprocals, the
    square root correctly rounded."""
    inv1 = float(np.float32(1) / np.float32(bc1))
    inv2 = float(np.float32(1) / np.float32(bc2))
    if alive is not None:
        g = torch.where(alive.reshape((-1,) + (1,) * (g.dim() - 1)), g, 0.0)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    return p - lr * (m * inv1) / (card_sqrt(v * inv2) + eps), m, v


def card_stats(stats, screen_grad, screen_grad_abs, radii, width, height):
    """optim.stats_plain as the card computes it: a row's norm is the
    correctly rounded square root of the sum of its two rounded
    squares."""
    max_radii2d, grad_accum, grad_accum_abs, denom, denom_abs = stats
    vis = radii > 0
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32)

    def norm(s):
        s = s * scale
        return card_sqrt(s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1])
    visf = vis.to(torch.float32)
    return (torch.where(vis, torch.maximum(
                max_radii2d, radii.to(torch.float32)), max_radii2d),
            grad_accum + torch.where(vis, norm(screen_grad), 0.0),
            grad_accum_abs + torch.where(vis, norm(screen_grad_abs), 0.0),
            denom + visf, denom_abs + visf)


@pytest.mark.parametrize("aggregation", [True, False],
                         ids=["aggregation", "colour"])
def test_kernel_path_matches_the_card_chain(host_kernel, aggregation):
    """apply_grads through the wrapper and the host build: one launch,
    every tensor and the count as the card's plain chain has them."""
    x = tbi.optim_inputs(P_SMALL, "cpu", 13, aggregation)
    got = tbi.optim_run(x)
    assert _cuda.LAUNCHES["optim"] == 1
    host_kernel.setattr(optim, "adam_plain", card_adam)
    host_kernel.setattr(optim, "stats_plain", card_stats)
    assert_same(got, tbi.optim_run(x, kernel=False))


def test_kernel_path_on_misaligned_views(host_kernel):
    """side_adam over 30 tensors, every other one a view one float into its
    storage (so not 16-byte aligned), their gradients counted by the same
    pass: one launch, bit for bit; a 37th segment refused."""
    gen = torch.Generator().manual_seed(14)
    shapes = [(k % 7 + 1, 3 + k % 5) for k in range(30)]

    def views(scale, positive=False):
        out = []
        for k, s in enumerate(shapes):
            n = int(np.prod(s))
            t = torch.randn(n + 1, generator=gen) * scale
            t = (t.abs() if positive else t)[k % 2:n + k % 2].view(s)
            out.append(t)
        return out
    p, m, v, g = views(1.0), views(1e-2), views(1e-4, True), views(1e-2)
    g[0][0, 0], g[29][-1, -1], g[17][1, 2] = np.nan, np.inf, -np.inf
    assert p[1].data_ptr() % 16 and not p[0].data_ptr() % 16
    opt = trainer.SideOptState(mu=m, nu=v, step=9)

    def run(extra=()):
        op = optim.OptimPass("cpu")
        count = op.nonfinite([*g, *extra])
        new, st = trainer.side_adam(p, opt, g, lr=3e-3, into=op)
        op.run()
        return new + st.mu + st.nu, count
    got = run()
    assert _cuda.LAUNCHES["optim"] == 1
    with pytest.raises(ValueError, match="37 Adam and count segments"):
        run([torch.zeros(3) for _ in range(7)])
    host_kernel.setattr(optim, "on_kernel", lambda device: False)
    host_kernel.setattr(optim, "adam_plain", card_adam)
    want = run()
    assert int(got[1]) == int(want[1]) == 3
    for u, w in zip(got[0], want[0]):
        assert tbi.same_bits(u, w)


def test_table_layout_matches_the_source(host_lib):
    """The wrapper's ctypes table has the source's size and offsets."""
    out = (ctypes.c_longlong * 6)()
    host_lib.ibgs_optim_layout(out)
    T = _cuda.OptimTable
    assert list(out) == [ctypes.sizeof(T),
                         T.seg.offset + ctypes.sizeof(_cuda.OptimSeg),
                         T.hyper.offset, T.stats.offset, T.count.offset,
                         T.nseg.offset]
    # the kernel's parameter stays within the classic 4 KB
    assert ctypes.sizeof(T) <= 4096


def test_optim_launches_its_entry(monkeypatch):
    """`_cuda.optim` hands its C entry the table's address and the stream
    and counts one launch."""
    calls = []
    monkeypatch.setattr(_cuda, "load", lambda name: types.SimpleNamespace(
        ibgs_optim=lambda *a: calls.append(a) or 0))
    monkeypatch.setattr(_cuda, "LAUNCHES", dict.fromkeys(_cuda.LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=99))
    table = _cuda.OptimTable()
    _cuda.optim(table, "cpu")
    assert calls == [(ctypes.addressof(table), 99)]
    assert {k: n for k, n in _cuda.LAUNCHES.items() if n} == {"optim": 1}


# what the kernel does not take: (the offending argument, the error)
REFUSALS = {
    "mixed_devices": ("p", "is on meta"),
    "float64": ("g", "must be torch.float32"),
    "non_contiguous": ("m", "must be contiguous"),
    "alive_not_bool": ("alive", "must be torch.bool"),
    "radii_int64": ("radii", "must be torch.int32"),
    "count_float16": ("counted", "must be torch.float32"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_pass_refuses_what_the_kernel_does_not_take(host_kernel, case):
    """A ValueError naming the fault, raised when the segment is added;
    nothing launched."""
    what, message = REFUSALS[case]
    t = {k: torch.zeros(6, 4) for k in ("p", "m", "v", "g")}
    alive = torch.ones(6, dtype=torch.bool)
    stats = [torch.zeros(6) for _ in range(5)]
    sg, radii = torch.zeros(6, 2), torch.zeros(6, dtype=torch.int32)
    bad = {"mixed_devices": torch.zeros(6, 4, device="meta"),
           "float64": torch.zeros(6, 4, dtype=torch.float64),
           "non_contiguous": torch.zeros(4, 6).t(),
           "alive_not_bool": torch.ones(6, dtype=torch.uint8),
           "radii_int64": torch.zeros(6, dtype=torch.int64),
           "count_float16": torch.zeros(3, dtype=torch.float16)}[case]
    if what in t:
        t[what] = bad
    op = optim.OptimPass("cpu")
    with pytest.raises(ValueError, match=message):
        if what == "radii":
            op.stats(stats, sg, sg, bad, 64, 32)
        elif what == "counted":
            op.nonfinite([t["g"], bad])
        else:
            op.adam(*t.values(), 1e-3, (0.1, 0.001), 0.9, 0.999, 1e-15,
                    alive=bad if what == "alive" else alive)
    op.run()
    assert _cuda.LAUNCHES["optim"] == 0
