"""The control and the planted faults must come out as not correct.

On the CPU, at a size a test run holds, each test drives the rest of a
run (set-up, window, check against the cell's limits in checks/) with the
card's look skipped:

* the control: the reference in the program's place, computed in bf16 at
  each layer boundary (`benchmark.reference.precision`);
* the faults a cell can have: a step that returns its state unchanged,
  half of the image left out of the loss (its mean over the rest), an
  answer altered where it is produced (the render's colour channels in
  the wrong order, as a layout slip would leave them), and for
  serving a view that returns an earlier view's answer and one whose
  fused image loses half its rows.  One card, so no exchange between
  chips to leave out.

Marked `gpu`: the control at the cell's own size on the card, one seed
and cell (`python -m pytest -m gpu benchmark/tests/test_benchmark_control.py`).
"""
from __future__ import annotations

import contextlib
import json
import math

import pytest
import torch

from benchmark import harness

SPEC = harness.load_spec()
TRAIN = [w["name"] for w in SPEC["workloads"]
         if harness.traffic(w["traffic"])["driver"] == "train"]
SERVE = [w["name"] for w in SPEC["workloads"]
         if harness.traffic(w["traffic"])["driver"] == "serve"]


@pytest.fixture(autouse=True)
def cpu_card(monkeypatch):
    """On a machine with no card, the drivers' synchronise and cache calls
    do nothing."""
    if not torch.cuda.is_available():
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny_run(cell: str, seed: int = 2 ** 31 + 101):
    """The cell's driver on the CPU at 64x48: the 1M scene cut to 800 seed
    splats and 6 views, the bundle to every 60th splat."""
    w = harness.cell(SPEC, cell)
    cfg, mod = harness.config_files(w["config"])
    traffic = dict(harness.traffic(w["traffic"]), width=64, height=48,
                   compared_from_first=1, compared_views=1)
    build = mod.build
    if w["config"] == "prod-1m":
        cfg = dict(cfg, gt_points=3200, seed_points=800, capacity=1024,
                   views=6, eval_every=3)
    else:
        def build(cfg, traffic, seed, device):
            s = mod.build(cfg, traffic, seed, device)
            keep = torch.arange(0, s.params["xyz"].shape[0], 60)
            s.params = {k: v[keep].contiguous() for k, v in
                        s.params.items()}
            s.alive = s.alive[keep]
            return s
    ctx = {"config": cfg, "config_module": type("M", (), {"build": build}),
           "traffic": traffic, "seed": seed, "seconds": 0.01,
           "trace": False, "cell": cell, "device": torch.device("cpu")}
    return harness.driver(traffic["driver"]).Run(ctx)


def verdict(run, lowered=None) -> bool:
    run.setup()
    run.window(0.01)
    run.release()
    checks, _, _ = run.check(harness.limits(run.ctx["cell"]), lowered)
    return all(lim is not None and math.isfinite(v) and v <= lim
               for _, v, lim in checks)


def _limits_set(cell):
    lim = harness.limits(cell)
    if not lim:
        pytest.skip(f"checks/{cell}.json holds no limits yet")


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell):
    _limits_set(cell)
    assert verdict(tiny_run(cell))


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_is_not_correct(cell):
    _limits_set(cell)
    assert not verdict(tiny_run(cell), lowered=torch.bfloat16)


@contextlib.contextmanager
def fault(name):
    """Plant one fault in the port's timed path."""
    from ibgs_tpu_torch.eval import render_driver
    from ibgs_tpu_torch.ops import rasterize
    from ibgs_tpu_torch.train import losses, trainer

    mp = pytest.MonkeyPatch()
    if name == "state_unchanged":
        make = trainer.make_train_step

        def make_frozen(*a, **k):
            step = make(*a, **k)

            def frozen(state, *args):
                _, aux = step(state, *args)
                return state, aux
            return frozen
        mp.setattr(trainer, "make_train_step", make_frozen)
    elif name == "half_the_image":
        l1 = losses.l1
        mp.setattr(losses, "l1", lambda a, b: l1(a[: a.shape[0] // 2],
                                                 b[: b.shape[0] // 2]))
    elif name == "answer_altered":
        rast = rasterize.rasterize

        def altered(**kw):
            res = rast(**kw)
            res.render = res.render.flip(-1)      # blue, green, red
            return res
        mp.setattr(rasterize, "rasterize", altered)
        from ibgs_tpu_torch import renderer
        mp.setattr(renderer, "rasterize", altered)
    elif name == "stale_view":
        one = render_driver.EvalRenderer.render_one
        first = {}

        def stale(self, cam, nearest):
            if "out" not in first:
                first["out"] = one(self, cam, nearest)
            return first["out"]
        mp.setattr(render_driver.EvalRenderer, "render_one", stale)
    elif name == "half_the_rows":
        one = render_driver.EvalRenderer.render_one

        def cut(self, cam, nearest):
            out = dict(one(self, cam, nearest))
            agg = out["aggregate"].clone()
            agg[agg.shape[0] // 2:] = 0.0
            out["aggregate"] = agg
            return out
        mp.setattr(render_driver.EvalRenderer, "render_one", cut)
    try:
        yield
    finally:
        mp.undo()


@pytest.mark.parametrize("cell,name", [
    (c, f) for c in TRAIN
    for f in ("state_unchanged", "half_the_image", "answer_altered")] + [
    (c, f) for c in SERVE
    for f in ("stale_view", "half_the_rows", "answer_altered")])
def test_fault_is_not_correct(cell, name):
    _limits_set(cell)
    run = tiny_run(cell)
    with fault(name):
        assert not verdict(run)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", TRAIN + SERVE)
@pytest.mark.parametrize("seed", [2 ** 31 + 501, 2 ** 31 + 502,
                                  2 ** 31 + 503])
def test_control_at_the_cells_size(cell, seed, capsys):
    """The control at the cell's own size on the card: its readings are
    printed as one JSON line for the record, and it must fail a limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _limits_set(cell)
    w = harness.cell(SPEC, cell)
    cfg, mod = harness.config_files(w["config"])
    traffic = harness.traffic(w["traffic"])
    ctx = {"config": cfg, "config_module": mod, "traffic": traffic,
           "seed": seed, "seconds": 3.0, "trace": False, "cell": cell,
           "device": torch.device("cuda", 0)}
    run = harness.driver(traffic["driver"]).Run(ctx)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run.setup()
    run.window(3.0)
    run.release()
    checks, detail, _ = run.check(harness.limits(cell), torch.bfloat16)
    with capsys.disabled():
        print(json.dumps({"control": cell, "seed": seed,
                          "checks": checks, "detail": detail}))
    assert not all(lim is not None and math.isfinite(v) and v <= lim
                   for _, v, lim in checks)
