"""The density-control cell of the benchmark (`prod-1m.densify-544p`,
`benchmark/drivers/densify.py`) on the CPU at 64x48: the 1M scene cut to
800 seed splats in 1,024 slots and 6 views, with the card's synchronise
and cache calls made no-ops.

* A sound run (set-up, a window, the check against the cell's limits)
  reads `correct`: its first event, after the last compared step, is the
  reference's event record for record, and both event gaps are 0.
* The control (the reference in bf16) fails a limit.
* The per-layer readers: `densify_ms` reads the device time launched
  under `train/maintenance.py` per event, `densify_idle_ms` the idle time
  under its frames per event, both None without an event; the driver's
  `maintenance_idle_s` on a hand-made trace.
"""
import math

import pytest
import torch

from benchmark import harness
from benchmark import trace as tr
from tests.test_torch_slice import one_torch_thread  # noqa: F401

CELL = "prod-1m.densify-544p"
SPEC = harness.load_spec()


@pytest.fixture(scope="module")
def run():
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    mp.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    w = harness.cell(SPEC, CELL)
    cfg, mod = harness.config_files(w["config"])
    traffic = dict(harness.traffic(w["traffic"]), width=64, height=48)
    cfg = dict(cfg, gt_points=3200, seed_points=800, capacity=1024,
               views=6, eval_every=3)
    ctx = {"config": cfg, "config_module": mod, "traffic": traffic,
           "seed": 2 ** 31 + 101, "seconds": 0.01, "trace": False,
           "cell": CELL, "device": torch.device("cpu")}
    r = harness.driver(traffic["driver"]).Run(ctx)
    r.setup()
    r.window_rec = r.window(0.01)
    r.release()
    yield r
    torch.set_num_threads(threads)
    mp.undo()


def _correct(checks):
    return all(lim is not None and math.isfinite(v) and v <= lim
               for _, v, lim in checks)


def test_densify_cell_sound_run_is_correct(run):
    assert run.window_rec["failed"] == 0
    checks, detail, _ = run.check(harness.limits(CELL))
    assert _correct(checks), checks
    got = {c[0]: c[1] for c in checks}
    assert got["densify_alive_gap"] == 0.0 == got["densify_param_gap"]
    first = detail["first_event"]
    assert first["iter"] == 7100
    assert {k: first[k] for k in detail["first_event_reference"]} == \
        detail["first_event_reference"]
    assert first["split"] > 0


def test_densify_cell_control_is_not_correct(run):
    checks, _, _ = run.check(harness.limits(CELL), torch.bfloat16)
    assert not _correct(checks)


def test_densify_readers():
    ms = harness.metric_reader("densify_ms.train")
    idle = harness.metric_reader("densify_idle_ms.train")
    ctx = {"units": 4, "events": 1, "maintenance_idle_s": 0.003,
           "stacked": {"stacks": [
               [["train/maintenance.py", "train/trainer.py",
                 "models/gaussians.py"], 0.002],
               [["train/trainer.py", "models/gaussians.py"], 0.05],
               [["train/maintenance.py"], 0.001]]}}
    assert ms.read(ctx) == pytest.approx(3.0)
    assert idle.read(ctx) == pytest.approx(3.0)
    for c in ({**ctx, "events": 0}, {k: v for k, v in ctx.items()
                                     if k not in ("events",
                                                  "maintenance_idle_s")}):
        assert ms.read(c) is None and idle.read(c) is None


def test_maintenance_idle_is_idle_under_the_maintenance_frames():
    drv = harness.driver("densify")
    frame = "/x/ibgs_tpu_torch/train/maintenance.py(80): maintain"

    def x(name, cat, ts, dur, tid=1):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "pid": 1, "tid": tid}

    events = [
        x(tr.WINDOW_LABEL, "user_annotation", 0, 1000),
        x("step", "python_function", 0, 400),
        x(frame, "python_function", 400, 300),
        x("other", "python_function", 700, 300),
        x("k", "kernel", 0, 450, tid=7),       # busy 0-450
        x("k", "kernel", 500, 100, tid=7),     # busy 500-600
        x("k", "kernel", 900, 100, tid=7)]     # busy 900-1000
    # idle 450-500 and 600-900; the frame is open 400-700: 50 + 100 us
    assert drv.maintenance_idle_s(events) == pytest.approx(150e-6)


def test_densify_config_is_prod_1m_under_its_density_control():
    """The cell's configuration is prod-1m's scene, number for number,
    with the deployment's density control as `options`; the traffic sets
    the same values, so the cell runs the deployment it names."""
    w = harness.cell(SPEC, CELL)
    cfg, mod = harness.config_files(w["config"])
    prod, _ = harness.config_files("prod-1m")
    own = {"name", "source", "architecture", "options", "assumed",
           "deployment"}
    assert {k: v for k, v in cfg.items() if k not in own} == \
        {k: v for k, v in prod.items() if k not in own}
    opt = cfg["options"]
    assert opt["densify_grad_threshold"] == 8e-5
    assert opt["densify_abs_grad_threshold"] == 1.6e-4
    from ibgs_tpu_torch.config import OptimizationParams
    fields = set(OptimizationParams.__dataclass_fields__)
    assert set(opt) <= fields
    options = harness.traffic(w["traffic"])["options"]
    assert {k: opt[k] for k in options} == options
    assert harness.config_entry(SPEC, w["config"])["source"] != \
        harness.config_entry(SPEC, "prod-1m")["source"]
