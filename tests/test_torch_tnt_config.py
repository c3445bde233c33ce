"""The Tanks and Temples configuration of the benchmark (`tnt-2m`: both
exposure options on, a frame off the tile grid) and the colour-phase
step, held to the benchmark's plain reference on the CPU.

* One train step of the port (its plain versions run on the CPU) against
  `benchmark.reference`'s step on a tiny `tnt-2m` scene at 72x60 (60 rows
  are 3.75 tile rows): losses, the gradient of every leaf (the exposure
  table's included) and the state after the step.  The geometry and
  aggregation step takes the exposed L1 (use_app on, SSIM loss under
  0.5: the view's image is the model's own render under an exposure);
  the colour-phase step is `StepPhase(False, False)`.
* `models/exposure.exposure_affine` against the reference's.
* The configuration maker's neighbour rule against the data layer's
  `_neighbor_ids` with the exposure-aware reordering, on the
  configuration's 64 ring cameras.
* `benchmark/drivers/train_options.py` end to end on the CPU at a tiny
  size for both cells that use it: a sound run reads correct, and the
  colour step's work record counts no warp and no net.
* The `exposure_ms` reader on a hand-built stacked reduction.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark import compare, harness, sides
from benchmark import scene as sc
from benchmark.metrics import exposure_ms
from benchmark.reference import aggregation as ragg
from ibgs_tpu_torch.data import dataset
from ibgs_tpu_torch.models import aggregation, exposure
from tests.test_torch_slice import one_torch_thread  # noqa: F401

W, H = 72, 60
SPEC = harness.load_spec()
CFG, MAKER = harness.config_files("tnt-2m")
TINY = dict(CFG, gt_points=6000, seed_points=1500, capacity=2048, views=16)
ITERATION = 13000


@pytest.fixture(scope="module")
def scene():
    torch.manual_seed(0)
    return MAKER.build(TINY, {"width": W, "height": H}, 2 ** 31 + 17, "cpu")


def _side(modules, s):
    side = sides.Side(modules, s, "cpu")
    side.opt = dataclasses.replace(side.opt, enable_mix_precision=False,
                                   **CFG["options"])
    return side


def _exposed_view(side, s, i):
    """The scene with view i's image replaced by the model's own render
    under an exposure (gain exp(0.2), bias 0.03), so that the step's SSIM
    loss is under 0.5."""
    with torch.no_grad():
        res, _ = side.m.renderer.render_view(
            side.model(), side.cams[i], side.rcfg, side.bg, src=None,
            render_geo=False, return_depth_normal=False)
    images = s.images.clone()
    images[i] = torch.clamp(res.render * math.exp(0.2) + 0.03, 0.0, 1.0)
    return dataclasses.replace(s, images=images)


def _grads_and_step(side, s, phase, i, use_app):
    t = side.m.trainer
    state = side.train_state()
    cache = {j: side.depth(state.model, j) for j in s.nearest[i][:4]}
    src = side.sources(i, cache, side.cams[i])
    ph = t.StepPhase(*phase)
    args = (side.cams[i], i, s.images[i], src, ITERATION, side.bg, use_app,
            1.0)
    total, aux, g = t.loss_and_grads(side.opt, side.rcfg, state.net, ph,
                                     state, *args)
    step = t.make_train_step(side.opt, side.rcfg, state.net, ph)
    new, aux = step(state, *args, 1e-3)
    losses = {k: float(aux[k]) for k in compare.LOSS_TERMS}
    grads = {k: getattr(g.params, k) for k in sc.PARAM_FIELDS}
    grads["app_ab"] = g.app_ab
    for (name, _), x in zip(state.net.named_parameters(), g.net):
        grads["net." + name] = x
    return losses, grads, new


@pytest.mark.parametrize("phase", [(True, True), (False, False)],
                         ids=["geometry_aggregation", "colour"])
def test_train_step_matches_the_reference(scene, phase):
    i = 3
    port = _side(sides.port_modules(), scene)
    s = _exposed_view(port, scene, i)
    port = _side(sides.port_modules(), s)
    ref = _side(sides.reference_modules(), s)
    lp, gp, sp = _grads_and_step(port, s, phase, i, use_app=True)
    lr, gr, sr = _grads_and_step(ref, s, phase, i, use_app=True)
    for k in lr:
        assert np.isfinite(lr[k])
        assert lp[k] == pytest.approx(lr[k], rel=1e-4, abs=1e-7), k
    # the exposed L1: the exposure table has a gradient (its view's row)
    assert float(gr["app_ab"].abs().sum()) > 0
    assert float(gr["app_ab"][i].abs().sum()) > 0
    moved = [k for k, v in gr.items() if float(v.abs().sum()) > 0]
    if phase[1]:
        assert {"app_ab", "net.Dense_0.weight"} <= set(moved)
    else:
        assert not any(k.startswith("net.") for k in moved)
    for k, r in gr.items():
        d = float((gp[k] - r).norm())
        assert d <= 1e-3 * float(r.norm()) + 1e-9, (k, d, float(r.norm()))
    for k in sc.PARAM_FIELDS:
        torch.testing.assert_close(getattr(sp.model.params, k),
                                   getattr(sr.model.params, k), rtol=1e-4,
                                   atol=1e-5, msg=k)
    torch.testing.assert_close(sp.app_ab, sr.app_ab, rtol=1e-4, atol=1e-6)
    # Adam moves a weight by about lr whatever its gradient's size: held
    # by the norm of the change (test_benchmark_reference's rule)
    for (name, a), b in zip(sp.net.named_parameters(),
                            sr.net.parameters()):
        moved = float((b.detach() - s.net[name]).norm())
        assert float((a - b).detach().norm()) <= 1e-2 * moved + 1e-9, name


@pytest.mark.parametrize("H,W", [(60, 72), (13, 19)])
def test_exposure_affine_matches_the_reference(H, W):
    g = torch.Generator().manual_seed(H)
    render = torch.rand(H, W, 3, generator=g, requires_grad=True)
    mask = torch.rand(H, W, generator=g) < 0.7
    first = (0.8 * render.detach() + 0.1
             + 0.01 * torch.rand(H, W, 3, generator=g)) * mask[..., None]
    out, A = exposure.exposure_affine(render, first, mask)
    ref = render.detach().clone().requires_grad_(True)
    out_r, A_r = ragg.exposure_affine(ref, first, mask)
    torch.testing.assert_close(out, out_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(A, A_r, rtol=1e-5, atol=1e-6)
    # the fitted gain is the planted one
    assert torch.allclose(torch.diagonal(A[:, :3]), torch.full((3,), 0.8),
                          atol=0.02)
    ct = torch.rand(H, W, 3, generator=g)
    (gp,) = torch.autograd.grad(out, render, ct)
    (gr,) = torch.autograd.grad(out_r, ref, ct)
    torch.testing.assert_close(gp, gr, rtol=1e-5, atol=1e-6)
    assert aggregation.exposure_affine is exposure.exposure_affine


def test_neighbour_order_matches_the_data_layer():
    views = MAKER.PROD.ring_views(int(CFG["views"]), float(CFG["cam_radius"]))
    train = [v for k, v in enumerate(views) if k % CFG["eval_every"]]
    test = [v for k, v in enumerate(views) if k % CFG["eval_every"] == 0]
    poses = MAKER.pose_arrays(train)
    q_test = MAKER.pose_arrays(test)
    ncfg = dict(CFG["multi_view"])
    assert ncfg["exposure_reorder"] is True
    for q in (poses, q_test):
        got = MAKER.neighbor_ids(*poses, *q, ncfg)
        want = dataset._neighbor_ids(*poses, *q, ncfg)
        assert got == want
        assert all(len(n) >= 4 for n in got)
    # the reordering moves a source: the rule is not the plain order
    plain = dataset._neighbor_ids(*poses, *poses,
                                  dict(ncfg, exposure_reorder=False))
    assert plain != MAKER.neighbor_ids(*poses, *poses, ncfg)


def _tiny_run(cell: str, seed: int = 2 ** 31 + 101):
    w = harness.cell(SPEC, cell)
    cfg, mod = harness.config_files(w["config"])
    traffic = dict(harness.traffic(w["traffic"]), width=W, height=H)
    build = mod.build
    if w["config"] == "tnt-2m":
        cfg = dict(cfg, gt_points=4000, seed_points=1000, capacity=1024,
                   views=8)
    else:
        def build(cfg, traffic, seed, device):
            s = mod.build(cfg, traffic, seed, device)
            keep = torch.arange(0, s.params["xyz"].shape[0], 90)
            s.params = {k: v[keep].contiguous() for k, v in
                        s.params.items()}
            s.alive = s.alive[keep]
            return s
    ctx = {"config": cfg, "config_module": type("M", (), {"build": build}),
           "traffic": traffic, "seed": seed, "seconds": 0.01,
           "trace": False, "cell": cell, "device": torch.device("cpu")}
    return harness.driver(traffic["driver"]).Run(ctx)


@pytest.mark.parametrize("cell", ["tnt-2m.train-540p",
                                  "bundle-91k.colour-1080p"])
def test_driver_sound_run_is_correct(cell, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    run = _tiny_run(cell)
    run.setup()
    rec = run.window(0.01)
    run.release()
    assert rec["failed"] == 0
    checks, detail, work = run.check(harness.limits(cell))
    for name, v, lim in checks:
        assert math.isfinite(v) and v <= lim, (name, v, lim)
    counts = {k: harness.roofline(k).count(work) for k in ("net", "warp")}
    if cell.startswith("bundle-91k.colour"):
        assert not any(k.startswith("net.") for k in detail["left_out"])
        assert counts["net"]["ops_bf16"] == 0 and counts["warp"]["ops"] == 0
        assert [b["mode"] for b in work["blends"]] == ["color"]
    else:
        assert counts["net"]["ops_bf16"] > 0 and counts["warp"]["ops"] > 0
        assert [b["mode"] for b in work["blends"]] == ["render_geo"]


def test_exposure_ms_reads_the_exposure_module():
    ctx = {"units": 4, "stacked": {"stacks": [
        [["train/trainer.py", "models/aggregation.py",
          "models/exposure.py"], 0.002],
        [["train/trainer.py", "models/aggregation.py"], 0.05],
        [["train/trainer.py", "models/exposure.py"], 0.002]]}}
    assert exposure_ms.read(ctx) == pytest.approx(1.0)
    ctx["stacked"]["stacks"] = ctx["stacked"]["stacks"][1:2]
    assert exposure_ms.read(ctx) is None
