"""The port's maintenance cadence (`train/maintenance.maintain`) against
the plain reference of the benchmark (`benchmark/reference/densify.py`),
and the training loop through it.

* `maintain` after iteration `it` against the reference's `event` from
  the same seeded random state at P = 4,096, with the same noise draws
  (the generator's state before the event): the alive mask exactly, the
  event's record (alive before and after, clones, splits, prunes,
  capacity before and after) exactly, every field of the parameters and
  both Adam moments exactly but the positions, which lie within 1e-6
  (the sampled offset R·(ε ⊙ scale) is summed in another order: a few
  float32 ulps of offsets under 4 here), and the statistics zero.  Cases:
  a plain event, a slot-starved one (the highest gradients win the free
  slots), the abs-split budget binding, the `max_screen` prunes after the
  first opacity reset, a growth before the densify above 90% occupancy,
  one after it, and an event on the opacity reset's interval.
* The cell's gaps (`benchmark/drivers/densify.gaps`) over such a state
  read 0 for the sound event and above the cell's limits for each planted
  fault (tests/torch_densify_faults.py).
* `loop.train` on the synthetic scene, with densify events, growths
  before and after a densify and an opacity reset, writes the same model
  (every tensor equal) and the same densify_log.jsonl and events.jsonl
  records as the cadence that was inline in the loop with the index
  scatter it used (both transcribed below).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import config as rconfig
from benchmark.reference import densify as rd
from ibgs_tpu_torch import config as tconfig
from ibgs_tpu_torch.data import synthetic as tsyn
from ibgs_tpu_torch.models import gaussians as tg
from ibgs_tpu_torch.train import loop as tloop
from ibgs_tpu_torch.train import maintenance
from ibgs_tpu_torch.train import trainer as ttr
from tests.test_torch_slice import one_torch_thread  # noqa: F401
import torch_densify_faults as faults

P = 4096
CELL = "prod-1m.densify-544p"
OPTIONS = harness.traffic("densify-544p")["options"]
EXTENT = 1.7
XYZ_TOL = 1e-6

# case: (alive count, iteration, gradient scale, option overrides); the
# absolute gradients at 2.5x the gradient scale but in abs_budget
CASES = {
    "plain": (2000, 600, 1.0, {}),
    "starved": (3600, 600, 4.0, dict(max_all_points=P)),
    "abs_budget": (2000, 600, 0.3, dict(max_abs_split_points=10)),
    "max_screen": (2000, 7100, 1.0, {}),
    "grow_before": (3700, 600, 1.0, {}),
    "grow_after": (3500, 600, 0.6, {}),
    "reset": (2000, 6000, 1.0, {}),
}


def _arrays(seed, n_alive, gscale, abs_scale):
    """A seeded random state (the reference's dict layout): small and
    large splats, gradients around the cell's thresholds."""
    r = np.random.default_rng(seed)
    alive = np.zeros(P, bool)
    alive[r.choice(P, n_alive, replace=False)] = True
    big = r.uniform(size=P) < 0.4
    f = {k: r.normal(size=s).astype(np.float32) for k, s in dict(
        xyz=(P, 3), sh_dc=(P, 1, 3), sh_rest=(P, 8, 3), quat=(P, 4),
        normal=(P, 3), offset=(P, 1)).items()}
    f["log_scale"] = np.where(big[:, None], r.uniform(-3.5, 0.0, (P, 3)),
                              r.uniform(-9.0, -7.0, (P, 3)))
    f["opacity_logit"] = r.normal(0.0, 2.0, (P, 1))
    state = {"params": {k: torch.as_tensor(v.astype(np.float32))
                        for k, v in f.items()}}
    for t in ("mu", "nu"):
        state[t] = {k: torch.as_tensor(np.abs(r.normal(
            size=v.shape)).astype(np.float32)) for k, v in f.items()}
    denom = r.integers(0, 8, P).astype(np.float32)
    state.update(
        alive=torch.as_tensor(alive),
        denom=torch.as_tensor(denom), denom_abs=torch.as_tensor(denom),
        grad_accum=torch.as_tensor((r.uniform(0, 1.6e-4 * gscale, P)
                                    * denom).astype(np.float32)),
        grad_accum_abs=torch.as_tensor((r.uniform(0, 1.6e-4 * abs_scale, P)
                                        * denom).astype(np.float32)),
        max_radii2d=torch.as_tensor(r.uniform(0, 60, P).astype(np.float32)))
    return state


def _train_state(a):
    tree = {t: tg.GaussianParams(**{k: a[t][k].clone() for k in rd.FIELDS})
            for t in rd.TREES}
    model = tg.GaussianModel(alive=a["alive"].clone(), active_sh_degree=2,
                             max_sh_degree=2, step=7,
                             **{k: a[k].clone() for k in rd.STATS}, **tree)
    app = torch.zeros(ttr.APP_CAPACITY, 2)
    return ttr.TrainState(model=model, app_ab=app,
                          app_opt=ttr.SideOptState.init([app]), net=None,
                          net_opt=None, spatial_lr_scale=EXTENT)


def _after(state) -> dict:
    m = state.model
    out = {t: {k: getattr(getattr(m, t), k) for k in rd.FIELDS}
           for t in rd.TREES}
    out["alive"] = m.alive
    for k in rd.STATS:
        out[k] = getattr(m, k)
    return out


def _both(case, seed=0):
    """(the port's state and record after `maintain`, the reference's)."""
    n_alive, it, gscale, over = CASES[case]
    a = _arrays(seed + list(CASES).index(case), n_alive, gscale,
                4.0 if case == "abs_budget" else 2.5 * gscale)
    topt = tconfig.OptimizationParams(**dict(OPTIONS, **over))
    ropt = rconfig.OptimizationParams(**dict(OPTIONS, **over))
    gen = torch.Generator().manual_seed(5)
    start = gen.get_state()
    state, rec = maintenance.maintain(_train_state(a), it, topt, gen, EXTENT)

    def draw(cap):
        return torch.randn((3, cap, 3),
                           generator=torch.Generator().set_state(start))

    ref, rrec = rd.event(a, it, ropt, EXTENT, draw)
    return a, _after(state), rec, ref, rrec


@pytest.mark.parametrize("case", list(CASES))
def test_maintain_matches_the_reference(case):
    before = dict(maintenance.COUNTERS)
    a, got, rec, ref, rrec = _both(case)
    assert torch.equal(got["alive"], ref["alive"])
    for t in rd.TREES:
        for k in rd.FIELDS:
            x, y = got[t][k], ref[t][k]
            if t == "params" and k == "xyz":
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                           atol=XYZ_TOL, err_msg=k)
            else:
                assert torch.equal(x, y), f"{t}.{k}"
    for k in rd.STATS:
        assert not got[k].any(), k
    assert {k: rec[k] for k in rrec} == rrec
    assert maintenance.COUNTERS["events"] == before["events"] + 1
    for k in ("cloned", "split", "pruned"):
        assert maintenance.COUNTERS[k] == before[k] + rec[k]

    # what each case is meant to reach
    n0 = int(a["alive"].sum())
    grows = rec["grows"]
    assert len(grows) == maintenance.COUNTERS["grows"] - before["grows"]
    if case == "starved":
        # the clones alone outnumber the free slots: none is left to split
        assert rec["cloned"] == P - n0 and rec["split"] == 0
        assert not grows
        return
    if case == "abs_budget":
        # no gradient reaches the threshold: the budget's 10 are the splits
        assert rec["cloned"] == 0 and rec["split"] == 10
        return
    assert rec["cloned"] > 0 and rec["split"] > 0
    if case == "plain":
        assert not grows
    elif case == "max_screen":
        assert rec["pruned"] > int((a["alive"] & (torch.sigmoid(
            a["params"]["opacity_logit"][:, 0]) < 0.05)).sum())
    elif case == "grow_before":
        assert grows == [dict(old=P, new=2 * P, pre_densify=True)]
        assert rec["capacity"] == 2 * P
    elif case == "grow_after":
        assert n0 <= 0.9 * P < rec["n_alive_after"]
        assert grows == [dict(old=P, new=2 * P, pre_densify=False)]
    elif case == "reset":
        assert float(torch.sigmoid(got["params"]["opacity_logit"]).max()) \
            <= 0.01 + 1e-7
        assert not got["mu"]["opacity_logit"].any()


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_cell_gaps_catch_planted_faults(fault):
    drv = harness.driver("densify")
    limits = harness.limits(CELL)
    _, got, _, ref, _ = _both("max_screen", seed=40)
    alive_gap, param_gap, _ = drv.gaps(got, ref)
    assert alive_gap == 0.0 and param_gap <= XYZ_TOL
    with faults.planted(fault):
        _, bad, _, ref, _ = _both("max_screen", seed=40)
    alive_gap, param_gap, at = drv.gaps(bad, ref)
    assert (alive_gap > limits["densify_alive_gap"]
            or param_gap > limits["densify_param_gap"]), (alive_gap,
                                                          param_gap, at)


# ---------------------------------------------------------- the loop

def _index_scatter(model, src, target, granted):
    """The index scatter the cadence used before (a row count read back
    by `nonzero`)."""
    rows = granted.nonzero().squeeze(1)
    dst = target[rows]

    def put(d, s):
        d = d.clone()
        d[dst] = s[rows]
        return d

    def zero(m):
        m = m.clone()
        m[dst] = 0.0
        return m

    alive = model.alive.clone()
    alive[dst] = True
    return dataclasses.replace(
        model, params=tg._map_params(put, model.params, src),
        mu=tg._map_params(zero, model.mu), nu=tg._map_params(zero, model.nu),
        alive=alive)


def _inline_cadence(state, it, opt, gen, extent, white_background=False,
                    pool=None):
    """The maintenance as the loop ran it inline (one device): a growth
    by `maybe_grow` reading the alive count, the count before, the
    densify, the count after, a growth, the reset, the decay."""
    grows = []

    def grow(model, pre):
        cap = model.capacity
        model, newcap = ttr.maybe_grow(model, opt.max_all_points)
        if newcap is not None:
            grows.append(dict(old=cap, new=newcap, pre_densify=pre))
        return model

    rec = None
    if it < opt.densify_until_iter:
        if (it > opt.densify_from_iter
                and it % opt.densification_interval == 0):
            max_screen = (20.0 if it > opt.opacity_reset_interval else None)
            model = grow(state.model, True)
            n_before = int(model.alive.sum())
            model, _ = ttr.densify_step(model, gen,
                                        maintenance.densify_config(opt),
                                        extent, max_screen=max_screen)
            n_after = int(model.alive.sum())
            model = grow(model, False)
            state = dataclasses.replace(state, model=model)
            rec = dict(iter=it, ms=0.0, n_alive_before=n_before,
                       n_alive_after=n_after, capacity=model.capacity,
                       grows=grows)
        if it % opt.opacity_reset_interval == 0 or (
                white_background and it == opt.densify_from_iter):
            state = dataclasses.replace(
                state, model=tg.reset_opacity(state.model))
        if (0 < opt.opacity_decay < 1
                and it % opt.opacity_decay_interval == 0
                and it > opt.densify_from_iter):
            state = dataclasses.replace(state, model=tg.decay_opacity(
                state.model, opt.opacity_decay))
    return state, rec


def _read(path, name):
    with open(os.path.join(path, name)) as f:
        return [json.loads(line) for line in f]


def test_loop_cadence_matches_the_inline_cadence(tmp_path, monkeypatch):
    scene = tsyn.make_synthetic_scene(n_views=4, width=32, height=32,
                                      n_gt=300, n_seed=150, device="cpu")
    opt = tconfig.OptimizationParams(
        iterations=10, densify_from_iter=2, densification_interval=2,
        densify_until_iter=10, opacity_reset_interval=6,
        opacity_decay=0.9, opacity_decay_interval=3,
        densify_grad_threshold=1e-5, densify_abs_grad_threshold=1e-5,
        use_color_aggregation=False, single_view_weight_from_iter=10_000,
        multi_view_weight_from_iter=10_000)

    def run(path):
        state, _ = tloop.train(
            scene, tconfig.ModelParams(init_capacity=160), opt,
            tconfig.PipelineParams(), str(path), save_iterations=(),
            test_iterations=(), log_every=1, quiet=True, device="cpu")
        return (state.model, _read(path, "densify_log.jsonl"),
                _read(path, "events.jsonl"))

    got, got_log, got_events = run(tmp_path / "now")
    monkeypatch.setattr(maintenance, "maintain", _inline_cadence)
    monkeypatch.setattr(tg, "_scatter_from", _index_scatter)
    want, want_log, want_events = run(tmp_path / "inline")

    assert got.capacity == want.capacity > 160
    assert torch.equal(got.alive, want.alive)
    for t in rd.TREES:
        for k in rd.FIELDS:
            assert torch.equal(getattr(getattr(got, t), k),
                               getattr(getattr(want, t), k)), f"{t}.{k}"
    for k in rd.STATS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.step == want.step == 10
    assert [e["iter"] for e in got_log] == [4, 6, 8]
    for g, w in zip(got_log, want_log):
        assert {k: g[k] for k in w if k != "ms"} == \
            {k: w[k] for k in w if k != "ms"}
        assert g["cloned"] + g["split"] - g["pruned"] == \
            g["n_alive_after"] - g["n_alive_before"]
    assert got_events == want_events
    assert any(e["event"] == "capacity" and e["pre_densify"]
               for e in got_events)
