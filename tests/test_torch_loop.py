"""The port's training driver against the JAX package's, and its
checkpoints, resume, capacity growth and CLI.

* `train(..., device="cpu")` against `ibgs_tpu.train.loop.train` with the
  oracle backend on the synthetic scene (4 views at 32x32, 300 ground-truth
  and 150 seed splats), colour-only, 10 iterations with densify events at
  4 and 8.  The port's densify noise is JAX's own draws for each event
  (`key, sub = split(key)`, then `split(sub, 3)`).  The oracle blend has
  no |dmean| columns, so JAX's absolute-gradient statistic stays 0 there;
  the port's run is given the same zero statistic, so that both rank the
  split candidates by the same priority max(g, g_abs) (each event draws
  a parent's noise by its slot).  The port's absolute gradient is held to
  the Pallas kernel in tests/test_torch_train.py.  The camera sequence and
  the alive count of every iteration agree exactly, `image_loss` to rtol
  1e-3.  Slot order after a densify can differ where two candidates'
  gradients differ by rounding, so the run compares counts; the slot for
  slot check is tests/test_torch_densify.py's.  The JAX run's checkpoint
  at 10 then resumes in the port's `train` for 2 iterations.
* A port-only run of 8 iterations through geometry rendering and colour
  aggregation, with densify events, an opacity reset, a PLY snapshot, an
  evaluation and a checkpoint at 6, then a resume from it: the checkpoint
  loads bit for bit, the resumed steps are finite, and the rebuilt depth
  cache holds every view.
* Capacity growth before a densify (160 → 320 slots, "(pre-densify)").
* `convert.train_state_from_jax_checkpoint` on a state written by
  `ibgs_tpu.train.checkpoint.save_state`, with and without the fusion net,
  field by field.
* The CLI, `python -m ibgs_tpu_torch.train --synthetic ... --device cpu`,
  in process.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu import config as jconfig
from ibgs_tpu.data import synthetic as jsyn
from ibgs_tpu.models import aggregation as jagg
from ibgs_tpu.models import gaussians as jg
from ibgs_tpu.train import checkpoint as jckpt
from ibgs_tpu.train import loop as jloop
from ibgs_tpu.train import trainer as jtr
from ibgs_tpu_torch import config as tconfig
from ibgs_tpu_torch import convert
from ibgs_tpu_torch.data import synthetic as tsyn
from ibgs_tpu_torch.models import gaussians as tg
from ibgs_tpu_torch.train import __main__ as tcli
from ibgs_tpu_torch.train import checkpoint as tckpt
from ibgs_tpu_torch.train import loop as tloop
from ibgs_tpu_torch.train import trainer as ttr
from tests.test_torch_densify import _jax_noise
from tests.test_torch_slice import one_torch_thread  # noqa: F401

SCENE = dict(n_views=4, width=32, height=32, n_gt=300, n_seed=150)
COLOR_ONLY = dict(iterations=10, densify_from_iter=2,
                  densification_interval=4, densify_until_iter=10,
                  use_color_aggregation=False,
                  single_view_weight_from_iter=10_000,
                  multi_view_weight_from_iter=10_000)


def _log(path):
    with open(os.path.join(path, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _recording(make_step, cams):
    """make_train_step whose steps append their camera index to `cams`."""
    def make(*a, **k):
        step = make_step(*a, **k)

        def recorded(state, cam, cam_uid, *rest):
            cams.append(int(cam_uid))
            return step(state, cam, cam_uid, *rest)
        return recorded
    return make


def test_loop_matches_jax(tmp_path, monkeypatch):
    jcams, tcams = [], []
    monkeypatch.setattr(jloop, "make_train_step",
                        _recording(jloop.make_train_step, jcams))
    monkeypatch.setattr(tloop, "make_train_step",
                        _recording(tloop.make_train_step, tcams))
    key = [jax.random.PRNGKey(24)]

    def jax_draws(gen, capacity, device):
        key[0], sub = jax.random.split(key[0])
        return torch.as_tensor(_jax_noise(sub, capacity)).to(device)

    monkeypatch.setattr(tg, "densify_noise", jax_draws)
    accumulate = ttr.accumulate_stats
    monkeypatch.setattr(ttr, "accumulate_stats", lambda m, g, g_abs, *a:
                        accumulate(m, g, torch.zeros_like(g_abs), *a))

    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jloop.train(jsyn.make_synthetic_scene(**SCENE), jconfig.ModelParams(),
                jconfig.OptimizationParams(**COLOR_ONLY),
                jconfig.PipelineParams(backend="oracle",
                                       instance_cap=1 << 12),
                jpath, save_iterations=(), test_iterations=(),
                checkpoint_iterations=(10,), log_every=1, quiet=True)
    tloop.train(tsyn.make_synthetic_scene(device="cpu", **SCENE),
                tconfig.ModelParams(), tconfig.OptimizationParams(
                    **COLOR_ONLY), tconfig.PipelineParams(),
                tpath, save_iterations=(), test_iterations=(), log_every=1,
                quiet=True, device="cpu")
    assert len(tcams) == 10 and tcams == jcams
    jlog, tlog = _log(jpath), _log(tpath)
    assert [m["iter"] for m in tlog] == list(range(1, 11))
    assert [m["points"] for m in tlog] == [m["points"] for m in jlog]
    assert tlog[-1]["points"] > tlog[0]["points"] == 150
    np.testing.assert_allclose([m["image_loss"] for m in tlog],
                               [m["image_loss"] for m in jlog], rtol=1e-3)
    with open(os.path.join(tpath, "densify_log.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert [e["iter"] for e in events] == [4, 8]
    for name in ("multi_view.json",):
        assert (open(os.path.join(jpath, name), "rb").read()
                == open(os.path.join(tpath, name), "rb").read())

    # the JAX run's checkpoint resumes in the port
    rpath = str(tmp_path / "resumed")
    tloop.train(tsyn.make_synthetic_scene(device="cpu", **SCENE),
                tconfig.ModelParams(), tconfig.OptimizationParams(
                    **dict(COLOR_ONLY, iterations=12)),
                tconfig.PipelineParams(), rpath, save_iterations=(),
                test_iterations=(), log_every=1, quiet=True, device="cpu",
                start_checkpoint=os.path.join(jpath, "chkpnt10.npz"))
    rlog = _log(rpath)
    assert [m["iter"] for m in rlog] == [11, 12]
    assert rlog[0]["points"] == jlog[-1]["points"]
    assert all(math.isfinite(m["image_loss"]) for m in rlog)


def _assert_states_equal(a, b):
    """Every tensor of two port TrainStates torch.equal, and the host
    values equal."""
    ta, tb = tckpt.state_arrays(a), tckpt.state_arrays(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    for f in tg.PARAM_FIELDS:
        for tree in ("params", "mu", "nu"):
            assert torch.equal(getattr(getattr(a.model, tree), f),
                               getattr(getattr(b.model, tree), f))


def test_geometry_aggregation_checkpoint_and_resume(tmp_path):
    scene = tsyn.make_synthetic_scene(device="cpu", **SCENE)
    opt = tconfig.OptimizationParams(
        iterations=8, densify_from_iter=2, densification_interval=3,
        densify_until_iter=8, opacity_reset_interval=6,
        single_view_weight_from_iter=7, multi_view_weight_from_iter=7,
        start_color_aggregation_iter=4, color_aggregate_burnin_steps=2,
        number_src_frames=2)
    path = str(tmp_path / "run")
    kw = dict(save_iterations=(8,), test_iterations=(8,),
              checkpoint_iterations=(6,), log_every=1, quiet=True,
              device="cpu")
    state, stacks = tloop.train(scene, tconfig.ModelParams(), opt,
                                tconfig.PipelineParams(), path, **kw)
    log = _log(path)
    assert [m["iter"] for m in log] == list(range(1, 9))
    assert all(math.isfinite(m[k]) for m in log for k in tloop.LOSS_KEYS)
    assert all(m["nonfinite_grads"] == 0 for m in log)
    # geometry from iteration 2 (7 - 2·3 views), aggregation from 5
    assert log[-1]["agg_loss"] != 0.0 and log[0]["normal_loss"] == 0.0
    assert os.path.exists(os.path.join(path, "point_cloud", "iteration_8",
                                       "point_cloud.ply"))
    assert (stacks["depths"].flatten(1).amax(1) > 0).all()
    assert state.model.step == 8

    ck = os.path.join(path, "chkpnt6.npz")
    loaded, it = tckpt.load_state(state, ck)
    assert it == 6 and loaded.model.step == 6
    again = str(tmp_path / "again.npz")
    tckpt.save_state(loaded, 6, again)
    reread, _ = tckpt.load_state(state, again)
    _assert_states_equal(loaded, reread)
    with np.load(ck) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # resume at 7: the depth cache is rebuilt, then 2 finite steps
    rpath = str(tmp_path / "resume")
    kw.update(start_checkpoint=ck, checkpoint_iterations=(),
              save_iterations=(), test_iterations=())
    rstate, rstacks = tloop.train(scene, tconfig.ModelParams(), opt,
                                  tconfig.PipelineParams(), rpath, **kw)
    rlog = _log(rpath)
    assert [m["iter"] for m in rlog] == [7, 8]
    assert all(math.isfinite(m[k]) for m in rlog for k in tloop.LOSS_KEYS)
    assert (rstacks["depths"].flatten(1).amax(1) > 0).all()
    assert rstate.model.step == 8


def test_capacity_grows_before_densify(tmp_path, capsys):
    scene = tsyn.make_synthetic_scene(device="cpu", **SCENE)
    opt = tconfig.OptimizationParams(
        iterations=4, densify_from_iter=1, densification_interval=2,
        densify_until_iter=4, opacity_reset_interval=10_000,
        use_color_aggregation=False, single_view_weight_from_iter=10_000,
        multi_view_weight_from_iter=10_000, number_src_frames=2,
        position_lr_max_steps=10, densify_grad_threshold=1e9,
        densify_abs_grad_threshold=1e9)
    # 150 alive seeds in 160 slots: 93.75% occupancy at the event
    state, _ = tloop.train(scene, tconfig.ModelParams(sh_degree=1,
                                                      init_capacity=160),
                           opt, tconfig.PipelineParams(), str(tmp_path),
                           save_iterations=(), log_every=10, quiet=True,
                           device="cpu")
    out = capsys.readouterr().out
    assert "capacity -> 320 (pre-densify)" in out, out
    assert state.model.capacity == 320
    assert int(state.model.alive.sum()) >= 1
    assert tg.grow_capacity(state.model, 640).capacity == 640


def _random_tree(tree, r):
    return jax.tree.map(
        lambda x: jnp.asarray(r.normal(size=np.shape(x)).astype(np.float32)),
        tree)


@pytest.mark.parametrize("with_net", [True, False])
def test_train_state_from_jax_checkpoint(with_net, tmp_path):
    r = np.random.default_rng(4)
    P = 64
    m = jg.init_from_points(r.normal(size=(40, 3)).astype(np.float32),
                            r.uniform(size=(40, 3)).astype(np.float32), 2,
                            capacity=P)
    m = m.replace(params=_random_tree(m.params, r), mu=_random_tree(m.mu, r),
                  nu=_random_tree(m.nu, r), step=jnp.int32(31),
                  active_sh_degree=jnp.int32(1),
                  alive=jnp.asarray(r.uniform(size=P) < 0.6),
                  **{k: jnp.asarray(r.uniform(size=P).astype(np.float32))
                     for k in tg.STAT_FIELDS})
    net = net_params = net_opt = None
    if with_net:
        net = jagg.ColorFusionResidualNet()
        net_params = _random_tree(net.init(
            jax.random.PRNGKey(0), jnp.zeros((4, 4, 3, 7)),
            jnp.zeros((4, 4, 3)), jnp.zeros((4, 4, 3))), r)
        net_opt = jtr.SideOptState(mu=_random_tree(net_params, r),
                                   nu=_random_tree(net_params, r),
                                   step=jnp.int32(9))
    app = jnp.asarray(r.normal(size=(1600, 2)).astype(np.float32))
    js = jtr.TrainState(
        model=m, app_ab=app, app_opt=jtr.SideOptState(
            mu=app * 2, nu=app * 3, step=jnp.int32(5)),
        net_params=net_params, net_opt=net_opt,
        spatial_lr_scale=jnp.float32(2.5))
    path = str(tmp_path / "chkpnt12.npz")
    jckpt.save_state(js, 12, path)

    port_net = None
    if with_net:
        port_net = convert.fusion_net_from_flax(
            jax.tree.map(np.asarray, net_params), device="cpu")
    ts, it = convert.train_state_from_jax_checkpoint(path, port_net,
                                                     device="cpu")
    assert it == 12
    tm = ts.model
    assert tm.step == 31 and tm.active_sh_degree == 1
    assert tm.max_sh_degree == 2
    np.testing.assert_array_equal(tm.alive.numpy(), np.asarray(m.alive))
    for tree in ("params", "mu", "nu"):
        for k in tg.PARAM_FIELDS:
            np.testing.assert_array_equal(
                getattr(getattr(tm, tree), k).numpy(),
                np.asarray(getattr(getattr(m, tree), k)),
                err_msg=f"{tree}.{k}")
    for k in tg.STAT_FIELDS:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(m, k)), err_msg=k)
    np.testing.assert_array_equal(ts.app_ab.numpy(), np.asarray(app))
    np.testing.assert_array_equal(ts.app_opt.mu[0].numpy(),
                                  np.asarray(app * 2))
    np.testing.assert_array_equal(ts.app_opt.nu[0].numpy(),
                                  np.asarray(app * 3))
    assert ts.app_opt.step == 5
    assert ts.spatial_lr_scale == 2.5
    if not with_net:
        assert ts.net is None and ts.net_opt is None
        return
    want = port_net.state_dict()
    for k, v in ts.net.state_dict().items():
        assert torch.equal(v, want[k]), k
    for moments, got in ((net_opt.mu, ts.net_opt.mu),
                         (net_opt.nu, ts.net_opt.nu)):
        want = list(convert.fusion_net_from_flax(
            jax.tree.map(np.asarray, moments), device="cpu").parameters())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w.detach())
    assert ts.net_opt.step == 9
    # a port checkpoint of the converted state round-trips
    tckpt.save_state(ts, 12, str(tmp_path / "port.npz"))
    back, _ = tckpt.load_state(ts, str(tmp_path / "port.npz"))
    _assert_states_equal(ts, back)


def test_cli_trains_on_the_synthetic_scene(tmp_path):
    out = str(tmp_path / "cli")
    assert tcli.main(["--synthetic", "--synthetic_spec", "4", "32", "32",
                      "300", "150", "--iterations", "3", "--device", "cpu",
                      "-m", out, "--quiet"]) == 0
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_3",
                                       "point_cloud.ply"))
    assert os.path.exists(os.path.join(out, "cfg_args.json"))
    log = _log(out)
    assert log and log[0]["iter"] == 1
    assert all(math.isfinite(m["image_loss"]) for m in log)


def test_config_surface_matches_jax(tmp_path):
    """Every JAX flag but `backend` exists in the port with the JAX
    default, apart from the caps (0: exact-size lists); `load_combined`
    merges a saved config with the command line as JAX's does."""
    jp, tp = jconfig.build_parser("j"), tconfig.build_parser("t")
    jd, td = vars(jp.parse_args([])), vars(tp.parse_args([]))
    assert set(jd) - set(td) == {"backend"} and set(td) <= set(jd)
    diff = {k for k in td if td[k] != jd[k]}
    assert diff == {"instance_cap"} and td["instance_cap"] == 0
    argv = ["-m", str(tmp_path), "--iterations", "77", "--eval",
            "--color_aggregation_reduce_lr_iter", "5", "6"]
    tconfig.save_config(tp.parse_args(argv), str(tmp_path))
    got = tconfig.load_combined(tconfig.build_parser("t"),
                                ["-m", str(tmp_path), "--sh_degree", "1"])
    want = jconfig.load_combined(jconfig.build_parser("j"),
                                 ["-m", str(tmp_path), "--sh_degree", "1"])
    assert got.iterations == want.iterations == 77
    assert got.sh_degree == want.sh_degree == 1 and got.eval and want.eval
    assert got.color_aggregation_reduce_lr_iter == [5, 6]
    assert tconfig.extract(got, tconfig.OptimizationParams).iterations == 77


def test_profiling_trace_and_depth_colours(tmp_path):
    from ibgs_tpu.train.logging import colorize_depth as jcolor
    from ibgs_tpu_torch.train.logging import colorize_depth as tcolor
    from ibgs_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path)):
        for it in (1, 2):
            with profiling.annotate("train_step", it):
                torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train_step#1", "train_step#2"} <= names
    with profiling.trace(""):        # no directory: no trace
        pass

    depth = np.random.default_rng(0).uniform(0, 4, (12, 16)).astype(
        np.float32)
    depth[:3] = 0.0
    np.testing.assert_array_equal(tcolor(torch.as_tensor(depth)),
                                  jcolor(depth))
