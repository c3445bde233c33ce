"""The port's training step against the JAX package.

* The optimiser helpers (`expon_lr`, `lr_tree`, `adam_step`, `side_adam`,
  `accumulate_stats`) on identical inputs, 1e-6.
* `loss_and_grads` against `jax.grad` of `renderer.render_view` (oracle
  backend, staircase binning) followed by `trainer.ibgs_objective`, on the
  4k-splat 120x68 subset of tests/test_torch_slice.py, in both phases,
  burned in and not, with the exposure switch both ways.  The loss and
  the aux scalars agree to 1e-4; the gradients of every GaussianParams
  field, the exposure table, the net and the screen dummy to rtol 1e-3 /
  atol 1e-4 x max |field|.  The JAX gradient is taken op by op, not under
  `jax.jit`: compiled, XLA moves one Gaussian's plane-offset gradient of
  this scene by 14% (1.3717e-05 against 1.5948e-05 eager; the port gives
  1.5948e-05), while ulp-level input noise moves the eager value by 3e-4.
  The reference's `pack_rows` segment sums are taken exactly here
  (`jax.ops.segment_sum` in its backward, forward unchanged): its float32
  cumsum-difference keeps an error of an ulp of the running sum, 4.6e-8
  on one Gaussian's conic gradient of this scene whose exact value is
  -7.556e-06, which reaches 1.9e-4 x max |field| in the quaternion
  gradient (the port sums in float64: 1.4e-8).  `pack_rows`' own VJP is
  held to JAX's in tests/test_torch_binning.py.  The oracle blend has no
  |dmean| columns, so the abs dummy's gradient is held to the Pallas
  kernel in interpret mode in one case (same tolerance).
* Three port steps on that scene: the loss is finite and falls.

Adam is scale-free on its first step (a gradient near 0 of the other
sign moves a parameter by 2·lr), so parameters after a step are not
compared: the gradients and the update rules are.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu import config as jconfig
from ibgs_tpu.core import camera as jcam
from ibgs_tpu.models import aggregation as jagg
from ibgs_tpu.models import gaussians as jg
from ibgs_tpu.ops import binning as jbin
from ibgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ibgs_tpu.renderer import (render_depth_view, render_view,
                               source_views_from_stacks)
from ibgs_tpu.train import trainer as jtr
from ibgs_tpu_torch import convert
from ibgs_tpu_torch.config import OptimizationParams
from ibgs_tpu_torch.models import gaussians as tg
from ibgs_tpu_torch.ops.rasterize import RasterConfig
from ibgs_tpu_torch.renderer import source_views_from_stacks as t_src_views
from ibgs_tpu_torch.train import trainer as ttr
from tests.test_torch_slice import (CAP, H, W, _bundle, _jax_model,
                                    one_torch_thread)  # noqa: F401

FIELDS = convert.PARAM_FIELDS


def _tree(x):
    return jax.tree.map(np.asarray, x)


# ---------------------------------------------------------------- helpers

def test_expon_lr_and_lr_tree():
    cfg = jg.LRConfig()
    for step in (0.0, 1.0, 777.0, 13000.0, 29999.0, 40000.0):
        want = float(jg.expon_lr(jnp.float32(step), jnp.float32(1.6e-4),
                                 jnp.float32(1.6e-6), 30000))
        got = tg.expon_lr(step, 1.6e-4, 1.6e-6, 30000)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        jl = jg.lr_tree(cfg, jnp.float32(step), jnp.float32(2.7))
        tl = tg.lr_tree(tg.LRConfig(), step, 2.7)
        for k in FIELDS:
            np.testing.assert_allclose(getattr(tl, k),
                                       float(getattr(jl, k)), rtol=1e-6,
                                       err_msg=k)
    np.testing.assert_allclose(
        tg.expon_lr(500, 1e-2, 1e-4, 1000, delay_mult=0.1, delay_steps=800),
        float(jg.expon_lr(jnp.float32(500), 1e-2, 1e-4, 1000, 0.1, 800)),
        rtol=1e-6)


def _rand_params(r, P, K=9):
    shapes = dict(xyz=(P, 3), sh_dc=(P, 1, 3), sh_rest=(P, K - 1, 3),
                  log_scale=(P, 3), quat=(P, 4), opacity_logit=(P, 1),
                  normal=(P, 3), offset=(P, 1))
    return {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def test_adam_step_and_accumulate_stats():
    r = np.random.default_rng(0)
    P = 64
    p, m, g = (_rand_params(r, P) for _ in range(3))
    v = {k: np.abs(x) for k, x in _rand_params(r, P).items()}
    alive = r.uniform(size=P) < 0.8
    lrs = {k: float(r.uniform(1e-4, 1e-2)) for k in FIELDS}
    jm = jg.init_from_points(np.zeros((4, 3), np.float32),
                             np.zeros((4, 3), np.float32), 2, capacity=P)
    jm = jm.replace(params=jg.GaussianParams(**p), mu=jg.GaussianParams(**m),
                    nu=jg.GaussianParams(**v), step=jnp.int32(4),
                    alive=jnp.asarray(alive))
    jout = jg.adam_step(jm, jg.GaussianParams(**g), jg.GaussianParams(**lrs))
    tm = dataclasses.replace(
        convert.train_state_from_numpy(p, mu=m, nu=v, step=4,
                                       device="cpu").model,
        alive=torch.as_tensor(alive))
    tout = tg.adam_step(tm, tg.GaussianParams(
        **{k: torch.as_tensor(x) for k, x in g.items()}),
        tg.GaussianParams(**lrs))
    assert tout.step == int(jout.step) == 5
    for tree in ("params", "mu", "nu"):
        for k in FIELDS:
            np.testing.assert_allclose(
                getattr(getattr(tout, tree), k).numpy(),
                np.asarray(getattr(getattr(jout, tree), k)), rtol=1e-6,
                atol=1e-6, err_msg=f"{tree}.{k}")

    sg, sa = r.normal(size=(P, 2)), np.abs(r.normal(size=(P, 2)))
    radii = r.integers(0, 4, P).astype(np.int32)
    stats = dict(max_radii2d=r.uniform(0, 3, P), grad_accum=r.uniform(size=P),
                 grad_accum_abs=r.uniform(size=P), denom=r.integers(0, 5, P),
                 denom_abs=r.integers(0, 5, P))
    stats = {k: x.astype(np.float32) for k, x in stats.items()}
    jout = jg.accumulate_stats(
        jm.replace(**{k: jnp.asarray(x) for k, x in stats.items()}),
        jnp.asarray(sg, jnp.float32), jnp.asarray(sa, jnp.float32),
        jnp.asarray(radii), 120, 68)
    tout = tg.accumulate_stats(
        dataclasses.replace(tm, **{k: torch.as_tensor(x)
                                   for k, x in stats.items()}),
        torch.as_tensor(sg, dtype=torch.float32),
        torch.as_tensor(sa, dtype=torch.float32), torch.as_tensor(radii),
        120, 68)
    for k in stats:
        np.testing.assert_allclose(getattr(tout, k).numpy(),
                                   np.asarray(getattr(jout, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert tg.oneup_sh_degree(tm).active_sh_degree == 2


def test_side_adam():
    r = np.random.default_rng(1)
    shapes = [(5, 7), (3,), (2, 2, 4)]
    p, m, g = ([r.normal(size=s).astype(np.float32) for s in shapes]
               for _ in range(3))
    v = [np.abs(r.normal(size=s)).astype(np.float32) for s in shapes]
    jp, jo = jtr.side_adam(
        [jnp.asarray(x) for x in p],
        jtr.SideOptState(mu=[jnp.asarray(x) for x in m],
                         nu=[jnp.asarray(x) for x in v], step=jnp.int32(2)),
        [jnp.asarray(x) for x in g], lr=jnp.float32(1e-3), b2=0.99)
    tp, to = ttr.side_adam(
        [torch.as_tensor(x) for x in p],
        ttr.SideOptState(mu=[torch.as_tensor(x) for x in m],
                         nu=[torch.as_tensor(x) for x in v], step=2),
        [torch.as_tensor(x) for x in g], lr=1e-3, b2=0.99)
    assert to.step == 3
    for a, b in zip(tp + to.mu + to.nu, list(jp) + list(jo.mu)
                    + list(jo.nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------------ whole step

ITER_GEO, ITER_COLOR = 13000, 5000


@functools.lru_cache(maxsize=1)
def _scene():
    """Bundle subset, source depths from the JAX depth pre-pass, seeded
    exposure table and Flax net weights: the inputs both packages share."""
    d = _bundle()
    fovx, fovy = float(d["fovx"]), float(d["fovy"])
    cam = jcam.make_camera(d["cam_R"], d["cam_t"], fovx, fovy, W, H)
    views = [np.asarray(m, np.float32) @ np.asarray(cam.view)
             for m in d["src_ref_to_src"]]
    cams = [jcam.make_camera(v[:3, :3].T, v[:3, 3], fovx, fovy, W, H)
            for v in views]
    rcfg = JRasterConfig(instance_cap=CAP, row_cap=CAP, backend="oracle",
                         buffer_len=4, staircase_cull=True)
    model = _jax_model(d)
    depth_fn = jax.jit(lambda m, c: render_depth_view(m, c, rcfg))
    depths = np.stack([np.asarray(depth_fn(model, c)) for c in cams]
                      + [np.zeros((H, W), np.float32)])
    net = jagg.ColorFusionResidualNet()
    net_params = _tree(net.init(jax.random.PRNGKey(0),
                                jnp.zeros((8, 8, 3, 7)), jnp.zeros((8, 8, 3)),
                                jnp.zeros((8, 8, 3))))
    r = np.random.default_rng(5)
    app_ab = (r.normal(size=(ttr.APP_CAPACITY, 2)) * 0.05).astype(np.float32)
    return d, views, depths, net, net_params, app_ab


@jax.custom_vjp
def _pack_rows_exact(feats_g, bins):
    """jbin.pack_rows with an exact segment-sum backward."""
    out = feats_g[bins.order][bins.rank]
    return jnp.where(bins.inst_valid[:, None], out, 0.0)


def _pack_rows_exact_fwd(feats_g, bins):
    return _pack_rows_exact(feats_g, bins), (bins, feats_g.shape[0])


def _pack_rows_exact_bwd(res, g):
    bins, P = res
    g = jnp.where(bins.inst_valid[:, None], g, 0.0)
    return (jax.ops.segment_sum(g, bins.order[bins.rank], num_segments=P),
            None)


_pack_rows_exact.defvjp(_pack_rows_exact_fwd, _pack_rows_exact_bwd)


@pytest.fixture(autouse=True)
def _exact_jax_segment_sums(monkeypatch):
    monkeypatch.setattr(jbin, "pack_rows", _pack_rows_exact)


def _jax_loss_and_grads(phase, it, use_app, burned_in, backend="oracle"):
    d, views, depths, net, net_params, app_ab = _scene()
    opt = jconfig.OptimizationParams(enable_mix_precision=False)
    fovx, fovy = float(d["fovx"]), float(d["fovy"])
    cam = jcam.make_camera(d["cam_R"], d["cam_t"], fovx, fovy, W, H)
    rcfg = JRasterConfig(instance_cap=CAP, row_cap=CAP, backend=backend,
                         buffer_len=4, staircase_cull=True)
    idx = jnp.asarray([0, 1, 2, 3, 0])
    src = source_views_from_stacks(
        jnp.asarray(d["src_images"])[idx], jnp.asarray(depths),
        jnp.asarray(np.stack(views))[idx],
        jnp.asarray(d["src_cam_pos"])[idx], jnp.arange(5, dtype=jnp.int32),
        jnp.int32(4), cam)
    model = _jax_model(d)
    P = model.capacity

    def loss_fn(params, app, netp, sdum, sdum_abs):
        res, dnormal = render_view(
            model.replace(params=params), cam, rcfg, jnp.zeros(3), src=src,
            learnt_normal=True, render_geo=phase.render_geo,
            return_depth_normal=phase.render_geo, screen_dummy=sdum,
            screen_dummy_abs=sdum_abs)
        total, aux = jtr.ibgs_objective(
            opt, phase, net, netp, app, jnp.int32(3), res.render, res.normal,
            dnormal, res.ibr, jnp.asarray(d["gt"]), jnp.int32(it),
            jnp.bool_(use_app), jnp.float32(burned_in))
        return total, dict(aux, n_instances=res.n_instances)

    z = jnp.zeros((P, 2), jnp.float32)
    (total, aux), g = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        model.params, jnp.asarray(app_ab), net_params, z, z)
    return float(total), _tree(aux), _tree(g)


def _port_state(device="cpu"):
    d, views, depths, net, net_params, app_ab = _scene()
    state = convert.train_state_from_numpy(d, net=net_params, app_ab=app_ab,
                                           spatial_lr_scale=1.0,
                                           device=device)
    sc = convert.bundle_scene(d, W, H, device=device)
    idx = torch.as_tensor([0, 1, 2, 3, 0])
    src = t_src_views(sc["images"][idx], torch.as_tensor(depths),
                      sc["w2v"][idx], sc["centers"][idx], torch.arange(5),
                      4, sc["cam"])
    return state, sc, src


def _port_loss_and_grads(phase, it, use_app, burned_in):
    state, sc, src = _port_state()
    opt = OptimizationParams(enable_mix_precision=False)
    rcfg = RasterConfig(buffer_len=4, staircase_cull=True)
    return ttr.loss_and_grads(opt, rcfg, state.net, phase, state, sc["cam"],
                              3, sc["gt"], src, it, torch.zeros(3),
                              use_app, burned_in), state


def _flax_net_grads(state, g_net):
    """The port's net gradients as a Flax-shaped tree (Linear (out, in) →
    Dense (in, out), Conv OIHW → HWIO)."""
    names = [n for n, _ in state.net.named_parameters()]
    out = {}
    for name, gx in zip(names, g_net):
        *mods, kind = name.split(".")
        x = gx.numpy()
        if kind == "weight":
            x = x.T if x.ndim == 2 else x.transpose(2, 3, 1, 0)
        node = out
        for mname in mods:
            node = node.setdefault(mname, {})
        node["kernel" if kind == "weight" else "bias"] = x
    return out


def _close_field(got, want, name):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale,
                               err_msg=name)


CASES = {  # name: (render_geo, use_aggregation, iteration, use_app, burn)
    "geo_agg_burned": (True, True, ITER_GEO, False, 1.0),
    "geo_agg_burnin_app": (True, True, ITER_GEO, True, 0.75),
    "color_app": (False, False, ITER_COLOR, True, 0.5),
    "color": (False, False, ITER_COLOR, False, 0.5),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_jax(name):
    geo, agg, it, use_app, burn = CASES[name]
    phase_j = jtr.StepPhase(render_geo=geo, use_aggregation=agg)
    phase_t = ttr.StepPhase(render_geo=geo, use_aggregation=agg)
    jtotal, jaux, (jgp, jgapp, jgnet, jgsd, _jgsda) = _jax_loss_and_grads(
        phase_j, it, use_app, burn)
    (total, aux, g), state = _port_loss_and_grads(phase_t, it, use_app, burn)

    np.testing.assert_allclose(float(total), jtotal, rtol=1e-4, atol=1e-4)
    for k in ("image_loss", "normal_loss", "photo_loss", "agg_loss", "l1",
              "psnr"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    if geo:
        assert float(aux["photo_loss"]) > 0 and float(aux["normal_loss"]) > 0
    assert aux["n_instances"] == int(jaux["n_instances"]) < CAP
    for k in FIELDS:
        _close_field(getattr(g.params, k).numpy(), getattr(jgp, k), k)
    _close_field(g.app_ab.numpy(), jgapp, "app_ab")
    _close_field(g.screen.numpy(), jgsd, "screen_dummy")
    if use_app:
        assert np.abs(jgapp).max() > 0
    if agg:
        got = _flax_net_grads(state, g.net)
        want = jgnet.get("params", jgnet)
        for path, x in jax.tree_util.tree_leaves_with_path(want):
            node = got
            for key in path:
                node = node[key.key]
            _close_field(node, x, jax.tree_util.keystr(path))
    else:
        assert all(float(x.abs().max()) == 0 for x in g.net)


def test_screen_abs_grad_matches_pallas_interpret():
    geo, agg, it, use_app, burn = CASES["color"]
    _, _, (_, _, _, jgsd, jgsda) = _jax_loss_and_grads(
        jtr.StepPhase(render_geo=geo, use_aggregation=agg), it, use_app,
        burn, backend="pallas")
    (_, _, g), _ = _port_loss_and_grads(
        ttr.StepPhase(render_geo=geo, use_aggregation=agg), it, use_app,
        burn)
    assert np.abs(jgsda).max() > 0
    _close_field(g.screen_abs.numpy(), jgsda, "screen_dummy_abs")
    _close_field(g.screen.numpy(), jgsd, "screen_dummy")


def test_three_port_steps_lower_the_loss():
    state, sc, src = _port_state()
    opt = OptimizationParams(enable_mix_precision=False)
    rcfg = RasterConfig(buffer_len=4, staircase_cull=True)
    step = ttr.make_train_step(opt, rcfg, state.net,
                               ttr.StepPhase(render_geo=True,
                                             use_aggregation=True))
    loss = []
    for _ in range(3):
        state, aux = step(state, sc["cam"], 3, sc["gt"], src, ITER_GEO,
                          torch.zeros(3), False, 1.0, 1e-3)
        assert int(aux["nonfinite_grads"]) == 0
        assert all(bool(torch.isfinite(v).all()) for v in aux.values()
                   if torch.is_tensor(v) and v.is_floating_point())
        loss.append(float(aux["loss"]))
    assert loss[-1] < loss[0], loss
    assert state.model.step == 3 and state.app_opt.step == 3
    assert state.net_opt.step == 3
    assert float(state.model.denom.max()) == 3.0
    assert float(state.model.grad_accum_abs.max()) > 0
