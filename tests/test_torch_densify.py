"""The port's scene initialisation and density control against the JAX
package.

* KNN scales at n = 2,000: `core/knn.initial_log_scales` within 1e-4 abs
  of JAX's, and its mean squared 3-NN distance within 4 float32 ulps of
  max |p|² (what the |q|² + |p|² - 2q·p form keeps) of a float64 numpy
  brute force; the native library's `knn_mean_sq_dist_3` (built from
  native/ibgs_native.cpp) within 1e-5 relative of numpy on 3,000 points.
* `init_from_points`: capacity, alive mask, SH, opacity logit, rotation,
  plane normal and offset exactly; log-scales 1e-4 abs.
* `densify_and_prune` slot for slot, with JAX's three normal draws
  (`split(key, 3)`, as `ibgs_tpu.models.gaussians.densify_and_prune`
  draws them) passed as the port's `noise`: params, Adam moments, alive
  mask and the zeroed statistics.  Integers and the mask exactly, floats
  1e-6.  Cases: clone-dominated, split through the absolute-gradient path
  with its `max_abs_split` budget binding, slot starvation, and a prune
  with `max_screen_size`.
* `reset_opacity` and `decay_opacity`: opacities within 1e-7 abs, their
  logits within 4 float32 ulps of 1 + |logit| (XLA's and PyTorch's CPU
  log and sigmoid differ by an ulp on some inputs, and log(p) - log1p(-p)
  cancels near p = 0.5), every other field exactly;
  `grow_capacity` exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.core import knn as jknn
from ibgs_tpu.models import gaussians as jg
from ibgs_tpu_torch.core import knn as tknn
from ibgs_tpu_torch.models import gaussians as tg
from ibgs_tpu_torch.utils import native
from tests.test_torch_slice import one_torch_thread  # noqa: F401

FIELDS = tg.PARAM_FIELDS
STATS = tg.STAT_FIELDS
TOL = 1e-6
EPS = float(np.finfo(np.float32).eps)


def _brute_3nn(pts):
    p = pts.astype(np.float64)
    d = ((p[:, None] - p[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    return np.sort(d, axis=1)[:, :3].mean(1)


# ------------------------------------------------------------- KNN and init

def test_knn_log_scales_match_jax_and_float64():
    r = np.random.default_rng(0)
    pts = (r.uniform(-1, 1, (2000, 3)) * [2.0, 1.0, 0.5]).astype(np.float32)
    want = np.asarray(jknn.initial_log_scales(jnp.asarray(pts)))
    got = tknn.initial_log_scales(torch.as_tensor(pts)).numpy()
    assert got.shape == (2000, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the float32 |q|² + |p|² - 2q·p form keeps a few ulps of |p|²
    d2 = tknn.mean_sq_dist_to_3nn(torch.as_tensor(pts)).numpy()
    atol = 4 * EPS * float((pts ** 2).sum(1).max())
    np.testing.assert_allclose(d2, _brute_3nn(pts), rtol=0, atol=atol)


def test_native_knn_matches_numpy():
    r = np.random.default_rng(1)
    pts = r.normal(size=(3000, 3)).astype(np.float32)
    got = native.knn_mean_sq_dist_3(pts)
    np.testing.assert_allclose(got, _brute_3nn(pts), rtol=1e-5)


def test_init_from_points_matches_jax():
    r = np.random.default_rng(2)
    n = 2000
    pts = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    col = r.uniform(0, 1, (n, 3)).astype(np.float32)
    jm = jg.init_from_points(pts, col, 2)
    tm = tg.init_from_points(pts, col, 2, device="cpu")
    assert tm.capacity == jm.capacity == 8192
    assert tm.active_sh_degree == 0 and tm.max_sh_degree == 2
    assert tm.step == 0
    np.testing.assert_array_equal(tm.alive.numpy(), np.asarray(jm.alive))
    for k in FIELDS:
        want = np.asarray(getattr(jm.params, k))
        got = getattr(tm.params, k).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape, k
        if k == "log_scale":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
        assert not getattr(tm.mu, k).any() and not getattr(tm.nu, k).any()
    for k in STATS:
        assert not getattr(tm, k).any(), k
    assert tg.init_from_points(pts[:10], col[:10], 1,
                               device="cpu").capacity == 4096


# ------------------------------------------------------------ densify

def _state(case, r):
    """A numpy model state for one densify case: (P, arrays, config
    overrides, scene extent, max_screen_size)."""
    P, n_alive, cfg, max_screen = 512, 200, {}, None
    big_share, g_hi, g_abs_hi, log_big = 0.2, 6e-4, 1e-3, (-2.0, -0.5)
    if case == "split_abs":
        n_alive, big_share, g_hi, g_abs_hi = 150, 0.9, 2.5e-4, 3e-3
        cfg = dict(max_abs_split=10)
    elif case == "starved":
        P, n_alive, big_share, g_hi = 128, 100, 0.3, 1e-3
    elif case == "prune_screen":
        n_alive, log_big, max_screen = 300, (-3.0, 0.0), 20.0
    alive = np.zeros(P, bool)
    alive[r.choice(P, n_alive, replace=False)] = True
    big = r.uniform(size=P) < big_share
    a = {k: r.normal(size=s).astype(np.float32) for k, s in dict(
        xyz=(P, 3), sh_dc=(P, 1, 3), sh_rest=(P, 8, 3), quat=(P, 4),
        normal=(P, 3), offset=(P, 1)).items()}
    a["log_scale"] = np.where(big[:, None], r.uniform(*log_big, (P, 3)),
                              r.uniform(-9.0, -7.0, (P, 3)))
    a["opacity_logit"] = r.normal(-1.0, 2.0, (P, 1))
    a = {k: x.astype(np.float32) for k, x in a.items()}
    for tree in ("mu", "nu"):
        for k in FIELDS:
            a[f"{tree}.{k}"] = np.abs(r.normal(
                size=a[k].shape)).astype(np.float32)
    denom = r.integers(0, 8, P).astype(np.float32)
    a.update(alive=alive, denom=denom, denom_abs=denom.copy(),
             grad_accum=(r.uniform(0, g_hi, P) * denom).astype(np.float32),
             grad_accum_abs=(r.uniform(0, g_abs_hi, P)
                             * denom).astype(np.float32),
             max_radii2d=r.uniform(0, 60, P).astype(np.float32))
    return P, a, cfg, np.float32(1.7), max_screen


def _jax_model(a):
    tree = {t: jg.GaussianParams(**{k: jnp.asarray(a[k if t == "params"
                                                     else f"{t}.{k}"])
                                    for k in FIELDS})
            for t in ("params", "mu", "nu")}
    return jg.GaussianModel(
        **tree, step=jnp.int32(7), alive=jnp.asarray(a["alive"]),
        **{k: jnp.asarray(a[k]) for k in STATS},
        active_sh_degree=jnp.int32(2), max_sh_degree=2)


def _port_model(a, device="cpu"):
    def t(x):
        return torch.as_tensor(x).to(device)

    tree = {tr: tg.GaussianParams(**{k: t(a[k if tr == "params"
                                            else f"{tr}.{k}"])
                                     for k in FIELDS})
            for tr in ("params", "mu", "nu")}
    return tg.GaussianModel(alive=t(a["alive"]), active_sh_degree=2,
                            max_sh_degree=2, step=7,
                            **{k: t(a[k]) for k in STATS}, **tree)


def _jax_noise(key, P):
    """JAX's three draws of one densify event, as the port's (3, P, 3)."""
    return np.stack([np.asarray(jax.random.normal(k, (P, 3)))
                     for k in jax.random.split(key, 3)])


def _assert_models_equal(tm, jm, atol=TOL, rtol=TOL):
    np.testing.assert_array_equal(tm.alive.cpu().numpy(), np.asarray(jm.alive))
    for tree in ("params", "mu", "nu"):
        for k in FIELDS:
            np.testing.assert_allclose(
                getattr(getattr(tm, tree), k).cpu().numpy(),
                np.asarray(getattr(getattr(jm, tree), k)), rtol=rtol,
                atol=atol, err_msg=f"{tree}.{k}")
    for k in STATS:
        np.testing.assert_array_equal(getattr(tm, k).cpu().numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)


@pytest.mark.parametrize("case", ["clone", "split_abs", "starved",
                                  "prune_screen"])
def test_densify_and_prune_matches_jax(case):
    r = np.random.default_rng(["clone", "split_abs", "starved",
                               "prune_screen"].index(case) + 10)
    P, a, over, extent, max_screen = _state(case, r)
    key = jax.random.PRNGKey(5)
    jcfg = dataclasses.replace(jg.DensifyConfig(), **over)
    tcfg = dataclasses.replace(tg.DensifyConfig(), **over)
    jm = jg.densify_and_prune(_jax_model(a), key, jcfg, jnp.float32(extent),
                              max_screen_size=max_screen)
    tm = tg.densify_and_prune(_port_model(a),
                              torch.as_tensor(_jax_noise(key, P)), tcfg,
                              float(extent), max_screen_size=max_screen)
    _assert_models_equal(tm, jm)
    for k in STATS:
        assert not getattr(tm, k).any(), k
    assert tm.step == 7 and tm.active_sh_degree == 2

    # what each case is meant to reach
    alive0 = a["alive"]
    g = np.where(alive0, a["grad_accum"] / np.maximum(a["denom"], 1), 0)
    small = np.exp(a["log_scale"]).max(-1) <= np.float32(1e-3) * extent
    n_after = int(tm.alive.sum())
    changed = int((tm.params.xyz.numpy() != a["xyz"]).any(-1).sum())
    if case == "clone":
        n_clone = int((alive0 & small & (g >= 2e-4)).sum())
        assert n_clone > 50 and changed > n_clone
    elif case == "split_abs":
        g_abs = a["grad_accum_abs"] / np.maximum(a["denom_abs"], 1)
        abs_path = (alive0 & ~small & (g < 2e-4) & (a["max_radii2d"] > 20)
                    & (g_abs >= 8e-4))
        assert abs_path.sum() > over["max_abs_split"]
    elif case == "starved":
        assert int((alive0 & (g >= 2e-4)).sum()) > P - alive0.sum()
        assert int(jm.alive.sum()) <= P
    else:
        pruned = alive0 & ~tm.alive.numpy()
        big_screen = a["max_radii2d"] > max_screen
        assert (pruned & big_screen).any() and n_after < alive0.sum()


def test_opacity_reset_decay_and_growth_match_jax():
    r = np.random.default_rng(3)
    P, a, _, _, _ = _state("clone", r)
    jm, tm = _jax_model(a), _port_model(a)
    for jf, tf in ((lambda m: jg.reset_opacity(m),
                    lambda m: tg.reset_opacity(m)),
                   (lambda m: jg.decay_opacity(m, 0.7),
                    lambda m: tg.decay_opacity(m, 0.7))):
        jo, to = jf(jm), tf(tm)
        np.testing.assert_allclose(to.opacity.numpy(), np.asarray(jo.opacity),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(to.params.opacity_logit.numpy(),
                                   np.asarray(jo.params.opacity_logit),
                                   rtol=4 * EPS, atol=4 * EPS)
        assert not to.mu.opacity_logit.any() and not to.nu.opacity_logit.any()
        to = dataclasses.replace(to, params=dataclasses.replace(
            to.params, opacity_logit=torch.as_tensor(
                np.array(jo.params.opacity_logit))))
        _assert_models_equal(to, jo, atol=0, rtol=0)
    assert float(tg.reset_opacity(tm).opacity.max()) <= 0.01 + 1e-7

    jgrown, tgrown = jg.grow_capacity(jm, 1024), tg.grow_capacity(tm, 1024)
    assert tgrown.capacity == jgrown.capacity == 1024
    _assert_models_equal(tgrown, jgrown, atol=0, rtol=0)
    assert tgrown.step == 7 and not tgrown.alive[P:].any()
