"""The port's parallel layer (ibgs_tpu_torch/parallel) against the JAX
package's, with one gloo process per rank on the CPU.

The ranks run tests/torch_parallel_ranks.py, spawned by
`ibgs_tpu_torch.parallel._spawn.run` (a FileStore under tmp_path; every
collective times out after 120 s, so a deadlock fails the test).  The JAX
references run here, on the suite's 8 virtual CPU devices with the oracle
backend.  Scenes and bounds are those of tests/test_sharding.py and
tests/test_gsp.py:

* `sharded_render` (1 x 4) against JAX's single render: rtol 1e-5, atol
  1e-6;
* `sharded_train_step` and `fsdp_train_step` (2 x 2) against JAX's
  `sharded_train_step`: loss within 1e-5, xyz within 2e-5;
* `gsp_render` (gs = 2 and 4, staircase on and off) against JAX's single
  render: rtol 1e-5, atol 1e-6, no overflow;
* `gsp_train_step` (dp 2 x gs 2) against JAX's `gsp_train_step`: loss
  within 1e-5, xyz within 4e-4 and normal within 2.5e-3 (Adam's first
  step is ±lr whatever the gradient's size, so a gradient at the float32
  noise floor flips a whole step: 2·lr), four more steps improve;
* `gsp_full_train_step` is held in tests/test_torch_parallel_full.py;
* the identity fast path against the generic exchange at world size 1,
  image and gradients bit-identical (also with exact capacities);
* the overflow count at a tiny exchange cap equal to JAX's, and the
  truncated image within rtol 1e-5 / atol 1e-6 of JAX's;
* `gsp_render` (gs 2) with the exact tile cull and no staircase against
  JAX's: rtol 1e-5 / atol 1e-6, and the AABB image bit for bit; at the
  tiny exchange cap its overflow count is JAX's and below the AABB one;
* ties in the merge (splats of equal depth on both shards) against JAX's
  `gsp_render`: rtol 1e-5, atol 1e-6;
* `gsp_interleave` exactly; shard-local densify with JAX's draws
  (`fold_in(key, shard)`) injected: alive mask exact, floats 1e-6;
* the collectives' forward and backward (the transposes) exactly;
* `distributed.initialize()` without any environment is the
  single-process no-op.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.models import gaussians as jg
from ibgs_tpu.models.gaussians import init_from_points
from ibgs_tpu.ops.epilogue import SourceViews as JSourceViews
from ibgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ibgs_tpu.parallel import gsp as jgsp
from ibgs_tpu.parallel.sharding import (_cam_stack, make_mesh,
                                        sharded_train_step)
from ibgs_tpu.renderer import render_view
from ibgs_tpu_torch.models import gaussians as tg
from ibgs_tpu_torch.parallel import _spawn, distributed, gsp
from tests.test_gsp import _model
from tests.test_sharding import _params
from tests.test_torch_slice import one_torch_thread  # noqa: F401
from tests.torch_parallel_ranks import arrays, model_from

CFG = JRasterConfig(instance_cap=4096, backend="oracle")
RANKS = "tests.torch_parallel_ranks"
BG = (0.2, 0.3, 0.4)
OVERFLOW_CAP = 8


def _arrays(m) -> dict:
    """The numpy arrays of a JAX model, as torch_parallel_ranks.model_from
    reads them."""
    out = {tree: {k: np.asarray(getattr(getattr(m, tree), k))
                  for k in tg.PARAM_FIELDS} for tree in ("params", "mu", "nu")}
    out.update(alive=np.asarray(m.alive), step=int(m.step),
               active_sh_degree=int(m.active_sh_degree),
               max_sh_degree=int(m.max_sh_degree),
               **{k: np.asarray(getattr(m, k)) for k in tg.STAT_FIELDS})
    return out


def _render_model():
    """tests/test_sharding.py's sharded-render model: 40 splats in 64
    slots."""
    params, cam = _params()
    m0 = init_from_points(np.zeros((4, 3), np.float32),
                          np.zeros((4, 3), np.float32), 0, capacity=64)
    n = params["xyz"].shape[0]
    return m0.replace(
        params=m0.params.replace(
            xyz=jnp.zeros((64, 3)).at[:n].set(params["xyz"]),
            log_scale=jnp.full((64, 3), -9.0).at[:n].set(
                jnp.log(params["scale"])),
            quat=jnp.zeros((64, 4)).at[:, 0].set(1.0).at[:n].set(
                params["quat"]),
            opacity_logit=jnp.full((64, 1), -9.0).at[:n, 0].set(
                jnp.log(params["opacity"] / (1 - params["opacity"]))),
            sh_dc=jnp.zeros((64, 1, 3)).at[:n].set(params["sh_coeffs"]),
            normal=jnp.zeros((64, 3)).at[:, 2].set(1.0).at[:n].set(
                params["normal_world"])),
        alive=jnp.arange(64) < n), cam


def _tie_model():
    """Splats of rows 32-47 (shard 1 of 2) at the positions of rows 0-15
    (shard 0): equal depths meet in the merge."""
    m, cam = _model(seed=2, n=60, cap=64, H=128, W=32)
    xyz = m.params.xyz.at[32:48].set(m.params.xyz[:16])
    return m.replace(params=m.params.replace(xyz=xyz)), cam


def _jax_noise(key, P):
    return np.stack([np.asarray(jax.random.normal(k, (P, 3)))
                     for k in jax.random.split(key, 3)])


def _jax_gsp_render(m, cam, cfg, n, cap_e):
    mesh = make_mesh(1, n, axis_names=("dp", "gs"))
    img, ovf = jgsp.gsp_render(m, cam, cfg, mesh, cap_local=1024,
                               exchange_cap=cap_e)
    return np.asarray(img), int(ovf)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    rm, cam = _render_model()
    params, _ = _params(seed=3, n=60)
    tm = init_from_points(np.asarray(params["xyz"]),
                          np.full((60, 3), 0.5, np.float32), 0, capacity=128)
    gm, _ = _model(seed=1, n=60, cap=128, H=128, W=32)
    gtm, _ = _model(seed=3, n=60, cap=128, H=128, W=32)
    a = dict(render_model=_arrays(rm), train_model=_arrays(tm),
             gsp_model=_arrays(gm), gsp_train_model=_arrays(gtm))
    return _spawn.run(f"{RANKS}:session4", 4,
                      str(tmp_path_factory.mktemp("world4")), a)[0]


def _densify_model():
    m, _ = _model(seed=6, n=64, cap=128, H=128, W=32)
    m = m.replace(grad_accum=jnp.where(m.alive, 1.0, 0.0),
                  denom=jnp.where(m.alive, 1.0, 0.0))
    return jgsp.gsp_interleave(m, 2)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    gm, _ = _model(seed=1, n=60, cap=128, H=128, W=32)
    om, _ = _model(seed=4, n=60, cap=64, H=128, W=32)
    dm = _densify_model()
    key = jax.random.PRNGKey(0)
    a = dict(gsp_model=_arrays(gm),
             overflow_model=_arrays(om), overflow_cap=OVERFLOW_CAP,
             tie_model=_arrays(_tie_model()[0]), densify_model=_arrays(dm),
             densify_noise=[_jax_noise(jax.random.fold_in(key, k), 64)
                            for k in range(2)])
    return _spawn.run(f"{RANKS}:session2", 2,
                      str(tmp_path_factory.mktemp("world2")), a)[0]


def test_sharded_render_matches_single(world4):
    m, cam = _render_model()
    ref, _ = render_view(m, cam, CFG, jnp.zeros(3), render_geo=False,
                         return_depth_normal=False)
    np.testing.assert_allclose(world4["sharded_render"],
                               np.asarray(ref.render), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_sharded_step():
    params, cam = _params(seed=3, n=60)
    model = init_from_points(np.asarray(params["xyz"]),
                             np.full((60, 3), 0.5, np.float32), 0,
                             capacity=128)
    S, H, W = 2, 64, 32
    srcs = JSourceViews(
        images=jnp.zeros((2, S, H, W, 3)), depths=jnp.zeros((2, S, H, W)),
        ref_to_src=jnp.zeros((2, S, 4, 4)), cam_pos=jnp.zeros((2, S, 3)),
        count=jnp.zeros((2,), jnp.int32))
    gts = jnp.tile(jnp.asarray(np.linspace(0, 1, H * W * 3, dtype=np.float32)
                               .reshape(1, H, W, 3)), (2, 1, 1, 1))
    step = sharded_train_step(None, CFG, make_mesh(2, 2), W, H)
    m, loss = step(model, _cam_stack([cam, cam]), gts, srcs, jnp.int32(1))
    return float(loss), np.asarray(m.params.xyz)


@pytest.mark.parametrize("name", ["sharded_train", "fsdp_train"])
def test_row_band_steps_match_jax(world4, jax_sharded_step, name):
    want_loss, want_xyz = jax_sharded_step
    loss, xyz = world4[name]
    assert abs(loss - want_loss) < 1e-5, (loss, want_loss)
    np.testing.assert_allclose(xyz, want_xyz, atol=2e-5)


@pytest.mark.parametrize("stair", [0, 1])
@pytest.mark.parametrize("world", ["world2", "world4"])
def test_gsp_render_matches_single(request, world, stair):
    img, ovf = request.getfixturevalue(world)[f"gsp_render_stair{stair}"]
    m, cam = _model(seed=1, n=60, cap=128, H=128, W=32)
    ref, _ = render_view(m, cam, CFG, jnp.array(BG), render_geo=False,
                         return_depth_normal=False)
    assert ovf == 0
    np.testing.assert_allclose(img, np.asarray(ref.render), rtol=1e-5,
                               atol=1e-6)


def test_gsp_train_step_matches_jax(world4):
    model, cam = _model(seed=3, n=60, cap=128, H=128, W=32)
    H, W, S = 128, 32, 2
    srcs = JSourceViews(
        images=jnp.zeros((2, S, H, W, 3)), depths=jnp.zeros((2, S, H, W)),
        ref_to_src=jnp.tile(jnp.eye(4)[None, None], (2, S, 1, 1)),
        cam_pos=jnp.zeros((2, S, 3)), count=jnp.zeros((2,), jnp.int32))
    gts = jnp.tile(jnp.asarray(np.linspace(0, 1, H * W * 3, dtype=np.float32)
                               .reshape(1, H, W, 3)), (2, 1, 1, 1))
    step = jgsp.gsp_train_step(CFG, make_mesh(2, 2, axis_names=("dp", "gs")),
                               W, H, cap_local=2048, exchange_cap=1024)
    m1, l1, _ = step(model, _cam_stack([cam, cam]), gts, srcs, jnp.int32(1))
    got = world4["gsp_train"]
    assert got["n_overflow"] == 0
    assert abs(got["loss"][0] - float(l1)) < 1e-5, (got["loss"][0], float(l1))
    np.testing.assert_allclose(got["xyz"], np.asarray(m1.params.xyz),
                               atol=4e-4)
    np.testing.assert_allclose(got["normal"], np.asarray(m1.params.normal),
                               atol=2.5e-3)
    assert np.isfinite(got["loss"][-1]) and got["loss"][-1] < got["loss"][0]


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    m, _ = _model(seed=7, n=60, cap=128, H=128, W=32)
    return _spawn.run(f"{RANKS}:session1", 1,
                      str(tmp_path_factory.mktemp("world1")),
                      dict(model=_arrays(m)))[0]


@pytest.mark.parametrize("pair", [("fast", "generic"),
                                  ("exact", "exact_generic")])
def test_fast_path_bit_identical_to_generic(world1, pair):
    a, b = (world1[k] for k in pair)
    assert a["ovf"] == b["ovf"] == 0
    np.testing.assert_array_equal(a["img"], b["img"])
    assert np.abs(a["img"]).max() > 0
    for ga, gb in zip(a["grads"], b["grads"]):
        assert (ga is None) == (gb is None)
        if ga is not None:
            np.testing.assert_array_equal(ga, gb)
    assert np.abs(a["grads"][0]).max() > 0


def test_overflow_count_matches_jax(world2):
    img, ovf = world2["overflow"]
    m, cam = _model(seed=4, n=60, cap=64, H=128, W=32)
    want_img, want_ovf = _jax_gsp_render(
        m, cam, dataclasses.replace(CFG, tile_h=16, tile_w=16), 2,
        OVERFLOW_CAP)
    assert want_ovf > 0 and ovf == want_ovf
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, want_img, rtol=1e-5, atol=1e-6)


def test_gsp_render_exact_tile_cull_matches_jax(world2):
    """The exact tile / ellipse cull without the staircase at gs 2: the
    image is JAX's (rtol 1e-5, atol 1e-6) and the AABB exchange's bit for
    bit; at a tiny exchange cap the retagged instances stay out of the
    exchange, so fewer overflow, as many as JAX's."""
    img, ovf = world2["gsp_render_exact"]
    m, cam = _model(seed=1, n=60, cap=128, H=128, W=32)
    exact = dataclasses.replace(CFG, exact_tile_cull=True)
    mesh = make_mesh(1, 2, axis_names=("dp", "gs"))
    want = jgsp.gsp_render(m, cam, exact, mesh, cap_local=1024,
                           exchange_cap=512, bg=jnp.array(BG))
    assert ovf == int(want[1]) == 0
    np.testing.assert_allclose(img, np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(img, world2["gsp_render_stair0"][0])

    img, ovf = world2["overflow_exact"]
    m, cam = _model(seed=4, n=60, cap=64, H=128, W=32)
    want_img, want_ovf = _jax_gsp_render(
        m, cam, dataclasses.replace(exact, tile_h=16, tile_w=16), 2,
        OVERFLOW_CAP)
    assert ovf == want_ovf < world2["overflow"][1]
    np.testing.assert_allclose(img, want_img, rtol=1e-5, atol=1e-6)


def test_merge_ties_match_jax(world2):
    m, cam = _tie_model()
    img, ovf = world2["ties"]
    want_img, want_ovf = _jax_gsp_render(m, cam, CFG, 2, 512)
    assert ovf == want_ovf == 0
    np.testing.assert_allclose(img, want_img, rtol=1e-5, atol=1e-6)


def test_gsp_interleave_matches_jax():
    m, _ = _model(seed=6, n=64, cap=128, H=128, W=32)
    want = _arrays(jgsp.gsp_interleave(m, 4))
    got = arrays(gsp.gsp_interleave(model_from(_arrays(m)), 4))
    np.testing.assert_array_equal(got["alive"], want["alive"])
    assert got["alive"].reshape(4, -1).sum(1).std() == 0.0
    for tree in ("params", "mu", "nu"):
        for k in tg.PARAM_FIELDS:
            np.testing.assert_array_equal(got[tree][k], want[tree][k])
    for k in tg.STAT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k])


def test_shard_local_densify_matches_jax(world2):
    dm = _densify_model()
    dens = jgsp.gsp_densify_fn(make_mesh(1, 2, axis_names=("dp", "gs")),
                               jg.DensifyConfig(grad_threshold=1e-9,
                                                percent_dense=10.0))
    want = _arrays(dens(dm, jax.random.PRNGKey(0), jnp.float32(1.0)))
    got = world2["densify"]
    np.testing.assert_array_equal(got["alive"], want["alive"])
    assert got["alive"].sum() > np.asarray(dm.alive).sum()
    for tree in ("params", "mu", "nu"):
        for k in tg.PARAM_FIELDS:
            np.testing.assert_allclose(got[tree][k], want[tree][k],
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{tree}.{k}")
    for k in tg.STAT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k])


def test_collectives_and_their_transposes(world2):
    got = world2["collectives"]
    n = 2
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
         for r in range(n)]
    w = [np.arange(12, dtype=np.float32).reshape(4, 3) * (r + 1)
         for r in range(n)]
    np.testing.assert_array_equal(got["all_gather"], np.concatenate(x))
    # d/dx of sum(all_gather(x)·w_r) over the ranks: every rank's w tile
    np.testing.assert_array_equal(got["all_gather_grad"],
                                  (w[0] + w[1])[:2])
    np.testing.assert_array_equal(got["psum"], x[0] + x[1])
    np.testing.assert_array_equal(got["psum_scatter"], (x[0] + x[1])[:1])
    np.testing.assert_array_equal(got["all_to_all"],
                                  np.concatenate([x[0][:1], x[1][:1]]))
    # d/dx of sum(all_to_all(x)·v_r), v_r = r + 1: rank 0 gets row 0 of
    # every rank's v
    np.testing.assert_array_equal(got["all_to_all_grad"],
                                  [[1.0] * 3, [2.0] * 3])


def test_initialize_without_environment_is_a_no_op(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.rank() == 0
    with pytest.raises(RuntimeError, match="processes"):
        distributed.global_mesh(2, 2, device="cpu")
