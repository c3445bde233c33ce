"""The port's Gaussian-sharded full objective (`gsp_full_train_step`,
ibgs_tpu_torch/parallel/gsp.py) with two gloo ranks on the CPU, spawned
as in tests/test_torch_parallel.py (rank bodies in
tests/torch_parallel_ranks.py).

* `gsp_full_train_step` (gs 2) on tests/test_gsp.py's full-objective
  inputs (made in JAX, the Flax net carried across) against the port's
  single-rank step: loss terms within 2e-5 relative, median depth rtol
  1e-5 / atol 1e-6, every parameter group within 2.05·lr with at most 5%
  of entries over 1e-6, densification statistics (grad_accum rtol 1e-3 /
  atol 1e-7, denom exact), exposure table within 2.1e-3, net within
  2.1·net_lr; and against JAX's `gsp_full_train_step` at gs 2 with the
  same bounds but for the median depth, agg_loss and grad_accum, which a
  near tie of the median contributor moves (the test says how far).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ibgs_tpu.ops.epilogue import SourceViews as JSourceViews
from ibgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ibgs_tpu.parallel import gsp as jgsp
from ibgs_tpu.parallel.sharding import _cam_stack, make_mesh
from ibgs_tpu_torch import convert
from ibgs_tpu_torch.parallel import _spawn
from tests.test_gsp import _model
from tests.test_torch_parallel import _arrays
from tests.test_torch_slice import one_torch_thread  # noqa: F401

CFG = JRasterConfig(instance_cap=4096, backend="oracle")
FULL_LRS = dict(xyz=1.6e-4, sh_dc=2.5e-3, sh_rest=1.25e-4, log_scale=5e-3,
                quat=1e-3, opacity_logit=2.5e-2, normal=1e-3, offset=8e-5)
NET_LR = 1e-4
# the full step against JAX's (test_gsp_full_train_step_matches_jax)
MEDIAN_FLIPS, AGG_ATOL, GA_RTOL = 0.01, 5e-4, 0.05


@pytest.fixture(scope="module")
def full_case():
    """tests/test_gsp.py's full-objective case in JAX (model, sources whose
    cached depth is the view's own render, target, Flax net, train state)
    and the numpy arrays that the port's ranks build it from."""
    from ibgs_tpu.config import OptimizationParams
    from ibgs_tpu.models import aggregation
    from ibgs_tpu.renderer import render_depth_view
    from ibgs_tpu.train.trainer import SideOptState, TrainState

    model, cam = _model(seed=5, n=60, cap=128, H=128, W=32)
    H, W, S = 128, 32, 3
    opt = OptimizationParams(
        use_color_aggregation=True, number_src_frames=S,
        nb_visible_src_frames=2, single_view_weight_from_iter=0,
        multi_view_weight_from_iter=0, start_color_aggregation_iter=0,
        position_lr_max_steps=100)
    net = aggregation.ColorFusionResidualNet(
        feat_aggregate_mode=opt.feat_aggregate_mode)
    net_params = net.init(jax.random.PRNGKey(0),
                          jnp.zeros((H, W, 2, 7)), jnp.zeros((H, W, 3)),
                          jnp.zeros((H, W, 3)))
    state = TrainState(
        model=model, app_ab=jnp.zeros((1600, 2), jnp.float32),
        app_opt=SideOptState.init(jnp.zeros((1600, 2))),
        net_params=net_params, net_opt=SideOptState.init(net_params),
        spatial_lr_scale=jnp.float32(1.0))
    d0 = render_depth_view(model, cam, CFG)
    ks = jax.random.split(jax.random.PRNGKey(7), 2)
    src = JSourceViews(
        images=jax.random.uniform(ks[0], (S, H, W, 3)),
        depths=jnp.tile(d0[None], (S, 1, 1)),
        ref_to_src=jnp.tile(jnp.eye(4)[None], (S, 1, 1)),
        cam_pos=jax.random.normal(ks[1], (S, 3)) * 0.05,
        count=jnp.int32(S))
    gt = jax.random.uniform(jax.random.PRNGKey(9), (H, W, 3))
    arrays_in = dict(model=_arrays(model), src_images=np.asarray(src.images),
                     depth=np.asarray(d0), src_cam_pos=np.asarray(src.cam_pos),
                     gt=np.asarray(gt),
                     net=jax.tree.map(np.asarray, net_params))
    return dict(opt=opt, net=net, state=state, cam=cam, src=src, gt=gt,
                arrays=arrays_in)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, full_case):
    return _spawn.run("tests.torch_parallel_ranks:full2", 2,
                      str(tmp_path_factory.mktemp("full2")),
                      full_case["arrays"])[0]


def test_gsp_full_train_step_matches_single_rank(world2):
    one, sh = world2["single"], world2["sharded"]
    assert sh["aux"]["n_overflow"] == 0
    assert sh["aux"]["nonfinite_grads"] == 0
    for k in ("loss", "image_loss", "normal_loss", "photo_loss", "agg_loss",
              "l1", "psnr"):
        a, b = one["aux"][k], sh["aux"][k]
        assert abs(a - b) <= 2e-5 * max(abs(a), 1.0), (k, a, b)
    assert one["aux"]["agg_loss"] > 0 and one["aux"]["normal_loss"] > 0
    np.testing.assert_allclose(sh["median"], one["median"], rtol=1e-5,
                               atol=1e-6)
    for f, lr in FULL_LRS.items():
        a, b = one["model"]["params"][f], sh["model"]["params"][f]
        if a.size == 0:
            continue
        d = np.abs(a - b)
        assert d.max() <= 2.05 * lr, (f, d.max(), lr)
        assert (d > 1e-6).mean() < 0.05, (f, (d > 1e-6).mean())
    np.testing.assert_allclose(sh["model"]["grad_accum"],
                               one["model"]["grad_accum"], rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_array_equal(sh["model"]["denom"], one["model"]["denom"])
    np.testing.assert_allclose(sh["app_ab"], one["app_ab"], atol=2.1e-3)
    for k, a in one["net"].items():
        np.testing.assert_allclose(sh["net"][k], a, atol=2.1 * NET_LR,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_full_step(full_case):
    """JAX's gsp_full_train_step at gs 2 on the full-objective case."""
    from ibgs_tpu.train.trainer import StepPhase

    c = full_case
    mesh = make_mesh(1, 2, axis_names=("dp", "gs"))
    step = jgsp.gsp_full_train_step(
        c["opt"], CFG, c["net"], StepPhase(render_geo=True,
                                           use_aggregation=True),
        mesh, 32, 128, cap_local=2048, exchange_cap=1024)
    s, aux = step(c["state"], _cam_stack([c["cam"]]),
                  jnp.zeros((1,), jnp.int32), c["gt"][None],
                  jax.tree.map(lambda x: x[None], c["src"]), jnp.int32(5),
                  jnp.zeros(3), jnp.bool_(True), jnp.float32(1.0),
                  jnp.float32(NET_LR))
    net = convert.fusion_net_from_flax(jax.tree.map(np.asarray,
                                                    s.net_params),
                                       c["opt"].feat_aggregate_mode,
                                       device="cpu")
    return dict(aux={k: float(v) for k, v in aux.items() if np.ndim(v) == 0},
                median=np.asarray(aux["median_depth"][0]),
                model=_arrays(s.model), app_ab=np.asarray(s.app_ab),
                net={k: v.numpy() for k, v in net.state_dict().items()})


def test_gsp_full_train_step_matches_jax(world2, jax_full_step):
    """The port's Gaussian-sharded full step (gs 2) against JAX's on the
    same inputs, with tests/test_gsp.py's bounds but for what the median
    depth feeds.  This scene's median contributor is a near tie at a few
    pixels: JAX's jitted render and its op-by-op evaluation of the same
    render already disagree at 5 pixels (up to 0.014), and each such pixel
    moves its warp, so the fused colour and the gradients that flow back
    from it.  So the median depth holds rtol 1e-5 / atol 1e-6 on all but
    MEDIAN_FLIPS of the pixels (measured 4 of 4,096, up to 0.15); agg_loss
    is within AGG_ATOL of JAX's (measured 2.0e-4; JAX's own jitted and
    op-by-op values differ by 1.5e-4, and the port's is the op-by-op one
    to 1e-6); grad_accum within GA_RTOL (measured 1.6% on 11 of 60
    splats).  Parameters (Adam's first step, measured within 6e-7), the
    exposure table and the net hold tests/test_gsp.py's bounds."""
    want, got = jax_full_step, world2["sharded"]
    assert want["aux"]["n_overflow"] == got["aux"]["n_overflow"] == 0
    assert got["aux"]["n_instances"] == want["aux"]["n_instances"]
    for k in ("image_loss", "normal_loss", "photo_loss", "l1", "psnr"):
        a, b = want["aux"][k], got["aux"][k]
        assert abs(a - b) <= 2e-5 * max(abs(a), 1.0), (k, a, b)
    a, b = want["aux"]["agg_loss"], got["aux"]["agg_loss"]
    assert abs(a - b) <= AGG_ATOL, (a, b)
    off = ~np.isclose(got["median"], want["median"], rtol=1e-5, atol=1e-6)
    assert off.mean() <= MEDIAN_FLIPS, off.sum()
    for f, lr in FULL_LRS.items():
        a, b = want["model"]["params"][f], got["model"]["params"][f]
        if a.size == 0:
            continue
        d = np.abs(a - b)
        assert d.max() <= 2.05 * lr, (f, d.max(), lr)
        assert (d > 1e-6).mean() < 0.05, (f, (d > 1e-6).mean())
    np.testing.assert_allclose(got["model"]["grad_accum"],
                               want["model"]["grad_accum"], rtol=GA_RTOL,
                               atol=1e-7)
    np.testing.assert_array_equal(got["model"]["denom"],
                                  want["model"]["denom"])
    np.testing.assert_allclose(got["app_ab"], want["app_ab"], atol=2.1e-3)
    for k, a in want["net"].items():
        np.testing.assert_allclose(got["net"][k], a, atol=2.1 * NET_LR,
                                   err_msg=k)
