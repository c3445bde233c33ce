"""The viewport band of the port's `rasterize` and the epilogue's `row0`.

* A band of the port equals the crop of the port's full frame: floats to
  rtol 1e-5 / atol 1e-6 (the JAX package's band test,
  tests/test_sharding.py), n_contrib and radii exact; with the staircase
  cull on and off, colour-only and with the warp (render_geo, sources).
* The port's band against the JAX package's band (oracle backend) on
  tests/test_sharding.py's scene: the same tolerance, n_contrib and radii
  exact.
* `ibr_epilogue(row0=...)` of a band against the JAX package's, forward
  (floats rtol/atol 1e-5, integers exact) and the gradient w.r.t. the
  buffer depths and weights through the warp's VJP (rtol 1e-4, atol 1e-4
  x max |gradient|, as tests/test_torch_epilogue.py).
* The converged bundle (bench_bundle.npz, 91,307 splats) at 960x544 from
  source view 4's ring camera (convert.ring_source_cameras, as
  convert.bundle_train_scene builds it), rows 528-543 and 224-239.  Its
  projection is ill-conditioned: a·c/|det| of the 2D covariance reaches
  9e5, so ulps of difference in the covariance grow to percents in the
  conic.  The bounds follow the conditioning: cov2d within COV_TOL of
  each splat's largest entry (measured 1.12e-5 against the jitted JAX
  projection); each visible splat's conic within 2·COV_TOL·κ of its
  largest entry, κ = a·c/|det| (measured up to 1.35e-5·κ); the
  depth-only median depth (DEPTH_BOUNDS) within 1e-5 relative on all but
  a share of the band's pixels, and a bound on how far off they are: the
  99th percentile and the max of |port - JAX| (measured: rows 528-543,
  where a splat's conic differs most, 4,923 of 15,360 pixels off (32.05%),
  99th percentile 0.0096, max 0.497; rows 224-239, 93 pixels (0.61%),
  4.4e-4, 0.659 at a depth of hundreds).  The float32 formula is the
  reference's and is kept.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.core import transforms as jtf
from ibgs_tpu.core.camera import look_at_camera as jlook_at
from ibgs_tpu.models import gaussians as jg
from ibgs_tpu.ops import epilogue as jep
from ibgs_tpu.ops import preprocess as jpre
from ibgs_tpu.ops.blend_common import BlendOutputs as JBlendOutputs
from ibgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ibgs_tpu.ops.rasterize import rasterize as jrasterize
from ibgs_tpu_torch import convert
from ibgs_tpu_torch.core import transforms as ttf
from ibgs_tpu_torch.core.camera import look_at_camera
from ibgs_tpu_torch.ops import epilogue as tep
from ibgs_tpu_torch.ops import preprocess as tpre
from ibgs_tpu_torch.ops.blend_common import BlendOutputs
from ibgs_tpu_torch.ops.rasterize import RasterConfig, prepare, rasterize
from tests.test_torch_epilogue import _blend, _f32
from tests.test_torch_slice import one_torch_thread  # noqa: F401
from tests.utils import face_camera, random_cloud, simple_camera

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
BANDS = [(0, 32), (32, 32), (16, 16), (48, 16)]
COV_TOL = 2e-5
# median depth of the bundle band: (share of pixels off by more than 1e-5
# relative, 99th percentile and max of |port - JAX|) per band
DEPTH_BOUNDS = {528: (0.35, 0.015, 0.6), 224: (0.02, 1e-3, 0.8)}


def _scene(seed=0, n=40, W=32, H=64):
    """tests/test_sharding.py's scene: numpy inputs of both packages."""
    jc = simple_camera(W, H)
    p = {k: np.asarray(v) for k, v in
         face_camera(random_cloud(jax.random.PRNGKey(seed), n), jc).items()}
    tc = look_at_camera([0.0, 0.0, -3.0], [0.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                        0.8, 0.8, W, H, device="cpu")
    return p, jc, tc


def _port_kw(p, tc):
    return dict(xyz=torch.as_tensor(p["xyz"]),
                scale=torch.as_tensor(p["scale"]),
                quat=torch.as_tensor(p["quat"]),
                opacity=torch.as_tensor(p["opacity"]),
                sh_coeffs=torch.as_tensor(p["sh_coeffs"]), active_sh_degree=0,
                normal_world=torch.as_tensor(p["normal_world"]),
                plane_offset=torch.as_tensor(p["plane_offset"]), cam=tc,
                bg=torch.tensor([0.2, 0.3, 0.4]))


def _sources(W, H, S=3, seed=5):
    """Source views near the reference camera (ref_to_src a small shift)
    with cached depths of 3, the scene's distance."""
    r = np.random.default_rng(seed)
    r2s = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    r2s[:, :3, 3] = r.normal(size=(S, 3)) * [0.02, 0.02, 0.0]
    return tep.SourceViews(
        images=torch.as_tensor(r.uniform(size=(S, H, W, 3)),
                               dtype=torch.float32),
        depths=torch.full((S, H, W), 3.0),
        ref_to_src=torch.as_tensor(r2s),
        cam_pos=torch.as_tensor(r.normal(size=(S, 3)), dtype=torch.float32),
        count=S)


def _assert_band_equal(band, full, r0, rows, fields):
    for f in fields:
        a = getattr(band, f)
        b = getattr(full, f)[r0:r0 + rows]
        if a.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f)


@pytest.mark.parametrize("stair", [False, True])
@pytest.mark.parametrize("geo", [False, True])
def test_band_equals_crop_of_full_frame(stair, geo):
    p, _, tc = _scene()
    kw = _port_kw(p, tc)
    cfg = RasterConfig(staircase_cull=stair)
    src = _sources(tc.width, tc.height) if geo else None
    full = rasterize(**kw, cfg=cfg, render_geo=geo, src=src)
    fields = ["render", "final_t", "n_contrib", "normal"]
    if geo:
        fields.append("median_depth")
    for r0, rows in BANDS:
        band = rasterize(**kw, cfg=cfg, render_geo=geo, src=src,
                         viewport_row0=r0, viewport_rows=rows)
        assert band.render.shape == (rows, tc.width, 3)
        _assert_band_equal(band, full, r0, rows, fields)
        if geo:
            for f in ("warped_image", "valid_src_index"):
                a = getattr(band.ibr, f).numpy()
                b = getattr(full.ibr, f)[:, r0:r0 + rows].numpy()
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                           err_msg=f)
        # a splat that touches no tile of the band has radius 0 there
        vis = band.radii > 0
        assert bool((full.radii[vis] > 0).all())


def _assert_matches_jax_band(cfg):
    """Every band of BANDS under `cfg` against the JAX package's (oracle
    backend) under the same cull; returns the port's bands."""
    p, jc, tc = _scene()
    jcfg = JRasterConfig(instance_cap=4096, backend="oracle",
                         staircase_cull=cfg.staircase_cull,
                         exact_tile_cull=cfg.exact_tile_cull, row_cap=2048)
    jkw = dict(xyz=jnp.asarray(p["xyz"]), scale=jnp.asarray(p["scale"]),
               quat=jnp.asarray(p["quat"]), opacity=jnp.asarray(p["opacity"]),
               sh_coeffs=jnp.asarray(p["sh_coeffs"]), active_sh_degree=0,
               normal_world=jnp.asarray(p["normal_world"]),
               plane_offset=jnp.asarray(p["plane_offset"]), cam=jc,
               bg=jnp.array([0.2, 0.3, 0.4]), cfg=jcfg, render_geo=False)
    kw = _port_kw(p, tc)
    bands = []
    for r0, rows in BANDS:
        want = jrasterize(**jkw, viewport_row0=r0, viewport_rows=rows)
        got = rasterize(**kw, cfg=cfg, render_geo=False, viewport_row0=r0,
                        viewport_rows=rows)
        for f in ("render", "final_t", "normal"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=RTOL, atol=ATOL, err_msg=f)
        for f in ("n_contrib", "radii"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        assert got.n_instances == int(want.n_instances)
        bands.append(got)
    return bands


@pytest.mark.parametrize("stair", [False, True])
def test_band_matches_jax_band(stair):
    _assert_matches_jax_band(RasterConfig(staircase_cull=stair))


def test_band_exact_tile_cull_matches_jax_band():
    """The exact tile / ellipse cull without the staircase: it retags
    instances of the band-local grid (the cull table's rows are
    band-local), so the bands' tile ranges shrink while every output is
    JAX's, and the unculled band's exactly (as tests/test_binning.py holds
    the JAX package's cull)."""
    cfg = RasterConfig(exact_tile_cull=True)
    bands = _assert_matches_jax_band(cfg)
    p, _, tc = _scene()
    kw = _port_kw(p, tc)
    kw.pop("bg")
    retagged = 0
    for (r0, rows), got in zip(BANDS, bands):
        plain = rasterize(**kw, bg=torch.tensor([0.2, 0.3, 0.4]),
                          cfg=RasterConfig(), render_geo=False,
                          viewport_row0=r0, viewport_rows=rows)
        for f in ("render", "final_t", "normal"):     # n_contrib counts
            np.testing.assert_array_equal(             # the walked rows
                getattr(got, f).numpy(), getattr(plain, f).numpy(), f)
        on, off = (prepare(**kw, cfg=c, viewport_row0=r0, viewport_rows=rows)
                   for c in (cfg, RasterConfig()))
        live = [int((b.bins.tile_stop - b.bins.tile_start).sum())
                for b in (on, off)]
        assert live[0] <= live[1] == off.bins.n_instances
        retagged += live[1] - live[0]
    assert retagged > 0


def _band_inputs(seed, Wb=48, Hb=32, S=3):
    """A band's blend outputs (tests/test_torch_epilogue.py's generator)
    and full-frame sources twice the band's height."""
    bl = _f32(_blend(seed))
    r = np.random.default_rng(seed + 10)
    r2s = np.tile(np.eye(4), (S, 1, 1))
    r2s[:, :3, 3] = r.normal(size=(S, 3)) * [0.05, 0.05, 0.0]
    depths = np.stack([np.full((2 * Hb, Wb), 3.0),
                       3.0 + r.normal(size=(2 * Hb, Wb)) * 0.03,
                       np.full((2 * Hb, Wb), 2.0)])
    src = _f32(dict(images=r.uniform(-0.1, 1.1, (S, 2 * Hb, Wb, 3)),
                    depths=depths, ref_to_src=r2s,
                    cam_pos=r.normal(size=(S, 3))))
    return bl, src


@pytest.mark.parametrize("row0", [16, 32])
def test_epilogue_row0_matches_jax(row0):
    bl, src = _band_inputs(0)
    Wb, H_full = 48, 64
    jc = simple_camera(Wb, H_full)
    tc = look_at_camera([0.0, 0.0, -3.0], [0.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                        0.8, 0.8, Wb, H_full, device="cpu")
    r = np.random.default_rng(40)
    weights = {k: r.normal(size=s).astype(np.float32) for k, s in (
        ("median_depth", (32, Wb)), ("warped_image", (3, 32, Wb, 3)))}

    def jrun(bd, bw):
        b = JBlendOutputs(**{k: jnp.asarray(v) for k, v in bl.items()})
        return jep.ibr_epilogue(
            b.replace(buf_depth=bd, buf_weight=bw), jc,
            jep.SourceViews(count=jnp.int32(3),
                            **{k: jnp.asarray(v) for k, v in src.items()}),
            row0=row0)

    def jloss(bd, bw):
        out = jrun(bd, bw)
        return sum((getattr(out, k) * w).sum() for k, w in weights.items())

    jbd, jbw = jnp.asarray(bl["buf_depth"]), jnp.asarray(bl["buf_weight"])
    want = jax.jit(jrun)(jbd, jbw)
    want_g = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jbd, jbw)

    bd = torch.as_tensor(bl["buf_depth"]).requires_grad_(True)
    bw = torch.as_tensor(bl["buf_weight"]).requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in bl.items()}
    tb.update(buf_depth=bd, buf_weight=bw)
    got = tep.ibr_epilogue(BlendOutputs(**tb), tc, tep.SourceViews(
        count=3, **{k: torch.as_tensor(v) for k, v in src.items()}),
        row0=row0)
    n_valid = (np.asarray(want.valid_src_index) >= 0).sum(0)
    assert n_valid.max() >= 2 and n_valid.min() < 3      # mixed validity
    for f in dataclasses.fields(tep.IBROutputs):
        a = getattr(got, f.name).detach().numpy()
        b = np.asarray(getattr(want, f.name))
        if b.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=f.name)
    loss = sum((getattr(got, k) * torch.as_tensor(w)).sum()
               for k, w in weights.items())
    for g, w, name in zip(torch.autograd.grad(loss, [bd, bw]), want_g,
                          ("d buf_depth", "d buf_weight")):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.fixture(scope="module")
def bundle_view():
    d = dict(np.load(os.path.join(ROOT, "bench_bundle.npz")))
    W, H = 960, 544
    _, srcs = convert.ring_source_cameras(d, W, H, "cpu")
    tc = srcs[3]
    jc = jlook_at(np.asarray(d["src_cam_pos"][3], np.float64),
                  (0.0, 0.0, 0.0), (0.0, -1.0, 0.0), float(d["fovx"]),
                  float(d["fovy"]), W, H)
    np.testing.assert_array_equal(np.asarray(jc.view), tc.view.numpy())
    tm = convert.gaussians_from_numpy(d, "cpu")
    n = tm.capacity
    jm = jg.init_from_points(np.zeros((4, 3), np.float32),
                             np.zeros((4, 3), np.float32), 2, capacity=n)
    jm = jm.replace(params=jg.GaussianParams(**{
        k: jnp.asarray(d[k], jnp.float32) for k in convert.PARAM_FIELDS}),
        alive=jnp.ones((n,), bool), active_sh_degree=jnp.int32(2))
    return jm, jc, tm, tc


def test_bundle_projection_conditioning(bundle_view):
    jm, jc, tm, tc = bundle_view
    ewa = jax.jit(lambda s, q, x: jpre.ewa_project(
        s, q, jtf.apply_transform(jc.view, x), jc))
    jcov = np.asarray(ewa(jm.scale, jm.quat_unit, jm.params.xyz))
    tcov = tpre.ewa_project(tm.scale, tm.quat_unit,
                            ttf.apply_transform(tc.view, tm.params.xyz),
                            tc).numpy()
    scale = np.abs(jcov).max(1)
    assert (np.abs(tcov - jcov).max(1) <= COV_TOL * scale).all()

    nw, off = jm.oriented_normal(jc.cam_pos, learnt=True)
    jsp = jax.jit(lambda m, nw, off: jpre.preprocess(
        m.params.xyz, m.scale, m.quat_unit, m.opacity, m.sh_coeffs,
        m.active_sh_degree, nw, off, jc, 16, 32, alive=m.alive))(jm, nw, off)
    tnw, toff = tm.oriented_normal(tc.cam_pos, learnt=True)
    tsp = tpre.preprocess(tm.params.xyz, tm.scale, tm.quat_unit, tm.opacity,
                          tm.sh_coeffs, 2, tnw, toff, tc, 16, 32,
                          alive=tm.alive)
    vis = np.asarray(jsp.n_tiles) > 0
    a, b, c = jcov[:, 0], jcov[:, 1], jcov[:, 2]
    kappa = a * c / np.abs(a * c - b * b)
    jcon, tcon = np.asarray(jsp.conic), tsp.conic.numpy()
    err = np.abs(tcon - jcon).max(1) / np.abs(jcon).max(1)
    assert kappa[vis].max() > 1e5         # the regime this test is about
    assert (err[vis] <= 2 * COV_TOL * kappa[vis]).all(), \
        (err / kappa)[vis].max()


@pytest.mark.parametrize("row0", [528, 224])
def test_bundle_band_median_depth(bundle_view, row0):
    jm, jc, tm, tc = bundle_view
    rows = 16
    jcfg = JRasterConfig(instance_cap=1 << 14, backend="oracle",
                         staircase_cull=True, row_cap=1 << 13)

    @jax.jit
    def jband(m, nw, off):
        return jrasterize(
            xyz=m.params.xyz, scale=m.scale, quat=m.quat_unit,
            opacity=m.opacity, sh_coeffs=m.sh_coeffs,
            active_sh_degree=m.active_sh_degree, normal_world=nw,
            plane_offset=off, cam=jc, bg=jnp.zeros(3), cfg=jcfg,
            alive=m.alive, render_geo=False, depth_only=True,
            viewport_row0=row0, viewport_rows=rows)

    want = jband(jm, *jm.oriented_normal(jc.cam_pos, learnt=True))
    assert int(want.n_instances) <= jcfg.instance_cap
    tnw, toff = tm.oriented_normal(tc.cam_pos, learnt=True)
    got = rasterize(
        xyz=tm.params.xyz, scale=tm.scale, quat=tm.quat_unit,
        opacity=tm.opacity, sh_coeffs=tm.sh_coeffs,
        active_sh_degree=tm.active_sh_degree, normal_world=tnw,
        plane_offset=toff, cam=tc, bg=torch.zeros(3),
        cfg=RasterConfig(staircase_cull=True), alive=tm.alive,
        render_geo=False, depth_only=True, viewport_row0=row0,
        viewport_rows=rows)
    wd = np.asarray(want.median_depth)
    gd = got.median_depth.numpy()
    assert np.isfinite(gd).all() and (wd > 0).mean() > 0.5
    err = np.abs(gd - wd)
    off = err > 1e-5 * np.abs(wd)
    share, q99, most = DEPTH_BOUNDS[row0]
    reading = (off.mean(), np.quantile(err, 0.99), err.max())
    assert off.mean() <= share, reading
    assert np.quantile(err, 0.99) <= q99 and err.max() <= most, reading
