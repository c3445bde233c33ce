"""Preprocess, core and renderer helpers and the Gaussian model of the
PyTorch port against the JAX package, on numpy-seeded inputs.

Tolerances: float32 fields rtol 1e-5 / atol 1e-5 (the frameworks' matmul
and transcendental functions differ by a few ulp); integer fields exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu import renderer as jrd
from ibgs_tpu.core import camera as jcam
from ibgs_tpu.core import sh as jsh
from ibgs_tpu.core import transforms as jtf
from ibgs_tpu.models import gaussians as jg
from ibgs_tpu.ops import preprocess as jpre
from ibgs_tpu_torch import renderer as trd
from ibgs_tpu_torch.core import camera as tcam
from ibgs_tpu_torch.core import sh as tsh
from ibgs_tpu_torch.core import transforms as ttf
from ibgs_tpu_torch.models.gaussians import GaussianModel, GaussianParams
from ibgs_tpu_torch.ops import preprocess as tpre
from ibgs_tpu_torch.ops.rasterize import mark_visible

RTOL = ATOL = 1e-5


def _close(got, want, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=msg)


def _cams(W=80, H=56):
    args = ([0.3, -0.2, -3.0], [0.1, 0.0, 0.2], [0.0, -1.0, 0.0], 0.9, 0.7,
            W, H)
    return jcam.look_at_camera(*args), tcam.look_at_camera(*args,
                                                           device="cpu")


def _inputs(seed, n, deg=2):
    r = np.random.default_rng(seed)
    q = r.normal(size=(n, 4))
    return dict(
        xyz=r.uniform(-1.2, 1.2, (n, 3)),
        scale=np.exp(r.uniform(-4.0, -1.0, (n, 3))),
        quat=q / np.linalg.norm(q, axis=1, keepdims=True),
        opacity=r.uniform(0.0, 1.0, n),
        sh=r.uniform(-1, 1, (n, (deg + 1) ** 2, 3)) * 0.5,
        normal=r.normal(size=(n, 3)), offset=r.normal(size=n) * 0.1,
        alive=r.uniform(size=n) > 0.1)


def test_camera_fields():
    jc, tc = _cams()
    for f in ("view", "proj", "full_proj", "cam_pos"):
        _close(getattr(tc, f), getattr(jc, f), f)
    for f in ("fx", "fy", "cx", "cy", "tan_fovx", "tan_fovy"):
        assert getattr(tc, f) == float(getattr(jc, f)), f
    _close(tc.rays_cam(), jc.rays_cam())
    R = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))[0]
    args = (R, np.array([0.1, -0.3, 2.5]), 0.8, 0.6, 64, 48)
    _close(tcam.make_camera(*args, device="cpu").full_proj,
           jcam.make_camera(*args).full_proj)


@pytest.mark.parametrize("active", [0, 1, 2])
def test_sh_and_transforms(active):
    d = _inputs(1, 64)
    dirs = d["normal"] / np.linalg.norm(d["normal"], axis=1, keepdims=True)
    f = {k: np.asarray(v, np.float32) for k, v in d.items()}
    dirs = dirs.astype(np.float32)
    _close(tsh.eval_sh(torch.as_tensor(f["sh"]), torch.as_tensor(dirs), 2,
                       active),
           jsh.eval_sh(jnp.asarray(f["sh"]), jnp.asarray(dirs), 2, active))
    _close(tsh.degree_mask(3, active), jsh.degree_mask(3, active))
    _close(ttf.quat_to_rotmat(torch.as_tensor(f["quat"])),
           jtf.quat_to_rotmat(jnp.asarray(f["quat"])))
    _close(ttf.normalize(torch.as_tensor(f["normal"])),
           jtf.normalize(jnp.asarray(f["normal"])))
    jc, tc = _cams()
    _close(ttf.project_hom(tc.full_proj, torch.as_tensor(f["xyz"])),
           jtf.project_hom(jc.full_proj, jnp.asarray(f["xyz"])))
    _close(mark_visible(torch.as_tensor(f["xyz"]), tc),
           jnp.asarray(f["xyz"]) @ jc.view[2, :3] + jc.view[2, 3] > 0.2)


def test_renderer_helpers():
    """depth_to_normal on a tilted, rippled depth map, and the per-camera
    exposure affine."""
    jc, tc = _cams()
    r = np.random.default_rng(4)
    ys, xs = np.mgrid[0:tc.height, 0:tc.width].astype(np.float32)
    depth = (2.0 + 0.01 * xs - 0.005 * ys + 0.05 * np.sin(0.3 * xs)
             + 0.01 * r.normal(size=xs.shape)).astype(np.float32)
    _close(trd.depth_to_normal(tc, torch.as_tensor(depth)),
           jrd.depth_to_normal(jc, jnp.asarray(depth)))
    img = r.uniform(0, 1, (tc.height, tc.width, 3)).astype(np.float32)
    ab = r.normal(size=(3, 2)).astype(np.float32) * 0.3
    _close(trd.apply_exposure(torch.as_tensor(img), torch.as_tensor(ab), 1),
           jrd.apply_exposure(jnp.asarray(img), jnp.asarray(ab), 1))


def _models(d):
    f = {k: np.asarray(v, np.float32) for k, v in d.items() if k != "alive"}
    n = f["xyz"].shape[0]
    fields = dict(xyz=f["xyz"], sh_dc=f["sh"][:, :1], sh_rest=f["sh"][:, 1:],
                  log_scale=np.log(f["scale"]), quat=f["quat"] * 1.7,
                  opacity_logit=np.log(f["opacity"] / (1 - f["opacity"]))
                  [:, None].astype(np.float32),
                  normal=f["normal"], offset=f["offset"][:, None])
    jm = jg.init_from_points(np.zeros((4, 3), np.float32),
                             np.zeros((4, 3), np.float32), 2, capacity=n)
    jm = jm.replace(params=jg.GaussianParams(
        **{k: jnp.asarray(v) for k, v in fields.items()}),
        alive=jnp.asarray(d["alive"]), active_sh_degree=jnp.int32(2))
    tm = GaussianModel(params=GaussianParams(
        **{k: torch.as_tensor(v) for k, v in fields.items()}),
        alive=torch.as_tensor(d["alive"]), active_sh_degree=2,
        max_sh_degree=2)
    return jm, tm


@pytest.mark.parametrize("learnt", [True, False])
def test_gaussian_model(learnt):
    jm, tm = _models(_inputs(2, 200))
    for f in ("scale", "opacity", "quat_unit", "sh_coeffs"):
        _close(getattr(tm, f), getattr(jm, f), f)
    _close(tm.smallest_axis(), jm.smallest_axis())
    pos = np.array([0.3, -0.2, -3.0], np.float32)
    for a, b in zip(tm.oriented_normal(torch.as_tensor(pos), learnt),
                    jm.oriented_normal(jnp.asarray(pos), learnt)):
        _close(a, b)


@pytest.mark.parametrize("seed,tile", [(0, (16, 32)), (1, (8, 16))])
def test_preprocess_every_field(seed, tile):
    d = _inputs(seed, 400)
    jm, tm = _models(d)
    jc, tc = _cams()
    nj, oj = jm.oriented_normal(jc.cam_pos)
    nt, ot = tm.oriented_normal(tc.cam_pos)
    sj = jax.jit(jpre.preprocess, static_argnums=(5, 9, 10))(
        jm.params.xyz, jm.scale, jm.quat_unit, jm.opacity, jm.sh_coeffs, 2,
        nj, oj, jc, *tile, alive=jm.alive)
    st = tpre.preprocess(tm.params.xyz, tm.scale, tm.quat_unit, tm.opacity,
                         tm.sh_coeffs, 2, nt, ot, tc, *tile, alive=tm.alive)
    valid = np.asarray(sj.n_tiles) > 0
    assert 50 < valid.sum() < 400
    for f in dataclasses.fields(tpre.Splats2D):
        _close(getattr(st, f.name), getattr(sj, f.name), f.name)
