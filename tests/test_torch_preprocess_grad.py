"""The port's differentiable `preprocess` (its plain path on the CPU)
against `jax.vjp` of ibgs_tpu.ops.preprocess.preprocess, on the seeded
inputs of tests/torch_preprocess_cases.py: SH degrees 0..3 with the active
degree below the maximum, rgb_override, dead slots, splats behind the
camera and at the near plane, opacity below 1/255, and a band.

Tolerance, per output column: |port - JAX| <= 1e-5 x the column's
largest |JAX value| + 1e-5 x |JAX value| (the frameworks' transcendental
functions and their sums' orders differ by a few ulp, and a splat close to
the camera plane has gradients far larger than the others); integer
outputs exact.

Also: `_Preprocess` on CPU tensors gives exactly the plain forward and
torch autograd's backward of it, and the CUDA wrappers' argument checks
raise before any build is attempted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.core import camera as jcam
from ibgs_tpu.ops import preprocess as jpre
from ibgs_tpu_torch.ops import _cuda
from ibgs_tpu_torch.ops import preprocess as tpre
from ibgs_tpu_torch.ops.rasterize import _band
import torch_preprocess_cases as cases
from tests.test_torch_slice import one_torch_thread  # noqa: F401

TOL = 1e-5
DIFF_OUT = ("mean2d", "conic", "rgb", "plane_normal", "plane_dist")
INT_OUT = ("radius", "rect_min", "rect_max", "n_tiles")


def _columns_close(got, want, msg):
    got = np.asarray(got, np.float64).reshape(len(want), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    scale = np.abs(want).max(0)
    err = np.abs(got - want)
    ok = err <= TOL * scale + TOL * np.abs(want)
    assert ok.all(), (f"{msg}: max excess "
                      f"{(err - TOL * scale - TOL * np.abs(want)).max()}")


def _jax_band(sp, row0, rows, tile_h):
    """The band of ibgs_tpu.ops.rasterize.rasterize, on its Splats2D."""
    tiles_y = -(-rows // tile_h)
    ty0 = row0 // tile_h
    rmin_y = jnp.clip(sp.rect_min[:, 1] - ty0, 0, tiles_y)
    rmax_y = jnp.clip(sp.rect_max[:, 1] - ty0, 0, tiles_y)
    n_tiles = jnp.where(
        sp.n_tiles > 0,
        (sp.rect_max[:, 0] - sp.rect_min[:, 0]) * (rmax_y - rmin_y), 0)
    return sp.replace(rect_min=sp.rect_min.at[:, 1].set(rmin_y),
                      rect_max=sp.rect_max.at[:, 1].set(rmax_y),
                      n_tiles=n_tiles,
                      radius=jnp.where(n_tiles > 0, sp.radius, 0))


@pytest.mark.parametrize("case", list(cases.CASES))
def test_gradients_match_jax_vjp(case):
    deg, active, override, band, _ = cases.CASES[case]
    f, table = cases.inputs(case)
    jc = jcam.look_at_camera(*cases.CAM_ARGS)
    tc = cases.camera()
    th, tw = cases.TILE
    colour = "rgb" if override else "sh"
    diff = ("xyz", "scale", "quat", colour, "normal", "offset")

    def jfwd(*args):
        kw = dict(zip(diff, args))
        sp = jpre.preprocess(
            kw["xyz"], kw["scale"], kw["quat"], jnp.asarray(f["opacity"]),
            None if override else kw["sh"], active, kw["normal"],
            kw["offset"], jc, th, tw, alive=jnp.asarray(f["alive"]),
            rgb_override=kw["rgb"] if override else None)
        return sp, tuple(getattr(sp, k) for k in DIFF_OUT)

    j_args = tuple(jnp.asarray(f[k]) for k in diff)
    j_full = jax.jit(jfwd)(*j_args)[0]
    _, vjp = jax.vjp(jax.jit(lambda *a: jfwd(*a)[1]), *j_args)
    j_grads = vjp((jnp.asarray(table[:, 0:2]), jnp.asarray(table[:, 2:5]),
                   jnp.asarray(table[:, 6:9]), jnp.asarray(table[:, 9:12]),
                   jnp.asarray(table[:, 12])))

    leaves = {k: torch.as_tensor(f[k]).requires_grad_(True) for k in diff}
    t_sp = tpre.preprocess(
        leaves["xyz"], leaves["scale"], leaves["quat"],
        torch.as_tensor(f["opacity"]),
        None if override else leaves["sh"], active, leaves["normal"],
        leaves["offset"], tc, th, tw, alive=torch.as_tensor(f["alive"]),
        rgb_override=leaves["rgb"] if override else None)
    # the cotangents reach preprocess as rasterize's table hands them back
    tab = torch.cat([t_sp.mean2d, t_sp.conic, t_sp.opacity[:, None],
                     t_sp.rgb, t_sp.plane_normal, t_sp.plane_dist[:, None],
                     torch.zeros(len(table), 2)], dim=1)
    t_grads = torch.autograd.grad((tab * torch.as_tensor(table)).sum(),
                                  [leaves[k] for k in diff])

    if band:
        rows = cases.BAND_ROWS
        t_sp = _band(t_sp, cases.BAND_ROW0, -(-rows // th), th)
        j_full = _jax_band(j_full, cases.BAND_ROW0, rows, th)
    for k in DIFF_OUT + ("depth",):
        _columns_close(getattr(t_sp, k).detach(), getattr(j_full, k),
                       f"{case} {k}")
    for k in INT_OUT:
        np.testing.assert_array_equal(getattr(t_sp, k).numpy(),
                                      np.asarray(getattr(j_full, k)),
                                      err_msg=f"{case} {k}")
    valid = np.asarray(j_full.n_tiles) > 0
    assert 20 < valid.sum() < len(valid)
    for k, g, jg in zip(diff, t_grads, j_grads):
        assert torch.isfinite(g).all(), f"{case} d{k}"
        _columns_close(g, jg, f"{case} d{k}")


def _function_vs_plain(case):
    deg, active, override, _, _ = cases.CASES[case]
    f, table = cases.inputs(case)
    cam = cases.camera()
    names = ("xyz", "scale", "quat", "rgb" if override else "sh", "normal",
             "offset")
    outs = []
    for fn in (tpre.preprocess, tpre.preprocess_plain):
        leaves = [torch.as_tensor(f[k]).requires_grad_(True) for k in names]
        x, s, q, col, n, o = leaves
        sp = fn(x, s, q, torch.as_tensor(f["opacity"]),
                None if override else col, active, n, o, cam, *cases.TILE,
                alive=torch.as_tensor(f["alive"]),
                rgb_override=col if override else None)
        tab = torch.cat([sp.mean2d, sp.conic, sp.opacity[:, None], sp.rgb,
                         sp.plane_normal, sp.plane_dist[:, None],
                         torch.zeros(len(table), 2)], dim=1)
        grads = torch.autograd.grad((tab * torch.as_tensor(table)).sum(),
                                    leaves)
        outs.append((sp, grads))
    return outs


@pytest.mark.parametrize("case", ["deg3_active2", "rgb_override"])
def test_function_on_cpu_is_the_plain_version(case):
    """Bit for bit: every Splats2D field of `preprocess` (the Function's
    CPU path) against `preprocess_plain`, and the gradients of one
    cotangent table through it against autograd through the plain
    version; no kernel launch counted."""
    before = dict(_cuda.LAUNCHES)
    (sp, grads), (ref, ref_grads) = _function_vs_plain(case)
    for fld in dataclasses.fields(tpre.Splats2D):
        a, b = getattr(sp, fld.name), getattr(ref, fld.name)
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach()), \
            fld.name
    assert sp.opacity is ref.opacity or torch.equal(sp.opacity, ref.opacity)
    for g, rg in zip(grads, ref_grads):
        assert torch.equal(g, rg)
    assert _cuda.LAUNCHES == before


def test_depth_and_integer_outputs_carry_no_gradient():
    f, _ = cases.inputs("deg0")
    x = torch.as_tensor(f["xyz"]).requires_grad_(True)
    sp = tpre.preprocess(x, torch.as_tensor(f["scale"]),
                         torch.as_tensor(f["quat"]),
                         torch.as_tensor(f["opacity"]),
                         torch.as_tensor(f["sh"]), 0,
                         torch.as_tensor(f["normal"]),
                         torch.as_tensor(f["offset"]), cases.camera(),
                         *cases.TILE)
    assert sp.mean2d.requires_grad and sp.conic.requires_grad
    for k in ("depth",) + INT_OUT:
        assert not getattr(sp, k).requires_grad, k


def _cuda_args(f):
    t = {k: torch.as_tensor(v) for k, v in f.items()}
    return (t["xyz"], t["scale"], t["quat"], t["opacity"], t["sh"], 2,
            t["normal"], t["offset"], cases.camera(), *cases.TILE,
            t["alive"])


def test_cuda_wrappers_check_arguments_before_building(monkeypatch):
    """dtype, shape, contiguity and the SH count raise ValueError before
    the build is asked for; so do CPU tensors, the kernels' device check
    coming last."""
    def no_build(*a, **k):
        raise AssertionError("a build was attempted")
    monkeypatch.setattr(_cuda, "build", no_build)
    monkeypatch.setattr(_cuda, "load", no_build)
    f, table = cases.inputs("deg2_active1")
    good = _cuda_args(f)
    bad = {
        "dtype": (good[0].double(),) + good[1:],
        "shape": (good[0], good[1][:, :2]) + good[2:],
        "contiguity": (good[0], good[1], good[2].t().contiguous().t())
        + good[3:],
        "sh count": good[:4] + (good[4][:, :5].contiguous(),) + good[5:],
        "alive dtype": good[:-1] + (good[-1].float(),),
        "device": good,
    }
    for what, args in bad.items():
        with pytest.raises(ValueError) as info:
            tpre.preprocess_fwd_cuda(*args)
        if what == "device":
            assert "CUDA device" in str(info.value)
        else:
            assert "CUDA device" not in str(info.value), what
    cts = cases.cotangents(torch.as_tensor(table))
    b = (good[0], good[1], good[2], good[4], 2, good[6], good[7], good[8])
    for what, args, c in (
            ("dtype", (b[0].double(),) + b[1:], cts),
            ("sh count", b[:3] + (b[3][:, :3].contiguous(),) + b[4:], cts),
            ("cotangent", b, (cts[0][:, :1],) + cts[1:]),
            ("device", b, cts)):
        with pytest.raises(ValueError) as info:
            tpre.preprocess_bwd_cuda(*args, c)
        assert ("CUDA device" in str(info.value)) == (what == "device"), what
