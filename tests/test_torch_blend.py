"""Blend forward of the PyTorch port against the JAX package.

The plain PyTorch blend (ibgs_tpu_torch/ops/blend.py) is held to the JAX
oracle (ibgs_tpu/ops/blend_oracle.py) in all three modes, on the scenes of
tests/test_blend_parity.py plus its indefinite-conic case, and once to the
Pallas kernel in interpret mode.  Instances come from the JAX package's
preprocess + binning of a numpy-seeded cloud, so both blends read the same
table.  Tolerance: float outputs rtol/atol 1e-5 (the two frameworks'
float32 exp differ by an ulp or so); integer outputs exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.ops import binning as jbin
from ibgs_tpu.ops import blend_oracle as jbo
from ibgs_tpu.ops import preprocess as jpre
from ibgs_tpu.ops.blend_common import BlendConfig as JBlendConfig
from ibgs_tpu.ops.blend_common import Instances
from ibgs_tpu_torch.ops import blend as tblend
from ibgs_tpu_torch.ops.blend_common import BlendConfig
from tests.utils import simple_camera

FIELDS = ("color", "normal", "final_t", "n_contrib", "buf_depth",
          "buf_weight", "buf_contrib")
MODES = {"color": (False, False), "geo": (True, False),
         "depth": (False, True)}


def _cloud(seed, n, spread=0.8):
    """Random splats in front of simple_camera (numpy twin of
    tests/utils.random_cloud), normals facing the camera at z=-3."""
    r = np.random.default_rng(seed)
    xyz = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    scale = np.exp(r.uniform(-3.5, -2.0, (n, 3))).astype(np.float32)
    quat = r.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    normal = r.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    flip = np.where((normal * (np.array([0, 0, -3.0]) - xyz)).sum(-1) < 0,
                    -1.0, 1.0).astype(np.float32)
    return dict(xyz=xyz, scale=scale, quat=quat,
                opacity=r.uniform(0.3, 0.95, n).astype(np.float32),
                sh=r.uniform(-1, 1, (n, 1, 3)).astype(np.float32),
                normal=normal * flip[:, None],
                offset=np.zeros(n, np.float32))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_instances(c, cam, tile_h, tile_w, cap):
    sp = jpre.preprocess(c["xyz"], c["scale"], c["quat"], c["opacity"],
                         c["sh"], 0, c["normal"], c["offset"], cam, tile_h,
                         tile_w)
    bins = jbin.bin_splats(sp, -(-cam.width // tile_w),
                           -(-cam.height // tile_h), cap)
    feats_g = jnp.concatenate(
        [sp.mean2d, sp.conic, sp.opacity[:, None], sp.rgb, sp.plane_normal,
         sp.plane_dist[:, None], jnp.zeros_like(sp.mean2d)], axis=1)
    return (jbin.pack_rows(feats_g, bins), bins.tile_start, bins.tile_stop,
            bins.n_instances)


def _instances(seed, n, W, H, tile_h=16, tile_w=32, cap=512):
    """JAX preprocess + AABB binning + pack_rows → numpy instance table
    (cap, 15), tile ranges, padded size and the camera intrinsics."""
    c = {k: jnp.asarray(v) for k, v in _cloud(seed, n).items()}
    cam = simple_camera(W, H)
    feats, start, stop, total = _jax_instances(c, cam, tile_h, tile_w, cap)
    assert int(total) <= cap
    Wp, Hp = -(-W // tile_w) * tile_w, -(-H // tile_h) * tile_h
    return (np.array(feats), np.array(start), np.array(stop), Wp, Hp,
            tuple(float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy)))


@dataclasses.dataclass
class _Bins:
    tile_start: object
    tile_stop: object


def _oracle(feats, start, stop, Wp, Hp, intr, cfg):
    f = jnp.asarray(feats)
    inst = Instances(mean2d=f[:, 0:2], conic=f[:, 2:5], opacity=f[:, 5],
                     rgb=f[:, 6:9], normal=f[:, 9:12], dist=f[:, 12])
    out = jbo.blend_oracle(inst, _Bins(jnp.asarray(start), jnp.asarray(stop)),
                           Wp, Hp, *intr, cfg)
    return {k: np.asarray(getattr(out, k)) for k in FIELDS}


def _plain(feats, start, stop, Wp, Hp, intr, cfg):
    out = tblend.blend_plain(torch.as_tensor(feats), torch.as_tensor(start),
                             torch.as_tensor(stop), Wp, Hp, *intr, cfg)
    return {k: getattr(out, k).numpy() for k in FIELDS}


def _assert_same(got, want):
    for k in FIELDS:
        if want[k].dtype.kind == "i":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def _cfgs(mode, tile_h=16, tile_w=32, B=4):
    rg, do = MODES[mode]
    return (JBlendConfig(tile_h=tile_h, tile_w=tile_w, buffer_len=B,
                         render_geo=rg, depth_only=do),
            BlendConfig(tile_h=tile_h, tile_w=tile_w, buffer_len=B,
                        render_geo=rg, depth_only=do))


@pytest.mark.parametrize("mode,seed,n,W,H", [
    ("color", 0, 40, 32, 48), ("color", 1, 120, 32, 48),
    ("geo", 2, 60, 48, 32), ("geo", 3, 150, 48, 32),
    ("depth", 4, 80, 32, 32)])
def test_plain_matches_oracle(mode, seed, n, W, H):
    feats, start, stop, Wp, Hp, intr = _instances(seed, n, W, H)
    jcfg, tcfg = _cfgs(mode)
    _assert_same(_plain(feats, start, stop, Wp, Hp, intr, tcfg),
                 _oracle(feats, start, stop, Wp, Hp, intr, jcfg))


@pytest.mark.parametrize("mode", ["color", "geo", "depth"])
def test_plain_matches_oracle_odd_buffer(mode):
    """B = 3 (before part 2 slots, below part 1) on an 8x16 tiling."""
    feats, start, stop, Wp, Hp, intr = _instances(5, 100, 40, 24, 8, 16)
    jcfg, tcfg = _cfgs(mode, 8, 16, 3)
    _assert_same(_plain(feats, start, stop, Wp, Hp, intr, tcfg),
                 _oracle(feats, start, stop, Wp, Hp, intr, jcfg))


@pytest.mark.parametrize("mode", ["color", "geo", "depth"])
def test_plain_matches_oracle_indefinite_conic(mode):
    """An f32-indefinite conic makes power > 0 at some pixels; those pixels
    must be skipped (the case of test_indefinite_conic_grads_finite)."""
    cap = 8
    rng = np.random.default_rng(0)
    feats = np.concatenate([
        np.stack([rng.uniform(4, 28, cap), rng.uniform(2, 14, cap)], 1),
        np.tile([[1.0, 2.0, 1.0]], (cap, 1)),
        np.full((cap, 1), 0.9), rng.uniform(0, 1, (cap, 3)),
        np.tile([[0.1, 0.0, 0.9]], (cap, 1)), np.full((cap, 1), -2.0)],
        axis=1).astype(np.float32)
    start = np.zeros(1, np.int32)
    stop = np.full(1, cap, np.int32)
    intr = (30.0, 30.0, 16.0, 8.0)
    jcfg, tcfg = _cfgs(mode)
    _assert_same(_plain(feats, start, stop, 32, 16, intr, tcfg),
                 _oracle(feats, start, stop, 32, 16, intr, jcfg))


def test_plain_matches_pallas_interpret():
    from ibgs_tpu.ops import blend_pallas

    feats, start, stop, Wp, Hp, intr = _instances(6, 50, 32, 32, cap=256)
    jcfg, tcfg = _cfgs("geo")
    out = blend_pallas.blend_packed(
        jnp.asarray(feats), _Bins(jnp.asarray(start), jnp.asarray(stop)),
        Wp, Hp, *(jnp.float32(v) for v in intr), jcfg)
    _assert_same(_plain(feats, start, stop, Wp, Hp, intr, tcfg),
                 {k: np.asarray(getattr(out, k)) for k in FIELDS})


def test_wrapper_dispatch_cpu_takes_plain():
    """A CPU tensor goes through the plain version: same outputs, and the
    kernel's launch count does not move."""
    feats, start, stop, Wp, Hp, intr = _instances(7, 60, 32, 32)
    _, tcfg = _cfgs("geo")
    before = dict(tblend.LAUNCHES)
    out = tblend.blend_packed(
        torch.as_tensor(feats[:, :13]),
        _Bins(torch.as_tensor(start), torch.as_tensor(stop)), Wp, Hp, *intr,
        tcfg)
    assert tblend.LAUNCHES == before
    _assert_same({k: getattr(out, k).numpy() for k in FIELDS},
                 _plain(feats, start, stop, Wp, Hp, intr, tcfg))
    with pytest.raises(ValueError):
        tblend.blend_packed(
            torch.as_tensor(feats).double(),
            _Bins(torch.as_tensor(start), torch.as_tensor(stop)), Wp, Hp,
            *intr, tcfg)
