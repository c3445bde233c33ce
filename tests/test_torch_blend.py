"""Blend forward and backward of the PyTorch port against the JAX package.

The plain PyTorch blend (ibgs_tpu_torch/ops/blend.py) is held to the JAX
oracle (ibgs_tpu/ops/blend_oracle.py) in all three modes, on the scenes of
tests/test_blend_parity.py plus its indefinite-conic case, and once to the
Pallas kernel in interpret mode.  Instances come from the JAX package's
preprocess + binning of a numpy-seeded cloud, so both blends read the same
table.  Tolerance: float outputs rtol/atol 1e-5 (the two frameworks'
float32 exp differ by an ulp or so); integer outputs exact.

The backward (`blend_bwd_plain`, and the autograd Function around the
blend) is held to the VJP of the Pallas kernel in interpret mode w.r.t.
the 15-column table, with the same seeded cotangents, on the same scenes
in colour and render_geo modes, the indefinite conic, and B = 1, 3, 8:
all 15 columns at rtol 5e-4 / atol 5e-6, the JAX package's own gradient
tolerance (tests/test_blend_parity.py).  The Pallas kernel matches an
empty buffer slot (buf_contrib 0) with position 0, the instance just
before a tile's range in the same 128-row chunk, and hands it that slot's
depth cotangent; real losses give empty slots none, so the seeded depth
cotangent is zero there.  Columns 0-12 are also held to torch autograd of
`blend_plain` (1e-5 relative to each column's largest value).
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
from ibgs_tpu_torch.ops import _cuda
from ibgs_tpu_torch.ops import blend as tblend
from ibgs_tpu_torch.ops.blend_common import BlendConfig
from tests.test_torch_slice import one_torch_thread  # noqa: F401
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
    before = dict(_cuda.LAUNCHES)
    out = tblend.blend_packed(
        torch.as_tensor(feats[:, :13]),
        _Bins(torch.as_tensor(start), torch.as_tensor(stop)), Wp, Hp, *intr,
        tcfg)
    assert _cuda.LAUNCHES == before
    _assert_same({k: getattr(out, k).numpy() for k in FIELDS},
                 _plain(feats, start, stop, Wp, Hp, intr, tcfg))
    with pytest.raises(ValueError):
        tblend.blend_packed(
            torch.as_tensor(feats).double(),
            _Bins(torch.as_tensor(start), torch.as_tensor(stop)), Wp, Hp,
            *intr, tcfg)


@pytest.mark.parametrize("max_threads", [256, 128])
@pytest.mark.parametrize("tile", [(16, 32), (16, 16), (8, 16), (32, 32),
                                  (17, 31), (1, 1024), (3, 5), (16, 64),
                                  (40, 48)])
def test_sub_tile_split_covers_the_tile(tile, max_threads):
    """A kernel's sub-tile split covers the tile with the fewest CTAs of at
    most `max_threads` threads, none of them empty; 16x32 tiles become two
    16x16 CTAs of 256 threads or four 16x8 of 128."""
    th, tw = tile
    if th * tw > 8 * max_threads:
        with pytest.raises(ValueError):
            tblend.sub_tile_split(th, tw, max_threads)
        return
    sy, sx = tblend.sub_tile_split(th, tw, max_threads)
    sh, sw = -(-th // sy), -(-tw // sx)
    assert sh * sy >= th and sw * sx >= tw
    assert (sy - 1) * sh < th and (sx - 1) * sw < tw
    assert tblend.cta_threads(sh, sw) <= max_threads
    assert tblend.cta_threads(sh, sw) % 32 == 0
    fewest = min(a * b for a in range(1, th + 1) for b in range(1, tw + 1)
                 if tblend.cta_threads(-(-th // a), -(-tw // b))
                 <= max_threads)
    assert sy * sx == fewest
    if tile == (16, 32):
        assert (sy, sx) == {256: (1, 2), 128: (1, 4)}[max_threads]


def test_sub_tile_split_rejects_huge_tiles():
    with pytest.raises(ValueError):
        tblend.sub_tile_split(64, 64, tblend.FWD_CTA)


# ---------------------------------------------------------------- backward

_CT_FIELDS = ("color", "normal", "final_t", "buf_depth", "buf_weight")


def _cotangents(seed, Wp, Hp, B, buf_contrib):
    r = np.random.default_rng(seed + 100)
    cts = [r.normal(size=s).astype(np.float32) for s in
           [(Hp, Wp, 3), (Hp, Wp, 3), (Hp, Wp), (Hp, Wp, B), (Hp, Wp, B)]]
    cts[3] = np.where(buf_contrib > 0, cts[3], 0.0).astype(np.float32)
    return cts


@functools.partial(jax.jit, static_argnums=(3, 4, 9))
def _pallas_grad(feats, start, stop, Wp, Hp, fx, fy, cx, cy, cfg, cts):
    from ibgs_tpu.ops import blend_pallas

    def loss(f):
        o = blend_pallas.blend_packed(f, _Bins(start, stop), Wp, Hp, fx, fy,
                                      cx, cy, cfg)
        # (B = 1 buffers come back as (Hp, Wp) from the JAX package)
        return sum((getattr(o, k) * c.reshape(getattr(o, k).shape)).sum()
                   for k, c in zip(_CT_FIELDS, cts))
    return jax.grad(loss)(feats)


def _bwd_case(feats, start, stop, Wp, Hp, intr, mode, seed, th=16, tw=32,
              B=4):
    jcfg, tcfg = _cfgs(mode, th, tw, B)
    args = (torch.as_tensor(feats), torch.as_tensor(start),
            torch.as_tensor(stop), Wp, Hp, *intr, tcfg)
    saved = tblend.blend_plain(*args)
    cts = _cotangents(seed, Wp, Hp, B, saved.buf_contrib.numpy())
    want = np.asarray(_pallas_grad(
        jnp.asarray(feats), jnp.asarray(start), jnp.asarray(stop), Wp, Hp,
        *(jnp.float32(v) for v in intr), jcfg,
        [jnp.asarray(c) for c in cts]))
    got = tblend.blend_bwd_plain(*args, saved,
                                 tuple(torch.as_tensor(c) for c in cts))
    assert got.shape == (feats.shape[0], 16)
    assert float(got[:, 15].abs().max()) == 0.0
    np.testing.assert_allclose(got[:, :15].numpy(), want, rtol=5e-4,
                               atol=5e-6)

    # the autograd Function gives the same rows
    f = torch.as_tensor(feats).requires_grad_(True)
    out = tblend.blend_packed(f, _Bins(args[1], args[2]), Wp, Hp, *intr,
                              tcfg)
    loss = sum((getattr(out, k) * torch.as_tensor(c)).sum()
               for k, c in zip(_CT_FIELDS, cts))
    (g,) = torch.autograd.grad(loss, f)
    total = int(stop[-1])
    np.testing.assert_array_equal(g[:total].numpy(),
                                  got[:total, :15].numpy())
    assert not bool(g[total:].any())
    return got


@pytest.mark.parametrize("mode,seed,n,W,H", [
    ("color", 0, 40, 32, 48), ("color", 1, 120, 32, 48),
    ("geo", 2, 60, 48, 32), ("geo", 3, 150, 48, 32),
    ("color", 7, 50, 32, 32), ("geo", 7, 50, 32, 32)])
def test_bwd_plain_matches_pallas_vjp(mode, seed, n, W, H):
    feats, start, stop, Wp, Hp, intr = _instances(seed, n, W, H)
    got = _bwd_case(feats, start, stop, Wp, Hp, intr, mode, seed)
    assert float(got[:, :9].abs().max()) > 0
    if mode == "geo":
        assert float(got[:, 9:13].abs().max()) > 0
    else:
        assert float(got[:, 9:13].abs().max()) == 0


@pytest.mark.parametrize("B,tile", [(1, (16, 32)), (3, (8, 16)),
                                    (8, (16, 32))])
def test_bwd_plain_matches_pallas_vjp_buffer_lengths(B, tile):
    feats, start, stop, Wp, Hp, intr = _instances(8 + B, 120, 40, 24, *tile)
    _bwd_case(feats, start, stop, Wp, Hp, intr, "geo", B, *tile, B=B)


@pytest.mark.parametrize("mode", ["color", "geo"])
def test_bwd_plain_matches_pallas_vjp_indefinite_conic(mode):
    cap = 8
    rng = np.random.default_rng(0)
    feats = np.concatenate([
        np.stack([rng.uniform(4, 28, cap), rng.uniform(2, 14, cap)], 1),
        np.tile([[1.0, 2.0, 1.0]], (cap, 1)),
        np.full((cap, 1), 0.9), rng.uniform(0, 1, (cap, 3)),
        np.tile([[0.1, 0.0, 0.9]], (cap, 1)), np.full((cap, 1), -2.0),
        np.zeros((cap, 2))], axis=1).astype(np.float32)
    got = _bwd_case(feats, np.zeros(1, np.int32), np.full(1, cap, np.int32),
                    32, 16, (30.0, 30.0, 16.0, 8.0), mode, 3)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("mode", ["color", "geo"])
def test_bwd_plain_matches_torch_autograd(mode):
    feats, start, stop, Wp, Hp, intr = _instances(9, 30, 32, 16)
    n = int(stop[-1])
    _, tcfg = _cfgs(mode)
    f = torch.as_tensor(feats[:n, :13]).requires_grad_(True)
    args = (torch.as_tensor(start), torch.as_tensor(stop), Wp, Hp, *intr,
            tcfg)
    out = tblend.blend_plain(f, *args)
    cts = _cotangents(9, Wp, Hp, 4, out.buf_contrib.numpy())
    loss = sum((getattr(out, k) * torch.as_tensor(c)).sum()
               for k, c in zip(_CT_FIELDS, cts))
    (want,) = torch.autograd.grad(loss, f)
    got = tblend.blend_bwd_plain(
        f.detach(), *args, tblend.blend_plain(f.detach(), *args),
        tuple(torch.as_tensor(c) for c in cts))[:, :13]
    scale = want.abs().amax(0).clamp(min=1e-30)
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-9).all()), \
        ((got - want).abs() / scale).amax(0)


def test_bwd_depth_only_is_zero_and_launches_nothing():
    feats, start, stop, Wp, Hp, intr = _instances(4, 80, 32, 32)
    _, tcfg = _cfgs("depth")
    f = torch.as_tensor(feats).requires_grad_(True)
    before = dict(_cuda.LAUNCHES)
    out = tblend.blend_packed(f, _Bins(torch.as_tensor(start),
                                       torch.as_tensor(stop)), Wp, Hp,
                              *intr, tcfg)
    (g,) = torch.autograd.grad((out.buf_depth * out.buf_weight).sum()
                               + out.final_t.sum(), f)
    assert _cuda.LAUNCHES == before
    assert g.shape == f.shape and float(g.abs().max()) == 0.0
