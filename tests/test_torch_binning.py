"""Tile binning of the PyTorch port against the JAX package.

Both packages bin the same JAX-preprocessed splats (handed across as
numpy).  TileBins must agree integer-exactly on the first
min(total, cap) instances: depth order, rank, gaussian id, tile id,
pre-sort slot, validity, tile_start / tile_stop, n_instances and n_rows —
on the AABB path (with and without the exact tile cull) and the staircase
path, with and without small `cap` / `row_cap` (prefix truncation).
pack_rows forward must agree exactly too.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.ops import binning as jbin
from ibgs_tpu.ops import preprocess as jpre
from ibgs_tpu_torch.ops import binning as tbin
from ibgs_tpu_torch.ops.preprocess import Splats2D
from tests.utils import simple_camera

W, H, TH, TW = 96, 64, 8, 16
TX, TY = W // TW, H // TH
BIG = 1 << 14


_jax_bin = jax.jit(jbin.bin_splats, static_argnums=(1, 2, 3), static_argnames=(
    "with_gauss_id", "tile_h", "tile_w", "staircase", "row_cap"))


@functools.lru_cache(maxsize=1)
def _splats(seed=0, n=300):
    r = np.random.default_rng(seed)
    q = r.normal(size=(n, 4))
    sp = jax.jit(jpre.preprocess, static_argnums=(5, 9, 10))(
        jnp.asarray(r.uniform(-0.9, 0.9, (n, 3)), jnp.float32),
        jnp.asarray(np.exp(r.uniform(-3.0, -1.2, (n, 3))), jnp.float32),
        jnp.asarray(q / np.linalg.norm(q, axis=1, keepdims=True), jnp.float32),
        jnp.asarray(r.uniform(0.02, 0.95, n), jnp.float32),
        jnp.asarray(r.uniform(-1, 1, (n, 1, 3)), jnp.float32), 0,
        jnp.asarray(np.tile([[0.0, 0.0, -1.0]], (n, 1)), jnp.float32),
        jnp.zeros((n,), jnp.float32), simple_camera(W, H), TH, TW)
    thr = jnp.log(jnp.maximum(255.0 * sp.opacity, 1.000001))
    cull_tab = jnp.stack([sp.mean2d[:, 0], sp.mean2d[:, 1], sp.conic[:, 0],
                          sp.conic[:, 1], sp.conic[:, 2], thr], axis=1)
    tsp = Splats2D(**{f.name: torch.as_tensor(np.array(getattr(sp, f.name)))
                      for f in dataclasses.fields(Splats2D)})
    return sp, cull_tab, tsp, torch.as_tensor(np.array(cull_tab))


CASES = {  # name: (staircase, cull, cap, row_cap); 0 = no cap (port)
    "aabb": (False, False, 0, 0),
    "aabb_cull": (False, True, 0, 0),
    "aabb_cap": (False, True, 150, 0),
    "staircase": (True, True, 0, 0),
    "staircase_cap": (True, True, 200, 120),
    "staircase_rowcap": (True, True, 0, 60),
}


def _bins(name):
    stair, cull, cap, row_cap = CASES[name]
    sp, ct, tsp, tct = _splats()
    jb = _jax_bin(sp, TX, TY, cap or BIG, with_gauss_id=True,
                  cull_tab=ct if cull else None, tile_h=TH, tile_w=TW,
                  staircase=stair, row_cap=row_cap or BIG)
    tb = tbin.bin_splats(tsp, TX, TY, cap, cull_tab=tct if cull else None,
                         tile_h=TH, tile_w=TW, staircase=stair,
                         row_cap=row_cap)
    return sp, jb, tsp, tb, cap


@pytest.mark.parametrize("name", list(CASES))
def test_tile_bins_exact(name):
    _sp, jb, _tsp, tb, cap = _bins(name)
    total = int(jb.n_instances)
    n = min(total, cap) if cap else total
    assert tb.n_instances == total
    assert tb.n_rows == int(jb.n_rows)
    assert tb.rank.shape[0] == n
    if cap:
        assert total > cap        # the case really truncates
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))
    for f in ("rank", "gauss_id", "tile_id", "slot", "inst_valid"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f))[:n],
                                      err_msg=f)
    np.testing.assert_array_equal(tb.tile_start.numpy(),
                                  np.asarray(jb.tile_start))
    np.testing.assert_array_equal(tb.tile_stop.numpy(),
                                  np.asarray(jb.tile_stop))
    assert tb.tile_start.dtype == torch.int32


@pytest.mark.parametrize("name", ["aabb_cull", "staircase"])
def test_pack_rows_forward_exact(name):
    sp, jb, tsp, tb, _cap = _bins(name)
    feats = np.random.default_rng(1).normal(
        size=(sp.depth.shape[0], 15)).astype(np.float32)
    n = tb.rank.shape[0]
    np.testing.assert_array_equal(
        tbin.pack_rows(torch.as_tensor(feats), tb).numpy(),
        np.asarray(jbin.pack_rows(jnp.asarray(feats), jb))[:n])


def test_tile_ranges_from_sorted():
    ts = np.array([0, 0, 2, 2, 2, 3, 5, 5], np.int32)
    js, je = jbin.tile_ranges_from_sorted(jnp.asarray(ts), 5, 7)
    s, e = tbin.tile_ranges_from_sorted(torch.as_tensor(ts).long(), 5, 7)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
