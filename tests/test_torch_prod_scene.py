"""The `prod` run's synthetic scene in the port and in the JAX package, on
the CPU: where the two packages' 20k-seed production runs start from.

* The initial log-scales of the 20,000 seeds (drawn from 150,000 ground
  truth points with the scene's own numpy calls) agree between the port
  and the JAX package within 1e-6, and both within 4e-3 of an exact
  float64 3-NN.  `jax.default_matmul_precision("bfloat16")` leaves the
  JAX values as they are (its matmul asks for HIGHEST itself), and a
  single bfloat16 pass would shrink every scale by about e^-2.4: the
  splats would cover far fewer tiles at the first step than the 68,649 /
  68,648 instances the two packages' runs logged.
* The ground truth differs: at 960x544 a view of the 150,000 points
  needs about 3.3M tile instances, and the JAX package's
  `make_synthetic_scene` renders it with `gt_instance_cap` 2^21, so its
  images lack the deepest 36% of the instances.  The port renders the
  ground truth with exact-size lists; rendered under the JAX cap
  (its RasterConfig given that `instance_cap`) it is the JAX images,
  shown here at a small size against the JAX render.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from ibgs_tpu.core import knn as jknn
from ibgs_tpu.core.camera import look_at_camera as jlook_at
from ibgs_tpu.core.sh import rgb_to_sh0 as jrgb_to_sh0
from ibgs_tpu.data import synthetic as jsynthetic
from ibgs_tpu.ops import preprocess as jpreprocess
from ibgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ibgs_tpu_torch.core import knn as tknn
from ibgs_tpu_torch.data import synthetic as tsynthetic
from tests.test_torch_slice import one_torch_thread  # noqa: F401

PROD_GT, PROD_SEED, PROD_W, PROD_H = 150_000, 20_000, 960, 544


def _prod_seeds():
    """The prod scene's seed points: both packages' make_synthetic_scene
    draw the cloud, then the seed indices, then the noise, from one
    default_rng(0) (the ground-truth renders draw nothing)."""
    rng = np.random.default_rng(0)
    pts, _ = tsynthetic._gt_cloud(rng, PROD_GT)
    jpts, _ = jsynthetic._gt_cloud(np.random.default_rng(0), PROD_GT)
    np.testing.assert_array_equal(pts, jpts)
    idx = rng.choice(PROD_GT, size=PROD_SEED, replace=False)
    return pts[idx] + rng.normal(0, 0.01, (PROD_SEED, 3)).astype(np.float32)


def _one_bf16_pass_log_scales(p, n_query, block=1024):
    """The device 3-NN's formula with the matmul's inputs rounded to
    bfloat16 (one bf16 pass, a TPU matmul's default precision), for the
    first `n_query` points."""
    sq = (p * p).sum(-1)
    pb = np.asarray(jnp.asarray(p).astype(jnp.bfloat16).astype(jnp.float32))
    out = []
    for s in range(0, n_query, block):
        d = sq[s:s + block, None] + sq[None] - 2.0 * (pb[s:s + block] @ pb.T)
        d = np.maximum(d, 0.0)
        d[np.arange(len(d)), np.arange(s, s + len(d))] = np.inf
        out.append(np.partition(d, 3, axis=1)[:, :3].mean(-1))
    return np.log(np.sqrt(np.clip(np.concatenate(out), 1e-7, None)))


def test_prod_seed_log_scales_match_jax():
    seeds = _prod_seeds()
    port = tknn.initial_log_scales(torch.as_tensor(seeds)).numpy()
    jax_ls = np.asarray(jknn.initial_log_scales(jnp.asarray(seeds)))
    with jax.default_matmul_precision("bfloat16"):
        jax_bf16_ctx = np.asarray(jknn.initial_log_scales(
            jnp.asarray(seeds)))
    d, _ = cKDTree(seeds.astype(np.float64)).query(
        seeds.astype(np.float64), 4)
    exact = np.log(np.sqrt(np.clip((d[:, 1:] ** 2).mean(-1), 1e-7, None)))

    np.testing.assert_allclose(port, jax_ls, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(jax_bf16_ctx, jax_ls)
    assert np.abs(port[:, 0] - exact).max() < 4e-3
    assert (port == port[:, :1]).all()          # isotropic
    one_pass = _one_bf16_pass_log_scales(seeds, 2048)
    assert exact[:2048].mean() - one_pass.mean() > 2.0


def _jax_gt_instances(n_gt, W, H, k=0):
    """Tile instances that view k of the JAX scene's ground-truth render
    asks for (before its cap), and that cap."""
    import math
    pts, col = jsynthetic._gt_cloud(np.random.default_rng(0), n_gt)
    a = 2 * math.pi * k / 16
    cam = jlook_at([3.0 * math.sin(a) * 0.45, 3.0 * math.cos(a) * 0.45,
                    -3.0], [0, 0, 0], [0, -1, 0], 0.8, 0.8, W, H)
    cfg = JRasterConfig()
    sp = jpreprocess.preprocess(
        jnp.asarray(pts), jnp.full((n_gt, 3), 0.05),
        jnp.tile(jnp.array([1.0, 0, 0, 0]), (n_gt, 1)),
        jnp.full((n_gt,), 0.85), jrgb_to_sh0(jnp.asarray(col))[:, None, :],
        0, jnp.tile(jnp.array([0.0, 0, 1.0]), (n_gt, 1)),
        jnp.zeros((n_gt,)), cam, cfg.tile_h, cfg.tile_w)
    cap = max(1 << 15, 1 << (int(n_gt * 12).bit_length()))
    return int(sp.n_tiles.sum()), cap


def _port_gt_instances(n_gt, W, H, k=0):
    import math

    from ibgs_tpu_torch.core.camera import look_at_camera
    from ibgs_tpu_torch.core.sh import rgb_to_sh0
    from ibgs_tpu_torch.ops import preprocess
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    pts, col = tsynthetic._gt_cloud(np.random.default_rng(0), n_gt)
    a = 2 * math.pi * k / 16
    cam = look_at_camera([3.0 * math.sin(a) * 0.45,
                          3.0 * math.cos(a) * 0.45, -3.0], [0, 0, 0],
                         [0, -1, 0], 0.8, 0.8, W, H, "cpu")
    cfg = RasterConfig()

    def rows(v):
        return torch.tensor([v], dtype=torch.float32).repeat(n_gt, 1)

    sp = preprocess.preprocess(
        torch.as_tensor(pts), torch.full((n_gt, 3), 0.05),
        rows([1.0, 0, 0, 0]), torch.full((n_gt,), 0.85),
        rgb_to_sh0(torch.as_tensor(col))[:, None, :], 0, rows([0.0, 0, 1.0]),
        torch.zeros(n_gt), cam, cfg.tile_h, cfg.tile_w,
        alive=torch.ones(n_gt, dtype=torch.bool))
    return int(sp.n_tiles.sum())


@pytest.mark.parametrize("n_gt,over", [(150_000, True), (1_500_000, False)],
                         ids=["gt150k", "gt1500k"])
def test_prod_gt_instances_against_jax_gt_cap(n_gt, over):
    """The JAX ground truth of the 20k-seed prod scene (150,000 points) is
    cut by its cap; that of the 1M-seed scene (1.5M points) is not.  The
    port's view asks for the same instances and renders them all."""
    n_jax, cap = _jax_gt_instances(n_gt, PROD_W, PROD_H)
    assert _port_gt_instances(n_gt, PROD_W, PROD_H) == n_jax
    assert (n_jax > 1.5 * cap) if over else (n_jax < cap)


def test_gt_instance_cap_matches_jax_ground_truth(monkeypatch):
    """Rendered under the JAX scene's cap, the port's ground truth is the
    JAX scene's, truncation included: 400 points at 64x48 need more
    instances than a cap of 512, so both drop the same deepest splats."""
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    kw = dict(n_views=3, width=64, height=48, n_gt=400, n_seed=50,
              eval_every=3)
    n_jax, _ = _jax_gt_instances(400, 64, 48)
    assert n_jax > 512
    js = jsynthetic.make_synthetic_scene(**kw, gt_instance_cap=512)
    full = tsynthetic.make_synthetic_scene(**kw, device="cpu")
    monkeypatch.setattr(tsynthetic, "RasterConfig",
                        functools.partial(RasterConfig, instance_cap=512))
    capped = tsynthetic.make_synthetic_scene(**kw, device="cpu")
    np.testing.assert_allclose(capped.images, js.images, rtol=0, atol=1e-5)
    np.testing.assert_allclose(capped.test_images, js.test_images, rtol=0,
                               atol=1e-5)
    assert np.abs(full.images - capped.images).max() > 0.05
