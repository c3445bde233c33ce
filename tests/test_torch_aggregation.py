"""Colour-fusion net and fuse_color of the PyTorch port against the JAX
package, with the Flax weights carried across by
ibgs_tpu_torch.convert.fusion_net_from_flax.

Weights: a Flax init plus numpy noise on every leaf (so biases are not
all zero).  Everything runs in float32; tolerance atol 1e-4 (convolution
sums in another order), at odd and even image sizes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.models import aggregation as jagg
from ibgs_tpu_torch import convert
from ibgs_tpu_torch.models import aggregation as tagg

S = 3
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _params(mode):
    net = jagg.ColorFusionResidualNet(feat_aggregate_mode=mode)
    x = jnp.zeros((8, 8, S, 7))
    p = net.init(jax.random.PRNGKey(0), x, jnp.zeros((8, 8, 3)),
                 jnp.zeros((8, 8, 3)))
    r = np.random.default_rng(1)
    p = jax.tree.map(lambda a: np.asarray(a) + r.normal(
        size=a.shape).astype(np.float32) * 0.05, p)
    return net, p, convert.fusion_net_from_flax(p, mode, device="cpu")


def _inputs(H, W, seed=0):
    r = np.random.default_rng(seed)
    valid = r.uniform(size=(S, H, W, 1)) < 0.7
    f32 = np.float32
    return dict(
        render=r.uniform(size=(H, W, 3)).astype(f32),
        warped=(r.uniform(size=(S, H, W, 3)) * valid).astype(f32),
        feat=(r.normal(size=(S, H, W, 4)) * valid).astype(f32),
        ray=r.normal(size=(H, W, 3)).astype(f32),
        mdd=r.uniform(size=(H, W)).astype(f32),
        first=valid[0, ..., 0].astype(np.int32))


@pytest.mark.parametrize("H,W,mode", [(20, 28, "mean"), (13, 19, "max")])
def test_fusion_net(H, W, mode):
    net, p, tnet = _params(mode)
    r = np.random.default_rng(2)
    vf = r.normal(size=(H, W, S, 7)).astype(np.float32)
    ray = r.normal(size=(H, W, 3)).astype(np.float32)
    rend = r.uniform(size=(H, W, 3)).astype(np.float32)
    want = jax.jit(net.apply)(p, jnp.asarray(vf), jnp.asarray(ray),
                              jnp.asarray(rend))
    with torch.no_grad():
        got = tnet(torch.as_tensor(vf), torch.as_tensor(ray),
                   torch.as_tensor(rend))
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("H,W,exposure,scale", [
    (20, 28, False, 1.0), (13, 19, True, 1.0), (20, 28, False, 0.5)])
def test_fuse_color(H, W, exposure, scale):
    net, p, tnet = _params("mean")
    d = _inputs(H, W)
    want = jax.jit(jagg.fuse_color, static_argnums=(0, 9, 10, 11, 12))(
        net, p, jnp.asarray(d["render"]), jnp.asarray(d["warped"]),
        jnp.asarray(d["feat"]), jnp.asarray(d["ray"]), jnp.asarray(d["mdd"]),
        jnp.asarray(d["first"]), jnp.float32(1.0), 2, exposure, scale, False)
    with torch.no_grad():
        got = tagg.fuse_color(
            tnet, *(torch.as_tensor(d[k]) for k in (
                "render", "warped", "feat", "ray", "mdd", "first")),
            1.0, 2, exposure, scale, False)
    for k in ("image_pred", "residual", "valid_warp_mask", "exposed_render",
              "any_valid"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)


def test_mixed_precision_runs_bf16_autocast():
    """With enable_mix_precision the net runs under bf16 autocast and the
    residual comes back float32, close to the float32 result."""
    _net, _p, tnet = _params("mean")
    d = _inputs(16, 24, seed=5)
    args = [torch.as_tensor(d[k]) for k in (
        "render", "warped", "feat", "ray", "mdd", "first")]
    with torch.no_grad():
        lo = tagg.fuse_color(tnet, *args, 1.0, 2, False, 1.0, True)
        hi = tagg.fuse_color(tnet, *args, 1.0, 2, False, 1.0, False)
    assert lo["residual"].dtype == torch.float32
    assert float((lo["residual"] - hi["residual"]).abs().max()) < 0.1
