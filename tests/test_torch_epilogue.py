"""IBR epilogue of the PyTorch port against the JAX package.

Both packages get the same numpy blend outputs (a near-planar median
buffer with empty slots) and S=3 source views whose images spill outside
[0, 1], so the rgb10 quantisation of the colour tables is exercised.
Tolerance: float fields rtol/atol 1e-5; integer fields exact.

Gradients: the hand-written VJP of `warp_views` against the JAX package's
`_warp_views` VJP (rgb10-packed tables on the JAX side) and against torch
autograd of `warp_views_plain`; and the gradient of a loss that reads
every float field of IBROutputs w.r.t. the buffer depths and weights
against `jax.grad` through `ibr_epilogue`, which stops the gradient at
the source views, `camera_ray`, `cam_feat`, `min_depth_diff`,
`valid_src_weight` and the occlusion test.  Tolerance rtol 1e-4 and atol
1e-5 x max |gradient| for the warp; atol 1e-4 x max |gradient| for the
whole epilogue, whose d median / d weight = (depth - median) / sum of
weights cancels about two digits on depths of 3 +- 0.03 (the two
packages round the sums differently).  A gradient that leaks through a
stopped output differs by O(max |gradient|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.ops import epilogue as jep
from ibgs_tpu.ops.blend_common import BlendOutputs as JBlendOutputs
from ibgs_tpu_torch.core.camera import look_at_camera
from ibgs_tpu_torch.ops import epilogue as tep
from ibgs_tpu_torch.ops.blend_common import BlendOutputs
from tests.test_torch_slice import one_torch_thread  # noqa: F401
from tests.utils import simple_camera

W, H, B, S = 48, 32, 4, 3


def _close(got, want, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=msg)


def _blend(seed):
    r = np.random.default_rng(seed)
    used = r.uniform(size=(H, W, B)) < 0.7
    bw = np.where(used, r.uniform(0.01, 0.5, (H, W, B)), 0.0)
    bd = np.where(used, 3.0 + r.normal(size=(H, W, B)) * 0.03, 0.0)
    return dict(
        color=r.uniform(size=(H, W, 3)), normal=r.normal(size=(H, W, 3)),
        final_t=r.uniform(size=(H, W)),
        n_contrib=r.integers(0, 50, (H, W)).astype(np.int32),
        buf_depth=bd, buf_weight=bw,
        buf_contrib=np.where(used, r.integers(1, 50, (H, W, B)), 0
                             ).astype(np.int32))


def _sources(seed):
    r = np.random.default_rng(seed)
    r2s = np.tile(np.eye(4), (S, 1, 1))
    r2s[:, :3, 3] = r.normal(size=(S, 3)) * [0.05, 0.05, 0.0]
    depths = np.stack([np.full((H, W), 3.0),
                       3.0 + r.normal(size=(H, W)) * 0.03,
                       np.full((H, W), 2.0)])
    return dict(images=r.uniform(-0.1, 1.1, (S, H, W, 3)), depths=depths,
                ref_to_src=r2s, cam_pos=r.normal(size=(S, 3)))


def _f32(d):
    return {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
            for k, v in d.items()}


@pytest.mark.parametrize("seed,count", [(0, 3), (1, 2)])
def test_ibr_epilogue(seed, count):
    bl, src = _f32(_blend(seed)), _f32(_sources(seed + 10))
    jc = simple_camera(W, H)
    tc = look_at_camera([0.0, 0.0, -3.0], [0.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                        0.8, 0.8, W, H, device="cpu")
    jout = jax.jit(jep.ibr_epilogue)(
        JBlendOutputs(**{k: jnp.asarray(v) for k, v in bl.items()}), jc,
        jep.SourceViews(count=jnp.int32(count),
                        **{k: jnp.asarray(v) for k, v in src.items()}))
    tout = tep.ibr_epilogue(
        BlendOutputs(**{k: torch.as_tensor(v) for k, v in bl.items()}), tc,
        tep.SourceViews(count=count,
                        **{k: torch.as_tensor(v) for k, v in src.items()}))
    n_valid = (np.asarray(jout.valid_src_index) >= 0).sum(0)
    assert n_valid.max() >= 2 and n_valid.min() < count   # mixed validity
    for f in dataclasses.fields(tep.IBROutputs):
        _close(getattr(tout, f.name), getattr(jout, f.name), f.name)
    _close(tep.median_depth_only(
        BlendOutputs(**{k: torch.as_tensor(v) for k, v in bl.items()})),
        jep.median_depth_only(
            JBlendOutputs(**{k: jnp.asarray(v) for k, v in bl.items()})))


def test_rgb10_quantisation_and_bilinear():
    r = np.random.default_rng(3)
    img = r.uniform(-0.2, 1.2, (9, 11, 3)).astype(np.float32)
    packed = jep.pack_rgb10(jnp.asarray(img))
    want = np.stack(jep._unpack_rgb10(packed), -1)
    got = tep.quantize_rgb10(torch.as_tensor(img)).numpy()
    np.testing.assert_array_equal(got, want)
    u = r.uniform(-2, 13, (5, 7)).astype(np.float32)
    v = r.uniform(-2, 11, (5, 7)).astype(np.float32)
    for im in (img, img[..., 0]):
        _close(tep.bilinear_sample(torch.as_tensor(im), torch.as_tensor(u),
                                   torch.as_tensor(v)),
               jep.bilinear_sample(jnp.asarray(im), jnp.asarray(u),
                                   jnp.asarray(v)))


def _warp_inputs(seed):
    bl, src = _f32(_blend(seed)), _f32(_sources(seed + 10))
    jc = simple_camera(W, H)
    bd = np.ascontiguousarray(np.transpose(bl["buf_depth"], (2, 0, 1)))
    bw = np.ascontiguousarray(np.transpose(bl["buf_weight"], (2, 0, 1)))
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    intr = [float(np.float32(v)) for v in (jc.fx, jc.fy, jc.cx, jc.cy)]
    pdx = ((gx - np.float32(intr[2])) / np.float32(intr[0])).astype(np.float32)
    pdy = ((gy - np.float32(intr[3])) / np.float32(intr[1])).astype(np.float32)
    r = np.random.default_rng(seed + 20)
    cts = (r.normal(size=(S, H, W, 3)).astype(np.float32),
           r.normal(size=(S, H, W)).astype(np.float32))
    return bd, bw, src, pdx, pdy, intr, cts


def _close_grad(got, want, msg, atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=atol * np.abs(want).max(), err_msg=msg)


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_views_vjp(seed):
    bd, bw, src, pdx, pdy, intr, cts = _warp_inputs(seed)
    tables = jnp.stack([jep.pack_bilinear_corners_rgb10(
        jnp.asarray(src["images"][s])).reshape(H, W, 4) for s in range(S)])
    _, vjp = jax.vjp(
        lambda d, w: jep._warp_views(d, w, tables,
                                     jnp.asarray(src["ref_to_src"]),
                                     jnp.asarray(pdx), jnp.asarray(pdy),
                                     jnp.asarray(intr, jnp.float32)),
        jnp.asarray(bd), jnp.asarray(bw))
    want_d, want_w = vjp(tuple(jnp.asarray(c) for c in cts))

    t = dict(tables=tep.quantize_rgb10(torch.as_tensor(src["images"])),
             r2s=torch.as_tensor(src["ref_to_src"]),
             pdx=torch.as_tensor(pdx), pdy=torch.as_tensor(pdy))
    grads = {}
    for name, fn in (("vjp", tep.warp_views), ("plain", tep.warp_views_plain)):
        d = torch.as_tensor(bd).requires_grad_(True)
        w = torch.as_tensor(bw).requires_grad_(True)
        wsc, ws = fn(d, w, t["tables"], t["r2s"], t["pdx"], t["pdy"], *intr)
        loss = (wsc * torch.as_tensor(cts[0])).sum() \
            + (ws * torch.as_tensor(cts[1])).sum()
        grads[name] = [x.numpy() for x in torch.autograd.grad(loss, [d, w])]
    assert np.abs(np.asarray(want_d)).max() > 0
    for name, (gd, gw) in grads.items():
        _close_grad(gd, want_d, f"{name} dbd")
        _close_grad(gw, want_w, f"{name} dbw")


def test_epilogue_gradient_stops_match_jax():
    """A loss over every float field of IBROutputs: its gradient w.r.t. the
    buffer depths and weights flows only where the JAX package's does."""
    bl, src = _f32(_blend(0)), _f32(_sources(10))
    r = np.random.default_rng(30)
    weights = {k: r.normal(size=s).astype(np.float32) for k, s in (
        ("median_depth", (H, W)), ("camera_ray", (H, W, 3)),
        ("warped_image", (S, H, W, 3)), ("cam_feat", (S, H, W, 4)),
        ("min_depth_diff", (H, W)), ("valid_src_weight", (S, H, W)))}
    jc = simple_camera(W, H)
    tc = look_at_camera([0.0, 0.0, -3.0], [0.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                        0.8, 0.8, W, H, device="cpu")

    def jloss(bd, bw):
        b = JBlendOutputs(**{k: jnp.asarray(v) for k, v in bl.items()})
        out = jep.ibr_epilogue(b.replace(buf_depth=bd, buf_weight=bw), jc,
                               jep.SourceViews(count=jnp.int32(3), **{
                                   k: jnp.asarray(v) for k, v in src.items()}))
        return sum((getattr(out, k) * w).sum() for k, w in weights.items())

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(bl["buf_depth"]),
                                           jnp.asarray(bl["buf_weight"]))
    bd = torch.as_tensor(bl["buf_depth"]).requires_grad_(True)
    bw = torch.as_tensor(bl["buf_weight"]).requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in bl.items()}
    tb.update(buf_depth=bd, buf_weight=bw)
    out = tep.ibr_epilogue(BlendOutputs(**tb), tc, tep.SourceViews(
        count=3, **{k: torch.as_tensor(v) for k, v in src.items()}))
    loss = sum((getattr(out, k) * torch.as_tensor(w)).sum()
               for k, w in weights.items())
    got = torch.autograd.grad(loss, [bd, bw])
    for name, g, w in zip(("buf_depth", "buf_weight"), got, want):
        _close_grad(g.numpy(), w, name, atol=1e-4)
