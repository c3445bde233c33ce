"""IBR epilogue of the PyTorch port against the JAX package.

Both packages get the same numpy blend outputs (a near-planar median
buffer with empty slots) and S=3 source views whose images spill outside
[0, 1], so the rgb10 quantisation of the colour tables is exercised.
Tolerance: float fields rtol/atol 1e-5; integer fields exact.
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
