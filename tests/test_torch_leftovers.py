"""Checkpoint size and the small API functions of the port against the
JAX package.

* `memory` in result_fps_mem.json (the PLY, plus the checkpoint that holds
  the fusion net) of a model directory written by the JAX package and of
  the same state written by the port (`convert.train_state_from_jax_
  checkpoint`, then the port's `save_state` and `save_ply_snapshot`),
  both read by `python -m ibgs_tpu_torch.render`: within 1% of each
  other.  Both packages compress their checkpoints; the archives then
  differ only by the arrays' names and order (2 kB of 276 kB here), while
  an uncompressed checkpoint of this state is 11 times larger.  The port
  reads an uncompressed checkpoint too, bit for bit.
* `core/transforms` (covariance from scale and rotation, the packed
  symmetric form, rotation of directions, the camera centre),
  `core/sh.sh0_to_rgb`, `train/losses` (edge weights, patch offsets and
  homography warps, LNCC) within 1e-6 of the JAX package's on seeded
  inputs (1e-5 relative where a sum of products cancels); the mirrors of
  tests/test_core.py's covariance and SH checks.
* `utils/profiling.annotate` inside a trace, `trace_files` finding the
  capture, `trace(None)` a no-op; `utils/native.available()`.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.core import sh as jsh
from ibgs_tpu.core import transforms as jtf
from ibgs_tpu.core.camera import look_at_camera as jlook_at
from ibgs_tpu.models import aggregation as jagg
from ibgs_tpu.models import gaussians as jg
from ibgs_tpu.train import checkpoint as jckpt
from ibgs_tpu.train import losses as jlosses
from ibgs_tpu.train import trainer as jtr
from ibgs_tpu_torch import convert
from ibgs_tpu_torch import render as trender_cli
from ibgs_tpu_torch.core import sh as tsh
from ibgs_tpu_torch.core import transforms as ttf
from ibgs_tpu_torch.core.camera import look_at_camera
from ibgs_tpu_torch.data import synthetic as tsyn
from ibgs_tpu_torch.models.aggregation import ColorFusionResidualNet
from ibgs_tpu_torch.train import checkpoint as tckpt
from ibgs_tpu_torch.train import losses as tlosses
from ibgs_tpu_torch.utils import native, profiling
from tests.test_torch_slice import one_torch_thread  # noqa: F401

SPEC = ["6", "40", "40", "600", "300"]
IT = 2
MEMORY_RTOL = 0.01


def _jax_state():
    v, w, h, ngt, nseed = (int(x) for x in SPEC)
    scene = tsyn.make_synthetic_scene(n_views=v, width=w, height=h,
                                      n_gt=ngt, n_seed=nseed,
                                      eval_every=max(v // 2, 2),
                                      device="cpu")
    m = jg.init_from_points(scene.points, scene.colors, 2)
    net = jagg.ColorFusionResidualNet()
    net_params = net.init(jax.random.PRNGKey(7), jnp.zeros((4, 4, 3, 7)),
                          jnp.zeros((4, 4, 3)), jnp.zeros((4, 4, 3)))
    app = jnp.zeros((1600, 2))
    return jtr.TrainState(
        model=m, app_ab=app, app_opt=jtr.SideOptState.init(app),
        net_params=net_params, net_opt=jtr.SideOptState.init(net_params),
        spatial_lr_scale=jnp.float32(1.0))


def _memory(path):
    assert trender_cli.main(["-m", path, "--synthetic", "--synthetic_spec",
                             *SPEC, "--skip_train", "--skip_test",
                             "--device", "cpu"]) == 0
    with open(os.path.join(path, "result_fps_mem.json")) as f:
        return json.load(f)["memory"]


def test_checkpoint_memory_matches_jax(tmp_path):
    state = _jax_state()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for d in (jdir, tdir):
        os.makedirs(os.path.join(d, "point_cloud", f"iteration_{IT}"))
    jckpt.save_ply_snapshot(state.model, os.path.join(
        jdir, "point_cloud", f"iteration_{IT}", "point_cloud.ply"))
    jpath = os.path.join(jdir, f"chkpnt{IT}.npz")
    jckpt.save_state(state, IT, jpath)
    tstate, it = convert.train_state_from_jax_checkpoint(
        jpath, ColorFusionResidualNet(32), "cpu")
    tckpt.save_ply_snapshot(tstate.model, os.path.join(
        tdir, "point_cloud", f"iteration_{IT}", "point_cloud.ply"))
    tpath = os.path.join(tdir, f"chkpnt{it}.npz")
    tckpt.save_state(tstate, it, tpath)

    jmem, tmem = _memory(jdir), _memory(tdir)
    assert abs(tmem - jmem) <= MEMORY_RTOL * jmem, (tmem, jmem)

    # an uncompressed checkpoint still loads, bit for bit
    raw = str(tmp_path / "raw.npz")
    np.savez(raw, __iteration=np.int64(it), **tckpt.state_arrays(tstate))
    assert os.path.getsize(raw) > 5 * os.path.getsize(tpath)
    back, it2 = tckpt.load_state(tstate, raw)
    assert it2 == it
    want = tckpt.state_arrays(tstate)
    for k, v in tckpt.state_arrays(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def _quats(r, n):
    q = r.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_covariance_and_packed_form_match_jax():
    r = np.random.default_rng(0)
    q = _quats(r, 10)
    s = np.exp(r.normal(size=(10, 3))).astype(np.float32)
    want = np.asarray(jtf.build_covariance_3d(jnp.asarray(s), jnp.asarray(q)))
    got = ttf.build_covariance_3d(torch.as_tensor(s), torch.as_tensor(q))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.diagonal(got, dim1=-2, dim2=-1)
                               .sum(-1).numpy(), (s ** 2).sum(-1), rtol=1e-5)
    one = ttf.build_covariance_3d(torch.tensor([[0.5, 1.0, 2.0]]),
                                  torch.tensor([[1.0, 0.0, 0.0, 0.0]]))[0]
    np.testing.assert_allclose(one.numpy(), np.diag([0.25, 1.0, 4.0]),
                               atol=1e-6)
    packed = ttf.cov3d_to_sym6(got)
    np.testing.assert_array_equal(
        packed.numpy(),
        np.asarray(jtf.cov3d_to_sym6(jnp.asarray(got.numpy()))))
    np.testing.assert_array_equal(ttf.sym6_to_cov3d(packed).numpy(),
                                  got.numpy())


def test_rotation_and_camera_centre_match_jax():
    r = np.random.default_rng(1)
    jc = jlook_at([0.3, -0.2, -3.0], [0.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                  0.8, 0.8, 64, 48)
    tc = look_at_camera([0.3, -0.2, -3.0], [0.0, 0.0, 0.0],
                        [0.0, -1.0, 0.0], 0.8, 0.8, 64, 48, device="cpu")
    v = r.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ttf.apply_rotation(tc.view, torch.as_tensor(v)).numpy(),
        np.asarray(jtf.apply_rotation(jc.view, jnp.asarray(v))), atol=1e-6)
    c = ttf.camera_center_from_view(tc.view).numpy()
    np.testing.assert_allclose(
        c, np.asarray(jtf.camera_center_from_view(jc.view)), atol=1e-6)
    np.testing.assert_allclose(c, tc.cam_pos.numpy(), atol=1e-5)


def test_sh0_to_rgb_matches_jax():
    rgb = np.random.default_rng(2).uniform(size=(5, 3)).astype(np.float32)
    sh0 = tsh.rgb_to_sh0(torch.as_tensor(rgb))
    np.testing.assert_allclose(tsh.sh0_to_rgb(sh0).numpy(), rgb, rtol=1e-6)
    np.testing.assert_allclose(
        tsh.sh0_to_rgb(sh0).numpy(),
        np.asarray(jsh.sh0_to_rgb(jnp.asarray(sh0.numpy()))), atol=1e-7)


def test_patch_losses_match_jax():
    r = np.random.default_rng(3)
    img = r.uniform(size=(12, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.image_gradient_weight(torch.as_tensor(img)).numpy(),
        np.asarray(jlosses.image_gradient_weight(jnp.asarray(img))),
        atol=1e-6)
    off = tlosses.patch_offsets(3)
    np.testing.assert_array_equal(off.numpy(),
                                  np.asarray(jlosses.patch_offsets(3)))
    assert off.shape == (1, 49, 2)
    H = (np.eye(3) + r.normal(size=(4, 3, 3)) * 0.05).astype(np.float32)
    uv = (r.uniform(0, 30, (4, 1, 2)) + off.numpy()).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.patch_warp(torch.as_tensor(H), torch.as_tensor(uv)).numpy(),
        np.asarray(jlosses.patch_warp(jnp.asarray(H), jnp.asarray(uv))),
        rtol=1e-5, atol=1e-5)
    ref = r.uniform(size=(6, 49)).astype(np.float32)
    nea = (ref * 0.7 + r.uniform(size=(6, 49)) * 0.3).astype(np.float32)
    nea[0] = ref[0]                      # a perfect match: ncc 0, masked
    t_ncc, t_mask = tlosses.lncc(torch.as_tensor(ref), torch.as_tensor(nea))
    j_ncc, j_mask = jlosses.lncc(jnp.asarray(ref), jnp.asarray(nea))
    np.testing.assert_allclose(t_ncc.numpy(), np.asarray(j_ncc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    assert t_mask[0, 0] and t_ncc.shape == (6, 1)


def test_trace_annotations_and_files(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        with profiling.step_annotation("bench_step", 0):
            with profiling.annotate("inner"):
                torch.ones(8).sum()
    files = profiling.trace_files(d)
    assert files, "no trace written"
    with open(files[0]) as f:
        assert "inner" in f.read()
    assert profiling.trace_files(str(tmp_path / "none")) == []
    with profiling.trace(None):
        pass


@pytest.mark.parametrize("cxx", ["g++", "/nonexistent/c++"])
def test_native_available(cxx, monkeypatch, tmp_path):
    if cxx != "g++":
        # a build that cannot run: available() says no, load() raises
        monkeypatch.setenv("CXX", cxx)
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(native, "_lib", None)
        assert native.available() is False
        with pytest.raises(RuntimeError, match="cannot run"):
            native.load()
    else:
        assert native.available() is True
