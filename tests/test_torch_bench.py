"""The port's benchmark (`ibgs_tpu_torch/bench.py`) against bench.py, on
the CPU (JAX with the oracle backend).

* the random scene: its source images, their centres and the ground
  truth are bench.py's numpy draws bit for bit, in bench.py's call order
  (two sizes in turn); its model equals JAX's `init_from_points` on the
  same cloud, log-scales within 1e-4 (the device KNN's float32 form, as
  tests/test_torch_densify.py holds it), every other field exactly;
* one bench step at 3,000 splats, 128x64, staircase on, through both
  packages on one model: the loss within 1e-5 relative, Σ‖g‖² within
  1e-4 relative, the render-mode sum within 1e-5 relative, the instance
  and row counts exactly;
* the bundle: `model_from_raw` equals bench._model_from_raw on
  bench_bundle.npz exactly, and the resize it uses (`convert._resize`)
  to 1920x1088 equals
  bench._resize_hwc within 1e-5 (images, ground truth; the depths, which
  reach 1.3e5, within 1e-5 + 4 float32 ulps: the two bilinear sums round
  differently);
* the CLI: `python -m ibgs_tpu_torch.bench --device cpu` prints one line
  with bench.py's keys; without `--device` and without a card it raises,
  naming `--device cpu`.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.models.gaussians import init_from_points as j_init
from ibgs_tpu.ops.epilogue import SourceViews as JSourceViews
from ibgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ibgs_tpu.renderer import render_view as j_render_view
from ibgs_tpu.train import losses as jlosses
from ibgs_tpu_torch import bench as tb
from ibgs_tpu_torch import convert
from ibgs_tpu_torch.models.gaussians import (PARAM_FIELDS, GaussianModel,
                                             GaussianParams)
from ibgs_tpu_torch.ops.rasterize import RasterConfig
from tests.test_torch_slice import one_torch_thread  # noqa: F401
from tests.utils import simple_camera as j_simple_camera

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N, W, H, S = 3000, 128, 64, 4


def _cloud(n):
    """bench.py's build_random_model draws (:145-156)."""
    r = np.random.default_rng(0)
    pts = (r.random((n, 3)) * 2.0 - 1.0).astype(np.float32)
    pts[:, 2] *= 0.3
    return pts, r.random((n, 3)).astype(np.float32)


def _jax_inputs(rng, W, H):
    """bench.py's make_inputs for the random scene (:187-197)."""
    cam = j_simple_camera(W, H)
    src = JSourceViews(
        images=jnp.asarray(rng.random((S, H, W, 3)), jnp.float32),
        depths=jnp.full((S, H, W), 3.0, jnp.float32),
        ref_to_src=jnp.tile(jnp.eye(4)[None], (S, 1, 1)),
        cam_pos=jnp.asarray(rng.random((S, 3)) * 0.1, jnp.float32),
        count=jnp.int32(S))
    return cam, src, jnp.asarray(rng.random((H, W, 3)), jnp.float32)


def test_random_scene_is_bench_py_draws():
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    for w, h in ((W, H), (64, 32)):
        jcam, jsrc, jgt = _jax_inputs(rj, w, h)
        cam, src, gt = tb.make_inputs(rt, None, w, h, "cpu")
        np.testing.assert_array_equal(src.images.numpy(),
                                      np.asarray(jsrc.images))
        np.testing.assert_array_equal(src.cam_pos.numpy(),
                                      np.asarray(jsrc.cam_pos))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(jgt))
        np.testing.assert_array_equal(src.depths.numpy(),
                                      np.asarray(jsrc.depths))
        np.testing.assert_array_equal(src.ref_to_src.numpy(),
                                      np.asarray(jsrc.ref_to_src))
        assert src.count == S
        np.testing.assert_allclose(cam.full_proj.numpy(),
                                   np.asarray(jcam.full_proj), rtol=0,
                                   atol=1e-6)

    cap = tb.round_up(1.31 * N, 1024)
    tm = tb.random_model(N, cap, "cpu")
    jm = j_init(*_cloud(N), max_sh_degree=2, capacity=cap)
    assert tm.capacity == cap == jm.capacity
    assert tm.active_sh_degree == int(jm.active_sh_degree) == 0
    np.testing.assert_array_equal(tm.alive.numpy(), np.asarray(jm.alive))
    for k in PARAM_FIELDS:
        want = np.asarray(getattr(jm.params, k))
        got = getattr(tm.params, k).numpy()
        if k == "log_scale":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_bench_step_matches_bench_py():
    cap = tb.round_up(1.31 * N, 1024)
    jm = j_init(*_cloud(N), max_sh_degree=2, capacity=cap)
    jcam, jsrc, jgt = _jax_inputs(np.random.default_rng(0), W, H)
    # snug caps, as bench.py sizes them (6,658 instances, 4,723 rows): the
    # oracle scans every slot of the cap
    jcfg = JRasterConfig(instance_cap=8192, backend="oracle",
                         staircase_cull=True, row_cap=8192)

    def loss_fn(params):
        m = jm.replace(params=params)
        res, _ = j_render_view(m, jcam, jcfg, jnp.zeros(3), src=jsrc,
                               render_geo=True, return_depth_normal=False)
        loss = (jlosses.dssim_l1(res.render, jgt)
                + 0.1 * jnp.abs(res.ibr.warped_image).mean()
                + 1e-3 * res.median_depth.mean())
        fwd = (res.render.sum() + res.median_depth.sum()
               + res.ibr.warped_image.sum())
        return loss, (fwd, res.n_instances, res.n_rows)

    (jloss, (jfwd, jni, jnr)), g = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jm.params)
    jg2 = float(sum(jnp.sum(x * x) for x in jax.tree.leaves(g)))

    model = GaussianModel(
        params=GaussianParams(**{k: torch.tensor(np.asarray(
            getattr(jm.params, k))) for k in PARAM_FIELDS}),
        alive=torch.tensor(np.asarray(jm.alive)), active_sh_degree=0,
        max_sh_degree=2)
    cam, src, gt = tb.make_inputs(np.random.default_rng(0), None, W, H,
                                  "cpu")
    cfg = RasterConfig(staircase_cull=True)
    eps = torch.zeros(())
    g2, res, loss = tb.step_value(model, cam, cfg, src, gt, eps, "train")
    assert (res.n_instances, res.n_rows) == (int(jni), int(jnr))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(g2), jg2, rtol=1e-4)
    fwd, _, _ = tb.step_value(model, cam, cfg, src, gt, eps, "render")
    np.testing.assert_allclose(float(fwd), float(jfwd), rtol=1e-5)


def test_bundle_model_and_resize_match_bench_py():
    from bench import _model_from_raw, _resize_hwc

    d = dict(np.load(os.path.join(ROOT, "bench_bundle.npz")))
    n = d["xyz"].shape[0]
    cap = tb.round_up(1.31 * n, 1024)
    jm = _model_from_raw(d, cap)
    tm = tb.model_from_raw(d, cap, "cpu")
    assert tm.active_sh_degree == int(jm.active_sh_degree) == 2
    np.testing.assert_array_equal(tm.alive.numpy(), np.asarray(jm.alive))
    for k in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(tm.params, k).numpy(),
                                      np.asarray(getattr(jm.params, k)),
                                      err_msg=k)

    Hb, Wb = 1088, 1920
    for img, rtol in ((d["gt"], 0), (d["src_images"], 0),
                      (d["src_depths"][..., None],
                       4 * np.finfo(np.float32).eps)):
        got = convert._resize(img, Hb, Wb, "cpu").numpy()
        np.testing.assert_allclose(got, _resize_hwc(img, Hb, Wb), rtol=rtol,
                                   atol=1e-5)
    same = convert._resize(d["gt"], *d["gt"].shape[:2], "cpu")
    np.testing.assert_array_equal(same.numpy(), d["gt"])
    cam, src, gt = tb.make_inputs(None, d, Wb, Hb, "cpu")
    assert gt.shape == (Hb, Wb, 3) and src.depths.shape[1:] == (Hb, Wb)
    assert src.count == int(d["src_count"])


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
ROW_KEYS = {"config", "resolution", "splats", "step_ms", "mpix_s",
            "vs_baseline", "first_s", "n_instances", "n_rows",
            "device_busy_ms", "idle_share", "launches", "blend_launches",
            "warp_launches", "preprocess_launches", "max_memory_allocated"}


def test_bench_cli_prints_bench_py_schema():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "ibgs_tpu_torch.bench", "--device", "cpu",
         "--n", str(N), "--width", str(W), "--height", str(H), "--iters",
         "1", "--repeats", "1"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert set(r) == BENCH_KEYS
    assert r["metric"] == ("fwd+bwd pixels/s/chip (IBGS geo render, "
                           "128x64, random 3k splats)")
    assert r["unit"] == "pixels/s" and r["value"] > 0
    assert r["detail"]["backend"] == "plain"
    assert r["detail"]["device"]["name"] == "cpu"
    (row,) = r["detail"]["configs"]
    assert ROW_KEYS <= set(row)
    assert row["resolution"] == "128x64" and row["splats"] == N
    assert np.isfinite(row["value"]) and row["n_instances"] > 0
    # no device number is measured on the CPU
    assert row["device_busy_ms"] is None and "profile_error" in row


def test_bench_without_a_card_names_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tb.main(["--n", "1000", "--iters", "1"])
