"""The port's evaluation modules against ibgs_tpu on the same seeded
numpy inputs (CPU, JAX on the CPU).

* camera paths: `ellipse_path` (a ring and a 2-camera degenerate case),
  `interpolate_cameras`, `perturbed_camera`: view / projection matrices
  and intrinsics within 1e-6;
* `TSDFVolume.integrate` over 3 ray-cast views of a plane and of a
  sphere: `weight` exact, `tsdf` and `color` within 1e-6 (they agree bit
  for bit: the port forms XLA's fused multiply-adds in float64), chunked
  and whole integration identical tensors;
* `marching_cubes`, `post_process_mesh`: identical arrays;
  `save_mesh_ply` byte-identical (with and without colours),
  `load_mesh_ply` of the port and of `scripts/eval_geometry.py` (the JAX
  package's reader) give the same arrays;
* `filter_depth_by_view_angle`: exact;
* `evaluate_dirs` / `evaluate_model_dir`: every JSON value within 1e-6;
* LPIPS with the seeded random weights of tests/test_lpips_parity.py:
  within 1e-5 relative of `ibgs_tpu.eval.lpips.LPIPS`, 0 for equal images;
* `render_video` without cv2 writes `n_frames` PNGs.

The render CLI, `render_split`, the test-time dump and the TSDF mesh
through it are compared in tests/test_torch_eval_cli.py.
"""
import builtins
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.core import camera as jcam
from ibgs_tpu.eval import lpips as jlpips
from ibgs_tpu.eval import metrics as jmetrics
from ibgs_tpu.eval import render_driver as jrd
from ibgs_tpu.eval import tsdf as jtsdf
from ibgs_tpu_torch.core import camera as tcam
from ibgs_tpu_torch.eval import lpips as tlpips
from ibgs_tpu_torch.eval import metrics as tmetrics
from ibgs_tpu_torch.eval import render_driver as trd
from ibgs_tpu_torch.eval import tsdf as ttsdf
from ibgs_tpu_torch.utils import image_io
from tests.test_lpips_parity import _random_weights
from tests.test_torch_slice import one_torch_thread  # noqa: F401

CAM_TOL = 1e-6
TSDF_TOL = 1e-6
JSON_TOL = 1e-6
LPIPS_RTOL = 1e-5


def _ring(pkg, n, W=48, H=32):
    eyes = [[1.3 * np.sin(2 * np.pi * k / n), 0.4 * np.cos(2 * np.pi * k / n),
             -3.0] for k in range(n)]
    if pkg is jcam:
        return [jcam.look_at_camera(e, [0, 0, 0], [0, -1, 0], 0.8, 0.6, W, H)
                for e in eyes]
    return [tcam.look_at_camera(e, [0, 0, 0], [0, -1, 0], 0.8, 0.6, W, H,
                                "cpu") for e in eyes]


def _assert_cams_close(t, j):
    assert (t.width, t.height) == (j.width, j.height)
    for k in ("view", "proj", "full_proj", "cam_pos"):
        np.testing.assert_allclose(getattr(t, k).numpy(),
                                   np.asarray(getattr(j, k)), rtol=0,
                                   atol=CAM_TOL, err_msg=k)
    for k in ("fx", "fy", "cx", "cy", "tan_fovx", "tan_fovy"):
        assert abs(getattr(t, k) - float(getattr(j, k))) <= CAM_TOL * max(
            1.0, abs(float(getattr(j, k)))), k


@pytest.mark.parametrize("n", [6, 2])
def test_camera_paths_match_jax(n):
    jc, tc = _ring(jcam, n), _ring(tcam, n)
    for a, b in zip(tcam.ellipse_path(tc, n_frames=7, z_variation=0.3),
                    jcam.ellipse_path(jc, n_frames=7, z_variation=0.3)):
        _assert_cams_close(a, b)
    _assert_cams_close(tcam.interpolate_cameras(tc[0], tc[1], 0.3),
                       jcam.interpolate_cameras(jc[0], jc[1], 0.3))
    _assert_cams_close(
        tcam.perturbed_camera(tc[1], np.random.default_rng(5), 0.5, 10.0),
        jcam.perturbed_camera(jc[1], np.random.default_rng(5), 0.5, 10.0))


def _views(shape, n=3, W=64, H=48, seed=0):
    """Ray-cast depth of a plane (z = 0.2, tilted) or a sphere (r 0.7)
    from n cameras, with seeded colour images: [(depth, img, K, view)]."""
    r = np.random.default_rng(seed)
    out = []
    for k in range(n):
        cam = jcam.look_at_camera([0.4 * k - 0.4, 0.25, -3.0], [0, 0, 0],
                                  [0, -1, 0], 0.9, 0.7, W, H)
        view = np.array(cam.view, np.float64)
        fx, fy, cx, cy = (float(cam.fx), float(cam.fy), float(cam.cx),
                          float(cam.cy))
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
        d = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
        c2w = np.linalg.inv(view)
        o, dw = c2w[:3, 3], d @ c2w[:3, :3].T
        if shape == "sphere":
            a, b, c = (dw ** 2).sum(-1), 2 * (dw @ o), o @ o - 0.49
            disc = b * b - 4 * a * c
            t = (-b - np.sqrt(np.clip(disc, 0, None))) / (2 * a)
            depth = np.where(disc > 0, t, 0)
        else:
            n_ = np.array([0.1, 0.2, 1.0])
            t = (0.2 - n_ @ o) / (dw @ n_)
            depth = np.where(t > 0, t, 0)
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        out.append((depth.astype(np.float32),
                    r.random((H, W, 3)).astype(np.float32), K,
                    view.astype(np.float32)))
    return out


BOUNDS = (np.array([-1.1, -1.05, -0.9]), np.array([1.0, 1.1, 1.2]))


@pytest.fixture(scope="module", params=["plane", "sphere"])
def fused(request):
    views = _views(request.param)
    jv = jtsdf.TSDFVolume(*BOUNDS, voxel_size=0.05)
    whole = ttsdf.TSDFVolume(*BOUNDS, voxel_size=0.05, device="cpu")
    chunked = ttsdf.TSDFVolume(*BOUNDS, voxel_size=0.05, device="cpu")
    chunk = ttsdf.CHUNK_VOXELS
    for depth, img, K, view in views:
        jv.integrate(depth, img, K, view)
        whole.integrate(depth, img, K, view)
        ttsdf.CHUNK_VOXELS = 7777
        try:
            chunked.integrate(torch.as_tensor(depth), torch.as_tensor(img),
                              K, torch.as_tensor(view))
        finally:
            ttsdf.CHUNK_VOXELS = chunk
    return jv, whole, chunked


def test_tsdf_integrate_matches_jax(fused):
    jv, tv, chunked = fused
    assert tv.dims == jv.dims
    for k in ("tsdf", "weight", "color"):
        assert torch.equal(getattr(tv, k), getattr(chunked, k)), k
    w = np.asarray(jv.weight)
    assert np.array_equal(tv.weight.numpy(), w) and (w > 0).sum() > 1000
    pos = w > 0
    for k in ("tsdf", "color"):
        np.testing.assert_allclose(getattr(tv, k).numpy()[pos],
                                   np.asarray(getattr(jv, k))[pos], rtol=0,
                                   atol=TSDF_TOL, err_msg=k)


def test_mesh_extraction_and_files_match_jax(fused, tmp_path):
    jv, tv, _ = fused
    jverts, jfaces = jv.extract_mesh()
    tverts, tfaces = tv.extract_mesh()
    np.testing.assert_array_equal(tverts, jverts)
    np.testing.assert_array_equal(tfaces, jfaces)
    assert len(tfaces) > 100
    vol = np.where(tv.weight.numpy() >= 1, tv.tsdf.numpy(), np.nan)
    for got, want in zip(ttsdf.marching_cubes(vol, 0.1),
                         jtsdf.marching_cubes(vol, 0.1)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(ttsdf.post_process_mesh(tverts, tfaces, 3),
                         jtsdf.post_process_mesh(jverts, jfaces, 3)):
        np.testing.assert_array_equal(got, want)
    colors = np.random.default_rng(1).random((len(tverts), 3))
    for c in (None, colors):
        a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
        ttsdf.save_mesh_ply(a, tverts, tfaces, c)
        jtsdf.save_mesh_ply(b, jverts, jfaces, c)
        assert open(a, "rb").read() == open(b, "rb").read()
        for got, want in zip(ttsdf.load_mesh_ply(a), jtsdf.load_mesh_ply(a)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ttsdf.load_mesh_ply(a)[1], tfaces)


def test_filter_depth_by_view_angle_matches_jax():
    r = np.random.default_rng(2)
    depth = r.uniform(0.5, 4, (20, 30)).astype(np.float32)
    dn = r.normal(size=(20, 30, 3)).astype(np.float32)
    ray = r.normal(size=(20, 30, 3)).astype(np.float32)
    for ang in (80.0, 45.0):
        got = trd.filter_depth_by_view_angle(
            torch.as_tensor(depth), torch.as_tensor(dn), torch.as_tensor(ray),
            ang)
        want = jrd.filter_depth_by_view_angle(jnp.asarray(depth),
                                              jnp.asarray(dn),
                                              jnp.asarray(ray), ang)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert 0 < (got == 0).sum() < got.size


def _write_split(root, seed):
    r = np.random.default_rng(seed)
    base = os.path.join(root, "test", "ours_7")
    for split in ("renders", "renders_aggregate", "gt"):
        os.makedirs(os.path.join(base, split))
    for k in range(3):
        gt = r.integers(0, 256, (40, 56, 3)).astype(np.uint8)
        image_io.write_png(os.path.join(base, "gt", f"{k:05d}.png"), gt)
        for split, noise in (("renders", 20), ("renders_aggregate", 9)):
            img = np.clip(gt.astype(int) + r.integers(-noise, noise + 1,
                                                      gt.shape), 0, 255)
            image_io.write_png(os.path.join(base, split, f"{k:05d}.png"),
                               img.astype(np.uint8))


def _json_close(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _json_close(a[k], b[k])
    elif a is None or b is None:
        assert a is None and b is None
    else:
        assert abs(a - b) <= JSON_TOL, (a, b)


def test_evaluate_model_dir_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("IBGS_LPIPS_WEIGHTS", raising=False)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _write_split(jdir, 3)
    shutil.copytree(jdir, tdir)
    want = jmetrics.evaluate_model_dir(jdir)
    got = tmetrics.evaluate_model_dir(tdir, device="cpu")
    _json_close(got, want)
    assert sorted(got) == ["ours_7/renders", "ours_7/renders_aggregate"]
    assert got["ours_7/renders"]["lpips"] is None
    for split in ("renders", "renders_aggregate"):
        for f in (f"results_{split}.json", f"per_view_{split}.json"):
            with open(os.path.join(tdir, f)) as a, \
                    open(os.path.join(jdir, f)) as b:
                _json_close(json.load(a), json.load(b))
    base = os.path.join(tdir, "test", "ours_7")
    mean, per_view = tmetrics.evaluate_dirs(os.path.join(base, "renders"),
                                            os.path.join(base, "gt"), "cpu")
    assert len(per_view["psnr"]) == 3 and mean == got["ours_7/renders"]


def test_lpips_matches_jax(tmp_path):
    convs, lins = _random_weights(3)
    d = {}
    for i, (w, b) in enumerate(convs):
        d[f"conv{i}_w"], d[f"conv{i}_b"] = w, b
    for j, lin in enumerate(lins):
        d[f"lin{j}_w"] = lin
    p = str(tmp_path / "lpips.npz")
    np.savez(p, **d)
    rng = np.random.default_rng(11)
    a = rng.random((48, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    port = tlpips.LPIPS.from_npz(p, device="cpu")
    want = float(jlpips.LPIPS.from_npz(p)(a, b))
    got = float(port(a, b))
    assert got == pytest.approx(want, rel=LPIPS_RTOL) and got > 0
    assert float(port(a, a)) == 0.0


def test_render_video_writes_png_frames_without_cv2(tmp_path, monkeypatch):
    from ibgs_tpu_torch.config import OptimizationParams
    from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
    from ibgs_tpu_torch.eval.video import render_video
    from ibgs_tpu_torch.models.gaussians import init_from_points
    from ibgs_tpu_torch.ops.rasterize import RasterConfig

    scene = make_synthetic_scene(n_views=4, width=24, height=16, n_gt=200,
                                 n_seed=80, device="cpu")
    model = init_from_points(scene.points, scene.colors, 2, device="cpu")
    ev = trd.EvalRenderer.from_scene(model, None, scene,
                                     OptimizationParams(), RasterConfig(),
                                     "cpu")
    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no module named cv2")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    out = render_video(ev, str(tmp_path / "fly.mp4"), n_frames=3)
    assert out == str(tmp_path / "fly.mp4") + "_frames"
    names = sorted(os.listdir(out))
    assert names == ["00000.png", "00001.png", "00002.png"]
    assert image_io.read_png(os.path.join(out, names[0])).shape == (16, 24, 3)
