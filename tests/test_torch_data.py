"""The port's data layer against the JAX package.

* `load_scene` on tests/fixtures/mini_colmap, with and without the eval
  holdout, and on a 4-frame Blender scene written by the test (black and
  white background): images, camera matrices and intrinsics, seed points
  and colours, the nerf++ extent and both neighbour lists exactly; the
  multi_view*.json files byte-equal.
* The COLMAP readers: the native `parse_colmap_points3d` against the
  Python reader; `load_sparse` on the binary files and on a text export
  of them against the JAX package's, with and without the quality filter.
* `make_synthetic_scene(n_views=4, width=32, height=32, n_gt=300,
  n_seed=150)`: points, colours, neighbour ids and camera matrices
  exactly; the ground-truth images (the port's plain blend against JAX's
  oracle) within 1e-5.
* The PLY written by the port byte-equal to the JAX package's for the same
  arrays, and read back exactly.
* `dataset._load_image` reads PNG without PIL: pixel-equal to the PIL
  route (the JAX package's) on RGB and RGBA files, black and white
  backgrounds; a resize and a JPEG still go through PIL, and without PIL
  a JPEG raises ImportError naming it.
* `convert.bundle_train_scene` on bench_bundle.npz: 5 views at the
  bundle's exact camera centres (the source cameras rebuilt as the ring's
  look-at cameras, within the stored transforms' bf16 rounding), the
  nerf++ extent 1.325, the colours and the neighbour order.
"""
import json
import os

import numpy as np
import pytest

from ibgs_tpu.data import colmap as jcolmap
from ibgs_tpu.data import dataset as jds
from ibgs_tpu.data import ply as jply
from ibgs_tpu.data import synthetic as jsyn
from ibgs_tpu_torch.data import colmap as tcolmap
from ibgs_tpu_torch.data import dataset as tds
from ibgs_tpu_torch.data import ply as tply
from ibgs_tpu_torch.data import synthetic as tsyn
from ibgs_tpu_torch.utils import native
from tests.test_torch_slice import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "mini_colmap")
SPARSE = os.path.join(FIXTURE, "sparse", "0")
CAM_FIELDS = ("view", "proj", "full_proj", "cam_pos")
CAM_SCALARS = ("fx", "fy", "cx", "cy", "tan_fovx", "tan_fovy")


def _assert_cameras_equal(tcams, jcams):
    assert len(tcams) == len(jcams)
    for tc, jc in zip(tcams, jcams):
        assert (tc.width, tc.height) == (jc.width, jc.height)
        for f in CAM_FIELDS:
            np.testing.assert_array_equal(getattr(tc, f).cpu().numpy(),
                                          np.asarray(getattr(jc, f)),
                                          err_msg=f)
        for f in CAM_SCALARS:
            assert getattr(tc, f) == float(getattr(jc, f)), f


def _assert_scenes_equal(ts, js):
    _assert_cameras_equal(ts.train_cameras, js.train_cameras)
    _assert_cameras_equal(ts.test_cameras, js.test_cameras)
    for f in ("images", "test_images", "points", "colors"):
        a, b = getattr(ts, f), getattr(js, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ts.cameras_extent == js.cameras_extent
    assert ts.nearest_ids == js.nearest_ids
    assert ts.test_nearest_ids == js.test_nearest_ids
    assert ts.white_background == js.white_background
    assert ([i.image_name for i in ts.train_infos]
            == [i.image_name for i in js.train_infos])
    tw, tc, tr = ts.poses_stack()
    jw, jc, jr = js.poses_stack()
    for a, b in ((tw, jw), (tc, jc), (tr, jr)):
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("eval_split", [False, True])
def test_load_scene_matches_jax(eval_split, tmp_path):
    kw = dict(eval_split=eval_split, multi_view_num=3,
              multi_view_max_angle=120.0, multi_view_max_dis=10.0)
    js = jds.load_scene(FIXTURE, **kw)
    ts = tds.load_scene(FIXTURE, device="cpu", **kw)
    assert ts.n_train == js.n_train == (3 if eval_split else 4)
    _assert_scenes_equal(ts, js)
    jds.write_multiview_json(js, str(tmp_path / "jax"))
    tds.write_multiview_json(ts, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "multi_view.json" in names
    for n in names:
        assert ((tmp_path / "jax" / n).read_bytes()
                == (tmp_path / "port" / n).read_bytes()), n


def _write_text_export(dst):
    """cameras.txt / images.txt / points3D.txt of the fixture's model."""
    cams = jcolmap.read_cameras_bin(os.path.join(SPARSE, "cameras.bin"))
    ims = jcolmap.read_images_bin(os.path.join(SPARSE, "images.bin"))
    xyz, rgb, err, tlen = tcolmap.read_points3d_bin_python(
        os.path.join(SPARSE, "points3D.bin"))
    os.makedirs(dst)
    with open(os.path.join(dst, "cameras.txt"), "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for c in cams.values():
            f.write(f"{c.cam_id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(dst, "images.txt"), "w") as f:
        for im in ims.values():
            f.write(f"{im.image_id} "
                    + " ".join(repr(float(v)) for v in im.qvec) + " "
                    + " ".join(repr(float(v)) for v in im.tvec)
                    + f" {im.camera_id} {im.name}\n\n")
    with open(os.path.join(dst, "points3D.txt"), "w") as f:
        for i in range(len(xyz)):
            track = " ".join("1 0" for _ in range(int(tlen[i])))
            f.write(f"{i + 1} " + " ".join(repr(float(v)) for v in xyz[i])
                    + " " + " ".join(str(int(v)) for v in rgb[i])
                    + f" {float(err[i])!r} {track}\n")


@pytest.mark.parametrize("form", ["bin", "txt"])
def test_load_sparse_matches_jax(form, tmp_path):
    sparse = SPARSE
    if form == "txt":
        sparse = str(tmp_path / "sparse")
        _write_text_export(sparse)
    for filt in (True, False):
        jc, ji, jp, jr = jcolmap.load_sparse(sparse, filter_points=filt)
        tc, ti, tp, tr = tcolmap.load_sparse(sparse, filter_points=filt)
        assert tp.shape == jp.shape == ((300, 3) if filt else (308, 3))
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tr, jr)
        assert sorted(tc) == sorted(jc) and sorted(ti) == sorted(ji)
        for k in jc:
            assert (tc[k].model, tc[k].width, tc[k].height) == (
                jc[k].model, jc[k].width, jc[k].height)
            np.testing.assert_array_equal(tc[k].params, jc[k].params)
        for k in ji:
            assert ti[k].name == ji[k].name
            np.testing.assert_array_equal(ti[k].qvec, ji[k].qvec)
            np.testing.assert_array_equal(ti[k].tvec, ji[k].tvec)
            np.testing.assert_array_equal(tcolmap.qvec_to_rotmat(ti[k].qvec),
                                          jcolmap.qvec_to_rotmat(ji[k].qvec))


def test_native_points3d_parser_matches_python(tmp_path):
    path = os.path.join(SPARSE, "points3D.bin")
    got = native.parse_colmap_points3d(path)
    want = tcolmap.read_points3d_bin_python(path)
    assert got is not None and len(got[0]) == 308
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # a truncated file is reported as corrupt
    cut = tmp_path / "points3D.bin"
    cut.write_bytes(open(path, "rb").read()[:-7])
    assert native.parse_colmap_points3d(str(cut)) is None


def test_synthetic_scene_matches_jax():
    kw = dict(n_views=4, width=32, height=32, n_gt=300, n_seed=150)
    js = jsyn.make_synthetic_scene(**kw)
    ts = tsyn.make_synthetic_scene(device="cpu", **kw)
    _assert_cameras_equal(ts.train_cameras, js.train_cameras)
    _assert_cameras_equal(ts.test_cameras, js.test_cameras)
    np.testing.assert_array_equal(ts.points, js.points)
    np.testing.assert_array_equal(ts.colors, js.colors)
    assert ts.nearest_ids == js.nearest_ids
    assert ts.test_nearest_ids == js.test_nearest_ids
    assert ts.cameras_extent == js.cameras_extent
    for f in ("images", "test_images"):
        a, b = getattr(ts, f), getattr(js, f)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.max() > 0.1
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f)


def test_ply_bytes_match_jax(tmp_path):
    r = np.random.default_rng(0)
    n, K = 37, 9
    arrs = dict(xyz=(n, 3), normal=(n, 3), offset=(n, 1), sh_dc=(n, 1, 3),
                sh_rest=(n, K - 1, 3), opacity_logit=(n, 1),
                log_scale=(n, 3), quat=(n, 4))
    arrs = {k: r.normal(size=s).astype(np.float32) for k, s in arrs.items()}
    order = ("xyz", "normal", "offset", "sh_dc", "sh_rest", "opacity_logit",
             "log_scale", "quat")
    jp, tp = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jply.save_gaussian_ply(jp, *(arrs[k] for k in order))
    tply.save_gaussian_ply(tp, *(arrs[k] for k in order))
    assert open(jp, "rb").read() == open(tp, "rb").read()
    back, jback = tply.load_gaussian_ply(tp), jply.load_gaussian_ply(jp)
    assert sorted(back) == sorted(jback)
    for k in back:
        np.testing.assert_array_equal(back[k], jback[k], err_msg=k)
    for k in order:
        np.testing.assert_array_equal(back[k].reshape(arrs[k].shape),
                                      arrs[k], err_msg=k)


def test_bundle_train_scene():
    from ibgs_tpu_torch import convert
    d = dict(np.load(os.path.join(ROOT, "bench_bundle.npz")))
    sc = convert.bundle_train_scene(d, 120, 68, device="cpu")
    assert sc.n_train == 5 and not sc.test_cameras
    assert sc.images.shape == (5, 68, 120, 3)
    assert sc.images.dtype == np.float32
    assert sc.points.shape == (91307, 3)
    want = np.clip(d["sh_dc"][:, 0] * np.float32(0.28209479177387814)
                   + np.float32(0.5), 0, 1)
    np.testing.assert_allclose(sc.colors, want, rtol=0, atol=1e-7)
    ref = sc.train_cameras[0]
    centres = np.concatenate([ref.cam_pos.numpy()[None], d["src_cam_pos"]])
    np.testing.assert_allclose(
        np.stack([c.cam_pos.numpy() for c in sc.train_cameras]), centres,
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(sc.cameras_extent,
                               convert.cameras_extent(centres), rtol=1e-6)
    assert round(sc.cameras_extent, 3) == 1.325
    for k, ids in enumerate(sc.nearest_ids):
        assert sorted(ids) == [i for i in range(5) if i != k]
        dist = np.linalg.norm(centres[ids] - centres[k], axis=-1)
        assert (np.diff(dist) >= 0).all()
    # the stored bf16-rounded transforms agree with the rebuilt cameras
    # to their rounding, and a bundle of another scene is refused
    stored = convert.source_cameras(ref.view.numpy(), d["src_ref_to_src"],
                                    float(d["fovx"]), float(d["fovy"]), 120,
                                    68, "cpu")
    for a, b in zip(stored, sc.train_cameras[1:]):
        assert float((a.view - b.view).abs().max()) < 4e-3
    bad = dict(d, cam_t=d["cam_t"] + np.float32(0.1))
    with pytest.raises(ValueError, match="ring"):
        convert.bundle_train_scene(bad, 120, 68, device="cpu")


def _write_blender_scene(root):
    """A 4-frame Blender scene (RGBA PNGs, 3 train and 1 test frame)."""
    from PIL import Image

    r = np.random.default_rng(3)
    os.makedirs(os.path.join(root, "train"))
    for split, frames in (("train", range(3)), ("test", range(3, 4))):
        recs = []
        for k in frames:
            a = 0.4 * k
            eye = np.array([2 * np.sin(a), 0.3, 2 * np.cos(a)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 1.0, 0.0])
            right /= np.linalg.norm(right)
            up = np.cross(right, fwd)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (right, up,
                                                              -fwd, eye)
            name = f"train/r_{k}"
            rgba = r.integers(0, 256, (12, 16, 4)).astype(np.uint8)
            Image.fromarray(rgba, "RGBA").save(os.path.join(root,
                                                            name + ".png"))
            recs.append({"file_path": name, "transform_matrix":
                         c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": recs}, f)


@pytest.mark.parametrize("white", [False, True])
def test_load_blender_scene_matches_jax(white, tmp_path):
    root = str(tmp_path / "blender")
    _write_blender_scene(root)
    kw = dict(eval_split=True, white_background=white, multi_view_num=2,
              multi_view_max_angle=120.0, multi_view_max_dis=10.0)
    js = jds.load_scene(root, **kw)
    ts = tds.load_scene(root, device="cpu", **kw)
    assert ts.n_train == 3 and len(ts.test_cameras) == 1
    _assert_scenes_equal(ts, js)


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_png_loads_without_pil(mode, white, tmp_path, monkeypatch):
    import builtins

    from PIL import Image

    r = np.random.default_rng(6)
    arr = r.integers(0, 256, (18, 26, len(mode))).astype(np.uint8)
    png = str(tmp_path / "a.png")
    Image.fromarray(arr, mode).save(png)
    want = jds._load_image(png, (26, 18), white)
    resized = jds._load_image(png, (13, 9), white)
    jpg = str(tmp_path / "a.jpg")
    Image.fromarray(arr[..., :3]).save(jpg)
    want_jpg = jds._load_image(jpg, (26, 18), white)
    assert np.array_equal(tds._load_image(jpg, (26, 18), white), want_jpg)
    assert np.array_equal(tds._load_image(png, (13, 9), white), resized)

    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(f"no module named {name}")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    got = tds._load_image(png, (26, 18), white)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ImportError, match="PIL"):
        tds._load_image(jpg, (26, 18), white)
