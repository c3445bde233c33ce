"""The port's render and metrics CLIs against the root render.py (JAX).

Scene: the synthetic scene, 6 views at 40x40 (2 test, 4 train), 600
ground-truth and 300 seed splats, an instance cap of 4,096.  Two model directories at iteration 2:

* one written by the JAX package's own writers (`save_ply_snapshot`,
  `save_state` of a JAX TrainState with a fusion net): the seed points
  with opacity 0.85 and scale 0.06, so the renders and depths cover the
  disc; the JAX render.py (oracle backend) and `python -m
  ibgs_tpu_torch.render --device cpu` render copies of it with a PNG
  source dump and `--render_geo`;
* one trained by `python -m ibgs_tpu_torch.train` for 2 iterations, which
  the port renders with the default JPEG dump.

Checked: the port writes the JAX CLI's file tree (the JPEG dump's names
with .png) and result_fps_mem.json keys, n_gaussians and model_mb equal;
every PNG within 1 of JAX's on at most 0.1% of pixels, the others equal
(`render_split`: renders, ground truth, depth, normal, and the dump's
images), the fused renders on at most 5% (FUSED_SHARE); the dump's .npy
within 1e-6; the TSDF meshes' vertex counts within 1% and their
symmetric chamfer distance under a tenth of a voxel; `python -m ibgs_tpu_torch.metrics` prints one line per split;
without `--device` both CLIs raise where there is no CUDA device.
"""
import importlib.util
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial import cKDTree

from ibgs_tpu.eval.tsdf import load_mesh_ply
from ibgs_tpu.models import aggregation as jagg
from ibgs_tpu.models import gaussians as jg
from ibgs_tpu.train import checkpoint as jckpt
from ibgs_tpu.train import trainer as jtr
from ibgs_tpu_torch import metrics as tmetrics_cli
from ibgs_tpu_torch import render as trender_cli
from ibgs_tpu_torch.data import synthetic as tsyn
from ibgs_tpu_torch.train import __main__ as ttrain_cli
from ibgs_tpu_torch.utils import image_io
from tests.test_torch_slice import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = ["6", "40", "40", "600", "300"]
IT = 2
VOXEL = 0.05
NPY_TOL = 1e-6
PNG_SHARE = 1e-3                   # share of pixels allowed to differ by 1
# the fused renders: the fusion net's outputs agree with JAX's to 1e-4
# (tests/test_torch_slice.py, its bf16 matmuls accumulate in another
# order), and a shift of 1e-4 moves a truncated byte on up to
# 2 x 1e-4 x 255 = 5% of the values
FUSED_SHARE = 0.05
MESH_COUNT_RTOL, CHAMFER_VOXELS = 0.01, 0.1


def _root_render():
    spec = importlib.util.spec_from_file_location(
        "root_render", os.path.join(ROOT, "render.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_jax_model_dir(path):
    """A model directory written by the JAX package: PLY and checkpoint
    at iteration IT."""
    v, w, h, ngt, nseed = (int(x) for x in SPEC)
    scene = tsyn.make_synthetic_scene(n_views=v, width=w, height=h,
                                      n_gt=ngt, n_seed=nseed,
                                      eval_every=max(v // 2, 2),
                                      device="cpu")
    m = jg.init_from_points(scene.points, scene.colors, 2)
    p = m.params
    m = m.replace(params=p.replace(
        opacity_logit=jnp.full_like(p.opacity_logit, np.log(0.85 / 0.15)),
        log_scale=jnp.full_like(p.log_scale, np.log(0.06))))
    net = jagg.ColorFusionResidualNet()
    net_params = net.init(jax.random.PRNGKey(7), jnp.zeros((4, 4, 3, 7)),
                          jnp.zeros((4, 4, 3)), jnp.zeros((4, 4, 3)))
    app = jnp.zeros((1600, 2))
    state = jtr.TrainState(
        model=m, app_ab=app, app_opt=jtr.SideOptState.init(app),
        net_params=net_params, net_opt=jtr.SideOptState.init(net_params),
        spatial_lr_scale=jnp.float32(1.0))
    pc = os.path.join(path, "point_cloud", f"iteration_{IT}")
    os.makedirs(pc)
    jckpt.save_ply_snapshot(m, os.path.join(pc, "point_cloud.ply"))
    jckpt.save_state(state, IT, os.path.join(path, f"chkpnt{IT}.npz"))


def _tree(path):
    """The CLI's outputs under path: relative file names."""
    out = set()
    for root, _dirs, files in os.walk(path):
        rel = os.path.relpath(root, path)
        if rel.split(os.sep)[0] not in ("test", "train", "test_time_data",
                                        "."):
            continue
        for f in files:
            if rel == "." and f not in ("mesh.ply", "result_fps_mem.json"):
                continue
            out.add(os.path.normpath(os.path.join(rel, f)))
    return out


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    src = str(base / "written_by_jax")
    _write_jax_model_dir(src)
    jdir, tdir = str(base / "jax_render"), str(base / "port_render")
    shutil.copytree(src, jdir)
    shutil.copytree(src, tdir)
    # a cap of 4,096 instances (about 1,800 here): the JAX default of 2^20
    # makes its oracle blend walk a million-row list per tile
    common = ["--synthetic", "--synthetic_spec", *SPEC, "--src_image_ext",
              "png", "--render_geo", "--voxel_size", str(VOXEL),
              "--instance_cap", "4096"]
    _root_render().main(["-m", jdir, *common, "--backend", "oracle"])
    assert trender_cli.main(["-m", tdir, *common, "--device", "cpu"]) == 0

    pdir = str(base / "port_trained")
    assert ttrain_cli.main(["--synthetic", "--synthetic_spec", *SPEC,
                            "--iterations", str(IT), "--device", "cpu",
                            "-m", pdir, "--quiet", "--checkpoint_iterations",
                            str(IT)]) == 0
    assert trender_cli.main(["-m", pdir, "--render_geo", "--voxel_size",
                             str(VOXEL), "--device", "cpu"]) == 0
    return jdir, tdir, pdir


def _result(path):
    with open(os.path.join(path, "result_fps_mem.json")) as f:
        return json.load(f)


def test_cli_output_tree_and_keys_match_jax(rendered):
    jdir, tdir, pdir = rendered
    want = _tree(jdir)
    assert f"test/ours_{IT}/renders_aggregate/00000.png" in want
    # 6 views x 5 PNGs, 4 dumped images, 2 .npy, the mesh and the JSON
    assert "mesh.ply" in want and len(want) == 30 + 4 + 2 + 2
    assert _tree(tdir) == want
    assert {f.replace(".jpg", ".png") for f in _tree(pdir)} == want
    j, t, p = _result(jdir), _result(tdir), _result(pdir)
    assert sorted(t) == sorted(p) == sorted(j) == sorted(
        ["FPS", "fps", "n_gaussians", "num_gaussians", "model_mb", "memory"])
    assert t["n_gaussians"] == j["n_gaussians"] == 300
    assert t["model_mb"] == j["model_mb"] and t["fps"] > 0


def test_render_split_pngs_match_jax(rendered):
    jdir, tdir, _ = rendered
    pngs = sorted(f for f in _tree(jdir) if f.endswith(".png"))
    assert len(pngs) == 5 * 6 + 4
    for f in pngs:
        a = image_io.read_png(os.path.join(tdir, f)).astype(int)
        b = image_io.read_png(os.path.join(jdir, f)).astype(int)
        diff = np.abs(a - b)
        assert a.shape == b.shape and diff.max() <= 1, f
        share = FUSED_SHARE if "renders_aggregate" in f else PNG_SHARE
        assert (diff > 0).any(-1).mean() <= share, f
    # the renders are not blank: the model covers the disc
    depth = image_io.read_png(os.path.join(tdir, "test", f"ours_{IT}",
                                           "renders", "00000.png"))
    assert depth.std() > 5


def test_test_time_dump_matches_jax(rendered):
    jdir, tdir, _ = rendered
    sub = os.path.join("test_time_data", f"ours_{IT}")
    for f in ("test_intrinsic.npy", "test_extrinsic.npy"):
        a = np.load(os.path.join(tdir, sub, f))
        b = np.load(os.path.join(jdir, sub, f))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (
            4, 4 if "intr" in f else 6)
        np.testing.assert_allclose(a, b, rtol=0, atol=NPY_TOL, err_msg=f)


def test_tsdf_mesh_matches_jax(rendered):
    jdir, tdir, _ = rendered
    vt, ft = load_mesh_ply(os.path.join(tdir, "mesh.ply"))
    vj, fj = load_mesh_ply(os.path.join(jdir, "mesh.ply"))
    assert len(fj) > 100 and len(ft) > 100
    assert abs(len(vt) - len(vj)) <= MESH_COUNT_RTOL * len(vj)
    chamfer = 0.5 * (cKDTree(vj).query(vt)[0].mean()
                     + cKDTree(vt).query(vj)[0].mean())
    assert chamfer < CHAMFER_VOXELS * VOXEL


def test_metrics_cli_prints_one_line_per_split(rendered, capsys):
    jdir, tdir, pdir = rendered
    assert tmetrics_cli.main(["-m", tdir, pdir, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"evaluating {tdir}"
    for split in ("renders", "renders_aggregate"):
        assert sum(ln.startswith(f"  ours_{IT}/{split}: PSNR ")
                   for ln in lines) == 2
        assert os.path.exists(os.path.join(tdir, f"results_{split}.json"))


def test_clis_default_to_the_card(rendered):
    """Without `--device` both CLIs run on the card: with no CUDA device
    they raise instead of falling back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jdir, tdir, _ = rendered
    with pytest.raises((RuntimeError, AssertionError)):
        trender_cli.main(["-m", tdir, "--synthetic", "--synthetic_spec",
                          *SPEC, "--skip_train"])
    with pytest.raises((RuntimeError, AssertionError)):
        tmetrics_cli.main(["-m", tdir])
