"""The port's drivers against the JAX package's scripts, on the CPU.

Each case runs both packages on the same inputs (numpy, seeded):

* suite commands: `ibgs_tpu_torch.exp_script`'s stage commands for each
  suite and for `--scenes` equal the root exp_script.py's, with `python -m
  ibgs_tpu_torch.{train,render,metrics} ... --device cpu` in place of the
  root scripts (both modules' `run` recorded);
* run presets: each `scripts/train_runs.py` subcommand's scene keyword
  arguments, ModelParams, OptimizationParams, PipelineParams (less
  `backend`) and train keyword arguments equal what the unchanged JAX
  script passes (its make_synthetic_scene and train recorded, train
  raising a sentinel), at the defaults and with every setting changed;
* capacity growth through `train_runs`: a tiny `prod` run whose
  densify_log.jsonl doubles the capacity and whose events.jsonl records
  that and the instance cap's growth; the bundle CLI on its PLY;
* the bundle: the port's `write_bundle` against the JAX one on one model,
  scene and depth stack (same keys and dtypes, arrays within 1e-6); the
  port's bundle loads in the JAX bench reader and in `convert`;
* eval_geometry: chamfer (also with the ObsMask / plane cut), F-score and
  the DTU cull
  equal scripts/eval_geometry.py's within 1e-6 on tests/test_dtu_eval.py's
  meshes;
* convert_data_to_json: transforms.json and split.json equal the JAX
  script's on tests/test_converters.py's fixture, for each scene type;
* the example: its render equals JAX `render_view(backend="oracle")` on
  the same scene within 1e-4 (the JAX example's tolerance), and its
  centre gradient is finite.

The snapshot replay is in test_torch_drivers_replay.py and the suite
runner's real chain run in test_torch_drivers_chain.py (each file on its
own worker).
"""
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu import config as jconfig
from ibgs_tpu.models import gaussians as jg
from ibgs_tpu_torch import convert
from ibgs_tpu_torch import exp_script as texp
from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
from ibgs_tpu_torch.models.gaussians import (PARAM_FIELDS, GaussianModel,
                                             GaussianParams)
from ibgs_tpu_torch.scripts import make_bench_bundle as tbundle
from ibgs_tpu_torch.scripts import train_runs
from tests.test_torch_slice import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "mini_colmap")


def _load(name, rel):
    """A root script of the JAX package as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- suite commands ------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--suites", "m360_indoor"], ["--suites", "m360_outdoor"],
    ["--suites", "db"], ["--suites", "shiny"],
    ["--suites", "tnt", "--extra", "--iterations", "7"],
    ["--scenes", "a", "b", "--extra", "--eval", "--iterations", "15"]],
    ids=["m360_indoor", "m360_outdoor", "db", "shiny", "tnt", "scenes"])
def test_suite_commands_match_jax(argv, monkeypatch, tmp_path):
    jexp = _load("jax_exp_script", "exp_script.py")
    common = ["--data_root", str(tmp_path / "data"),
              "--out_root", str(tmp_path / "out")]
    got_j, got_t = [], []
    monkeypatch.setattr(jexp, "run", got_j.append)
    monkeypatch.setattr(texp, "run", got_t.append)
    jexp.main(common + argv)
    texp.main(common + ["--device", "cpu"] + argv)
    stage = {"train.py": "train", "render.py": "render",
             "metrics.py": "metrics"}
    want = [[c[0], "-m", "ibgs_tpu_torch." + stage[os.path.basename(c[1])],
             *c[2:], "--device", "cpu"] for c in got_j]
    assert got_t == want
    assert len(want) >= 6


# ---- run presets -----------------------------------------------------------

class _Stop(Exception):
    pass


class _FakeScene:
    n_train = 14


PRESET_CASES = [
    ("prod", "scripts/tpu_prod_run.py", {}, []),
    ("prod", "scripts/tpu_prod_run.py",
     dict(PROD_ITERS="2400", PROD_W="480", PROD_H="272", PROD_GT="9000",
          PROD_SEED_PTS="700", PROD_GRAD_TH="8e-05", PROD_ABS_TH="0.00016",
          PROD_CAP="65536", PROD_ROWCAP="4096", PROD_INIT_CAPACITY="8192",
          PROD_DEBUG="1", PROD_LOG_EVERY="10"),
     ["--iters", "2400", "--width", "480", "--height", "272", "--gt",
      "9000", "--seed_pts", "700", "--grad_th", "8e-05", "--abs_th",
      "0.00016", "--cap", "65536", "--rowcap", "4096", "--init_capacity",
      "8192", "--debug", "1", "--log_every", "10"]),
    ("ref30k", "scripts/tpu_ref30k_run.py", {}, []),
    ("ref30k", "scripts/tpu_ref30k_run.py",
     dict(REF_ITERS="12000", REF_VIEWS="8", REF_W="320", REF_H="192",
          REF_GT="5000", REF_SEED_PTS="900", REF_DEBUG="0",
          REF_CAP="32768", REF_LOG_EVERY="7"),
     ["--iters", "12000", "--views", "8", "--width", "320", "--height",
      "192", "--gt", "5000", "--seed_pts", "900", "--debug", "0", "--cap",
      "32768", "--log_every", "7"]),
    ("validation", "scripts/tpu_train_validation.py", {}, []),
    ("validation", "scripts/tpu_train_validation.py",
     dict(VAL_ITERS="900", VAL_NO_EVAL="1", VAL_LOG_EVERY="5"),
     ["--iters", "900", "--no_eval", "--log_every", "5"]),
]


@pytest.mark.parametrize("cmd,script,env,flags", PRESET_CASES,
                         ids=["prod", "prod_set", "ref30k", "ref30k_set",
                              "validation", "validation_set"])
def test_run_presets_match_jax(cmd, script, env, flags, monkeypatch,
                               tmp_path):
    import ibgs_tpu.data.synthetic as jsyn
    import ibgs_tpu.train.loop as jloop

    rec = {}

    def scene_rec(**kw):
        rec["scene"] = kw
        return _FakeScene()

    def train_rec(scene, mp, opt, pipe, **kw):
        rec.update(mp=mp, opt=opt, pipe=pipe, train=kw)
        raise _Stop

    for k in ("PROD_", "REF_", "VAL_"):
        for name in [n for n in os.environ if n.startswith(k)]:
            monkeypatch.delenv(name)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jsyn, "make_synthetic_scene", scene_rec)
    monkeypatch.setattr(jloop, "train", train_rec)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    out = str(tmp_path / "run")
    monkeypatch.setattr(sys, "argv", [script, out])
    with pytest.raises(_Stop):
        _load("jax_" + cmd, script).main()

    pl = train_runs.plan([cmd, out, "--device", "cpu"] + flags)
    assert pl.scene == rec["scene"]
    for group in ("mp", "opt"):
        assert dataclasses.asdict(getattr(pl, group)) == \
            dataclasses.asdict(rec[group]), group
    jpipe = dataclasses.asdict(rec["pipe"])
    del jpipe["backend"]
    assert dataclasses.asdict(pl.pipe) == jpipe
    want = dict(rec["train"])
    assert want.pop("model_path") == pl.out
    assert want.pop("start_checkpoint") == pl.start_checkpoint
    assert {k: tuple(v) if isinstance(v, (tuple, list)) else v
            for k, v in want.items()} == pl.train
    assert not os.path.abspath(pl.bundle or ROOT).endswith("bench_bundle.npz")


# ---- capacity growth through train_runs ------------------------------------

def test_prod_run_grows_capacity_and_instance_cap(tmp_path, capsys):
    """150 seeds in a capacity of 160 (94% occupied at the densify event
    at 4) and an instance cap of 64 (under the first step's count)."""
    out = str(tmp_path / "prod")
    pl = train_runs.plan([
        "prod", out, "--width", "32", "--height", "32", "--gt", "300",
        "--seed_pts", "150", "--iters", "6", "--init_capacity", "160",
        "--cap", "64", "--debug", "1", "--log_every", "1", "--device",
        "cpu"])
    pl.opt = dataclasses.replace(
        pl.opt, densify_from_iter=2, densification_interval=4,
        densify_until_iter=5, single_view_weight_from_iter=20,
        multi_view_weight_from_iter=20)
    pl.train["test_iterations"] = (6,)
    res, state, stacks, scene = train_runs.run(pl)
    printed = capsys.readouterr().out
    with open(os.path.join(out, "densify_log.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert [e["iter"] for e in events] == [4]
    assert events[0]["n_alive_before"] == 150
    assert events[0]["capacity"] == state.model.capacity >= 320
    assert "capacity -> 320 (pre-densify)" in printed
    assert re.search(r"WARNING: tile instances \d+ exceed instance_cap 64",
                     printed), printed
    grown = [e for e in res["events"] if e["event"] == "instance_cap"]
    assert grown and grown[0]["old"] == 64 < grown[0]["count"]
    assert dict(iter=4, event="capacity", old=160, new=320,
                pre_densify=True) in res["events"]
    assert res["nonfinite_logged"] == 0 and res["iterations"] == 6
    assert [e[:2] for e in res["evaluations"]] == [[6, "test"], [6, "train"]]
    assert json.loads(printed.strip().splitlines()[-1]) == json.loads(
        json.dumps(res))

    # the bundle CLI on the run's PLY: the scene rebuilt, the depth cache
    # re-rendered, a bundle that convert reads
    path = str(tmp_path / "bundle.npz")
    tbundle.main([out, path, "--spec", "16", "32", "32", "300", "150",
                  "--device", "cpu"])
    d = dict(np.load(path))
    assert d["xyz"].shape[0] == res["points_final"]
    assert int(d["src_count"]) == 4 and (d["src_depths"] > 0).any()
    sc = convert.bundle_scene(d, 32, 32, "cpu")
    assert int(sc["model"].alive.sum()) == res["points_final"]


# ---- the bundle ------------------------------------------------------------

def _jax_scene_and_model(n_views=6, W=48, H=32):
    from ibgs_tpu.data.synthetic import make_synthetic_scene as jscene_fn
    js = jscene_fn(n_views=n_views, width=W, height=H, n_gt=500, n_seed=200,
                   eval_every=3)
    jm = jg.init_from_points(js.points, js.colors, 2)
    ts = make_synthetic_scene(n_views=n_views, width=W, height=H, n_gt=500,
                              n_seed=200, eval_every=3, device="cpu")
    ts = dataclasses.replace(ts, images=np.asarray(js.images))
    tm = GaussianModel(
        params=GaussianParams(**{
            k: torch.as_tensor(np.asarray(getattr(jm.params, k)))
            for k in PARAM_FIELDS}),
        alive=torch.as_tensor(np.asarray(jm.alive)), active_sh_degree=0,
        max_sh_degree=2)
    return js, jm, ts, tm


def test_write_bundle_matches_jax(tmp_path):
    from bench import _model_from_raw, _round_up
    from scripts.make_bench_bundle import write_bundle as jwrite

    js, jm, ts, tm = _jax_scene_and_model()
    H, W = js.images.shape[1:3]
    depths = np.random.default_rng(3).uniform(
        1.0, 4.0, (js.n_train, H, W)).astype(np.float32)
    opt_j = jconfig.OptimizationParams(number_src_frames=3)
    opt_t = train_runs.OptimizationParams(number_src_frames=3)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jwrite(pj, jm, js, jnp.asarray(depths), cam_idx=1, opt=opt_j)
    n = tbundle.write_bundle(pt, tm, ts, torch.as_tensor(depths), 1, opt_t)
    dj, dt = dict(np.load(pj)), dict(np.load(pt))
    assert sorted(dj) == sorted(dt)
    for k in dj:
        assert dj[k].dtype == dt[k].dtype and dj[k].shape == dt[k].shape, k
        np.testing.assert_allclose(dt[k], dj[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert n == int(jm.n_alive) == dt["xyz"].shape[0]

    # the port's bundle in the JAX bench reader and in convert
    m2 = _model_from_raw(dt, _round_up(1.31 * n, 256))
    assert int(m2.n_alive) == n
    np.testing.assert_array_equal(np.asarray(m2.params.xyz)[:n], dt["xyz"])
    sc = convert.bundle_scene(dt, W, H, "cpu")
    assert int(sc["model"].alive.sum()) == n and sc["count"] == 3
    np.testing.assert_allclose(sc["cam"].view.numpy(),
                               ts.train_cameras[1].view.numpy(), atol=1e-6)
    np.testing.assert_array_equal(sc["gt"].numpy(), js.images[1])


# ---- eval_geometry ---------------------------------------------------------

def _meshes(tmp_path):
    """tests/test_dtu_eval.py's sphere mesh, its vertices alone (a point
    cloud: no sampling), a shifted, scaled copy, and the obsmask / plane
    case's GT with junk below the plane."""
    from ibgs_tpu_torch.eval.tsdf import save_mesh_ply
    from tests.test_dtu_eval import _sphere_mesh
    v, f = _sphere_mesh()
    paths = {"m": str(tmp_path / "m.ply"), "s": str(tmp_path / "s.ply"),
             "gt": str(tmp_path / "gt.ply"), "mv": str(tmp_path / "mv.ply")}
    save_mesh_ply(paths["m"], v, f)
    save_mesh_ply(paths["mv"], v, np.zeros((0, 3), np.int64))
    save_mesh_ply(paths["s"], v * 1.1 + np.array([0.03, -0.02, 0.01]), f)
    junk = np.random.default_rng(0).normal(0, 0.2, (500, 3)) \
        + np.array([0, -30.0, 0])
    save_mesh_ply(paths["gt"], np.concatenate([v, junk]), f)
    return paths


def _obsmask(tmp_path):
    from scipy.io import savemat
    om = tmp_path / "ObsMask"
    om.mkdir()
    BB = np.array([[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]], np.float32)
    shape = tuple(int(x) for x in np.ceil((BB[1] - BB[0]) / 0.5) + 1)
    savemat(om / "ObsMask1_10.mat", {"ObsMask": np.ones(shape, np.uint8),
                                     "BB": BB, "Res": np.array([[0.5]])})
    savemat(om / "Plane1.mat", {"P": np.array([[0.0], [1.0], [0.0], [2.0]])})
    return str(om)


GEO_CASES = {
    "chamfer": ["chamfer", "--mesh", "{s}", "--gt", "{mv}", "--downsample",
                "0.05"],
    "chamfer_obsmask": ["chamfer", "--mesh", "{m}", "--gt", "{gt}",
                        "--downsample", "0", "--max_dist", "10",
                        "--obsmask_dir", "{om}", "--scan", "1",
                        "--patch_size", "1"],
    "fscore": ["fscore", "--mesh", "{s}", "--gt", "{mv}", "--threshold",
               "0.05"],
}


@pytest.mark.parametrize("case", sorted(GEO_CASES))
def test_eval_geometry_matches_jax(case, tmp_path):
    import scripts.eval_geometry as jge
    from ibgs_tpu_torch.scripts import eval_geometry as tge
    subs = dict(_meshes(tmp_path), om=_obsmask(tmp_path))
    argv = [a.format(**subs) for a in GEO_CASES[case]]
    want, got = jge.main(argv), tge.main(argv)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got.get("fscore", 1.0) > 0 and got.get("overall", 0.0) < 1.0


def test_eval_geometry_cull_matches_jax(tmp_path):
    """tests/test_dtu_eval.py's two-view mask cull: the same culled mesh
    (vertices within 1e-6, faces equal)."""
    import scripts.eval_geometry as jge
    from ibgs_tpu.eval.tsdf import load_mesh_ply
    from PIL import Image
    from ibgs_tpu_torch.eval.tsdf import save_mesh_ply
    from ibgs_tpu_torch.scripts import eval_geometry as tge
    from tests.test_dtu_eval import _sphere_mesh
    v, f = _sphere_mesh()
    verts = np.concatenate([v, v * 0.25 + np.array([1.3, 0.0, -0.15])])
    faces = np.concatenate([f, f + len(v)])
    mesh = str(tmp_path / "mesh.ply")
    save_mesh_ply(mesh, verts, faces)
    inst = tmp_path / "scan"
    (inst / "mask").mkdir(parents=True)
    W, H, fl = 200, 160, 120.0
    K = np.array([[fl, 0, W / 2], [0, fl, H / 2], [0, 0, 1.0]])
    cams = {}
    for i, ang in enumerate([0.0, np.pi / 2]):
        eye = np.array([4 * np.sin(ang), 0.0, -4 * np.cos(ang)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        t = -R @ eye
        P = np.eye(4)
        P[:3, :3], P[:3, 3] = K @ R, K @ t
        cams[f"world_mat_{i}"] = P.astype(np.float32)
        cams[f"scale_mat_{i}"] = np.diag([2.0, 2.0, 2.0, 1.0]).astype(
            np.float32)
        m = np.zeros((H, W), np.uint8)
        uv = K @ (R @ (2.0 * verts[: len(v)]).T + t[:, None])
        u, vv = (uv[0] / uv[2]).astype(int), (uv[1] / uv[2]).astype(int)
        ok = (u >= 0) & (u < W) & (vv >= 0) & (vv < H)
        m[vv[ok], u[ok]] = 255
        Image.fromarray(m).save(inst / "mask" / f"{i:03d}.png")
    np.savez(inst / "cameras.npz", **cams)
    outs = []
    for mod, name in ((jge, "j.ply"), (tge, "t.ply")):
        mod.main(["cull", "--mesh", mesh, "--instance_dir", str(inst),
                  "--out", str(tmp_path / name)])
        outs.append(load_mesh_ply(str(tmp_path / name)))
    (vj, fj), (vt, ft) = outs
    assert 0.8 * len(v) < len(vt) <= 1.05 * len(v)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ft, fj)


# ---- convert_data_to_json --------------------------------------------------

@pytest.mark.parametrize("scene_type", ["object", "indoor", "outdoor"])
def test_convert_data_to_json_matches_jax(scene_type, tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "scripts", "preprocess"))
    import convert_data_to_json as jcj
    from ibgs_tpu_torch.scripts import convert_data_to_json as tcj
    files = {}
    for tag, mod in (("j", jcj), ("t", tcj)):
        scene = tmp_path / tag
        shutil.copytree(FIXTURE, scene)
        mod.main(["--data_dir", str(scene), "--scene_type", scene_type,
                  "--write_split", "--hold", "4"])
        files[tag] = {n: open(scene / n).read()
                      for n in ("transforms.json", "split.json")}
    assert files["t"] == files["j"]
    out = json.loads(files["t"]["transforms.json"])
    assert len(out["frames"]) == 4 and (out["w"], out["h"]) == (64, 48)


# ---- the example -----------------------------------------------------------

def test_example_render_matches_jax():
    from ibgs_tpu.ops.epilogue import SourceViews as JSourceViews
    from ibgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
    from ibgs_tpu.renderer import render_view as jrender_view
    from ibgs_tpu_torch.examples import render_synthetic as ex
    from tests.utils import simple_camera
    W, H = 64, 48
    scene = ex.grid_scene(W, H, "cpu")
    got = ex.render(scene)

    g = np.mgrid[-3:4, -3:4].reshape(2, -1).T.astype(np.float32) * 0.22
    pts = np.concatenate([g, np.full((len(g), 1), 0.0, np.float32)], axis=1)
    pts[:, 2] += 0.05 * np.sin(3 * pts[:, 0])
    cols = np.stack([(g[:, 0] + 1) / 2 % 1, (g[:, 1] + 1) / 2 % 1,
                     np.full(len(g), 0.6)], axis=1).astype(np.float32)
    model = jg.init_from_points(pts, cols, max_sh_degree=2)
    S = 2
    rng = np.random.default_rng(0)
    src = JSourceViews(
        images=jnp.asarray(rng.random((S, H, W, 3)), jnp.float32),
        depths=jnp.full((S, H, W), 3.0, jnp.float32),
        ref_to_src=jnp.tile(jnp.eye(4)[None], (S, 1, 1)),
        cam_pos=jnp.asarray(rng.random((S, 3)) * 0.1, jnp.float32),
        count=jnp.int32(S))
    want, _ = jrender_view(model, simple_camera(W, H),
                           JRasterConfig(instance_cap=1 << 14,
                                         backend="oracle"),
                           jnp.array([0.1, 0.1, 0.15]), src=src,
                           render_geo=True)
    for name in ("render", "median_depth", "final_t"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    covered = got.final_t.detach().numpy() < 0.9
    assert covered.any()
    assert 2.0 < got.median_depth.detach().numpy()[covered].mean() < 4.0
    gx = ex.xyz_grad(scene)
    assert bool(torch.isfinite(gx).all()) and float(gx.abs().max()) > 0
