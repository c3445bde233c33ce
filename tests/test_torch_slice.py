"""The port's serving path as a whole against the JAX package.

`EvalRenderer.render_one` of ibgs_tpu_torch against the same sequence on
ibgs_tpu with backend="oracle": depth-only re-render of the 4 source
views, the IBGS geometry render with the warp into the S = max_src = 5
source slots, and the colour-fusion net (Flax weights carried across,
float32).  Scene: a fixed 4k-splat subset of bench_bundle.npz, at 1/8 of
the bundle camera's resolution (120x68, intrinsics scaled), source images
block-averaged to that size.  Tolerance: rtol/atol 1e-4 on float images.

Also: importing every ibgs_tpu_torch module (and chip_smoke.py) leaves
jax, flax and ibgs_tpu out of sys.modules.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ibgs_tpu.core import camera as jcam
from ibgs_tpu.models import aggregation as jagg
from ibgs_tpu.models import gaussians as jg
from ibgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ibgs_tpu.renderer import (render_depth_view, render_view,
                               source_views_from_stacks)
from ibgs_tpu_torch import convert
from ibgs_tpu_torch.config import OptimizationParams, PipelineParams
from ibgs_tpu_torch.eval.render_driver import EvalRenderer
from ibgs_tpu_torch.ops.rasterize import RasterConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N_SPLATS, CAP = 120, 68, 4000, 1 << 13
TOL = 1e-4


def _bundle():
    d = dict(np.load(os.path.join(ROOT, "bench_bundle.npz")))
    sub = np.sort(np.random.default_rng(0).choice(
        d["xyz"].shape[0], N_SPLATS, replace=False))
    for k in convert.PARAM_FIELDS:
        d[k] = d[k][sub]
    bh, bw = d["gt"].shape[:2]

    def down(x):   # block mean over 8x8 pixels
        f = bh // H
        return x.reshape(x.shape[:-3] + (H, f, W, f, x.shape[-1])).mean(
            axis=(-4, -2)).astype(np.float32)

    d["gt"] = down(d["gt"])
    d["src_images"] = down(d["src_images"])
    d["src_depths"] = down(d["src_depths"][..., None])[..., 0]
    return d


def _jax_model(d):
    n = d["xyz"].shape[0]
    m = jg.init_from_points(np.zeros((4, 3), np.float32),
                            np.zeros((4, 3), np.float32), 2, capacity=n)
    return m.replace(
        params=jg.GaussianParams(**{k: jnp.asarray(d[k], jnp.float32)
                                    for k in convert.PARAM_FIELDS}),
        alive=jnp.ones((n,), bool), active_sh_degree=jnp.int32(2))


def _jax_serve(d, net, net_params, opt):
    """ibgs_tpu's EvalRenderer.render_one sequence, spelled out."""
    fovx, fovy = float(d["fovx"]), float(d["fovy"])
    cam = jcam.make_camera(d["cam_R"], d["cam_t"], fovx, fovy, W, H)
    views = [np.asarray(m, np.float32) @ np.asarray(cam.view)
             for m in d["src_ref_to_src"]]
    cams = [jcam.make_camera(v[:3, :3].T, v[:3, 3], fovx, fovy, W, H)
            for v in views]
    rcfg = JRasterConfig(instance_cap=CAP, row_cap=CAP, backend="oracle",
                         buffer_len=opt.buffer_length, staircase_cull=True,
                         depth_error_threshold=opt.depth_error_threshold)
    model = _jax_model(d)
    depth_fn = jax.jit(lambda m, c: render_depth_view(m, c, rcfg))
    depths = [depth_fn(model, c) for c in cams]
    idx = jnp.asarray([0, 1, 2, 3, 0])
    src = source_views_from_stacks(
        jnp.asarray(d["src_images"])[idx],
        jnp.stack(depths + [jnp.zeros((H, W))]),
        jnp.asarray(np.stack(views))[idx],
        jnp.asarray(d["src_cam_pos"])[idx], jnp.arange(5, dtype=jnp.int32),
        jnp.int32(4), cam)

    @jax.jit
    def render(model, cam, src):
        res, _ = render_view(model, cam, rcfg, jnp.zeros(3), src=src,
                             render_geo=True, return_depth_normal=False)
        fusion = jagg.fuse_color(
            net, net_params, res.render, res.ibr.warped_image,
            res.ibr.cam_feat, res.ibr.camera_ray, res.ibr.min_depth_diff,
            res.ibr.use_first_src_mask, jnp.float32(1.0),
            opt.nb_visible_src_frames, False, 1.0, False)
        agg = jnp.where(fusion["any_valid"], fusion["image_pred"], res.render)
        return dict(render=res.render, depth=res.median_depth,
                    warped=res.ibr.warped_image, aggregate=agg,
                    n_instances=res.n_instances)

    return {k: np.asarray(v) for k, v in render(model, cam, src).items()}


def test_serving_slice_matches_jax():
    d = _bundle()
    opt = OptimizationParams(enable_mix_precision=False)
    net = jagg.ColorFusionResidualNet(
        feat_aggregate_mode=opt.feat_aggregate_mode)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((8, 8, 3, 7)),
                      jnp.zeros((8, 8, 3)), jnp.zeros((8, 8, 3)))
    want = _jax_serve(d, net, params, opt)

    sc = convert.bundle_scene(d, W, H, device="cpu")
    pipe = PipelineParams()
    rcfg = RasterConfig(buffer_len=opt.buffer_length,
                        depth_error_threshold=opt.depth_error_threshold,
                        staircase_cull=pipe.staircase_cull,
                        row_cap=pipe.row_cap)
    tnet = convert.fusion_net_from_flax(
        jax.tree.map(np.asarray, params), opt.feat_aggregate_mode, "cpu")
    ev = EvalRenderer(sc["model"], tnet, sc["images"], sc["w2v"],
                      sc["centers"], sc["train_cameras"], opt, rcfg,
                      device="cpu")
    got = ev.render_one(sc["cam"], [0, 1, 2, 3])

    assert got["n_instances"] == int(want["n_instances"]) < CAP
    assert got["warped"].shape == (5, H, W, 3)
    for k in ("render", "depth", "warped", "aggregate"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    # the scene is really rendered and fused: most pixels are covered and
    # a good share have a valid warped source
    assert float((got["depth"] > 0).float().mean()) > 0.7
    assert float((got["warped"][0].abs().sum(-1) > 0).float().mean()) > 0.2


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ibgs_tpu_torch\n"
        "for m in pkgutil.walk_packages(ibgs_tpu_torch.__path__,"
        " 'ibgs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'ibgs_tpu'))\n"
        "assert not bad, bad\n"
        "print(sum(m.startswith('ibgs_tpu_torch') for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
