"""The reference held to the port's plain path at a tiny size on the CPU
(the port runs its plain PyTorch versions there; the reference's blend is
vectorised over each tile's instances, so the two agree to float32
rounding), and the reference's imports: it loads no module whose top-level
name is jax, jaxlib, flax, ibgs_tpu or ibgs_tpu_torch.  These tests may
import the port; the reference may not."""
from __future__ import annotations

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, sides
from benchmark import scene as sc

FORBIDDEN = ("jax", "jaxlib", "flax", "ibgs_tpu", "ibgs_tpu_torch")
REFERENCE = harness.HERE / "reference"


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny_scene(seed: int = 3, n: int = 600, W: int = 64, H: int = 48):
    """A few hundred splats near the origin seen from a ring of 5 views."""
    g = torch.Generator().manual_seed(seed)
    cfg = harness.read_json(harness.HERE / "configs" / "prod-1m.json")
    mod = harness.load_module(harness.HERE / "configs" / "prod-1m.py")
    cfg = dict(cfg, gt_points=4 * n, seed_points=n, capacity=n + 64,
               views=6, eval_every=6)
    s = mod.build(cfg, {"width": W, "height": H}, seed, "cpu")
    # opacities and SH from the seed so that every field has a gradient
    p = s.params
    p["opacity_logit"][: n] = torch.randn(n, 1, generator=g)
    p["sh_rest"][: n] = 0.1 * torch.randn(n, 8, 3, generator=g)
    p["quat"][: n] = torch.randn(n, 4, generator=g)
    p["log_scale"][: n] += 0.3 * torch.randn(n, 3, generator=g)
    p["normal"][: n] = torch.randn(n, 3, generator=g)
    return s


def _step(side, scene, k_steps=2):
    state = side.train_state()
    order = scene.train_ids[:k_steps]
    cache = {j: side.depth(state.model, j) for j in range(len(scene.views))}
    step = side.m.trainer.make_train_step(
        side.opt, side.rcfg, state.net,
        side.m.trainer.StepPhase(render_geo=True, use_aggregation=True))
    out = []
    for k, i in enumerate(order):
        state, aux = step(state, side.cams[i], i, scene.images[i],
                          side.sources(i, cache, side.cams[i]), 13000 + k,
                          side.bg, False, 1.0, 1e-3)
        out.append({n: float(aux[n]) for n in
                    ("loss", "image_loss", "normal_loss", "photo_loss",
                     "agg_loss")})
    return out, state


def test_train_steps_match_the_port_plain_path():
    s = tiny_scene()
    port = sides.Side(sides.port_modules(), s, "cpu")
    ref = sides.Side(sides.reference_modules(), s, "cpu")
    lp, sp = _step(port, s)
    lr, sr = _step(ref, s)
    for dp, dr in zip(lp, lr):
        for k in dr:
            assert np.isfinite(dr[k])
            assert dp[k] == pytest.approx(dr[k], rel=1e-4, abs=1e-7), k
    for k in sc.PARAM_FIELDS:
        mp, mr = getattr(sp.model.mu, k), getattr(sr.model.mu, k)
        assert float(mr.abs().sum()) > 0, k
        assert float((mp - mr).norm()) <= 1e-3 * float(mr.norm()), k
        torch.testing.assert_close(getattr(sp.model.params, k),
                                   getattr(sr.model.params, k), rtol=1e-4,
                                   atol=1e-5, msg=k)
    # Adam moves a weight by about lr whatever its gradient's size, so a
    # near-zero gradient whose sign differs moves it the other way: held
    # by the norm of the change
    for (name, a), b in zip(sp.net.named_parameters(), sr.net.parameters()):
        moved = float((b.detach() - s.net[name]).norm())
        assert float((a - b).detach().norm()) <= 1e-2 * moved, name


def test_served_view_matches_the_port_plain_path():
    s = tiny_scene(seed=4)
    port = sides.Side(sides.port_modules(), s, "cpu")
    ref = sides.Side(sides.reference_modules(), s, "cpu")
    ev = port.m.render_driver.EvalRenderer(
        port.model(), port.net(), s.images, port.w2v, port.centers,
        port.cams, port.opt, port.rcfg, device="cpu")
    view = sc.offset_views(s.serve_views[0], np.random.default_rng(1), 1,
                           2.0, 0.06)[0]
    nearest = s.serve_nearest[0]
    a = ev.render_one(port.camera(view), nearest)
    b = ref.m.serve.render_one(ref.model(), ref.net().eval(), ref.stacks(),
                               ref.cams, ref.opt, ref.rcfg, ref.camera(view),
                               nearest)
    for k in ("render", "depth", "warped", "aggregate"):
        torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-5,
                                   msg=k)
    assert float(b["depth"].abs().sum()) > 0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_forbidden(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"
        if top == "benchmark":
            assert name.startswith("benchmark.reference"), name


def test_reference_loads_nothing_forbidden():
    code = ("import sys\n"
            "import benchmark.reference.trainer, benchmark.reference.serve\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(harness.ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN)


def _prepared(s, view=0):
    from benchmark.reference import rasterize
    ref = sides.Side(sides.reference_modules(), s, "cpu")
    model = ref.model()
    cam = ref.cams[view]
    nw, off = model.oriented_normal(cam.cam_pos)
    pr = rasterize.prepare(
        xyz=model.params.xyz, scale=model.scale, quat=model.quat_unit,
        opacity=model.opacity, sh_coeffs=model.sh_coeffs,
        active_sh_degree=model.active_sh_degree, normal_world=nw,
        plane_offset=off, cam=cam, cfg=ref.rcfg, alive=model.alive)
    return ref, cam, pr


@pytest.mark.parametrize("mode", ["render_geo", "depth_only", "color"])
def test_tile_blend_matches_the_walk(mode, monkeypatch):
    """The vectorised blend against the port's per-pixel walk (frozen in
    reference/blend.py): every output, and the gradient of the instance
    table against the walk's analytic VJP.  Small chunks and groups, so
    that state crosses chunk and group edges."""
    from benchmark.reference import blend, tileblend
    monkeypatch.setattr(tileblend, "ELEMENTS", 512 * 16)
    monkeypatch.setattr(tileblend, "GROUP_TILES", 2)
    s = tiny_scene(seed=5, n=900)
    ref, cam, pr = _prepared(s)
    cfg = ref.rcfg.blend_cfg(render_geo=mode == "render_geo",
                             depth_only=mode == "depth_only")
    feats = pr.feats_inst.detach().requires_grad_(True)
    args = (pr.bins.tile_start, pr.bins.tile_stop, pr.Wp, pr.Hp, cam.fx,
            cam.fy, cam.cx, cam.cy, cfg, 0.0)
    a = tileblend.blend_tiles(feats, *args)
    b = blend.BlendOutputs(*blend._BlendFunction.apply(feats, *args))
    for k in ("n_contrib", "buf_contrib"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in ("color", "normal", "final_t", "buf_depth", "buf_weight"):
        torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=1e-5,
                                   atol=1e-6, msg=k)
    assert int(b.n_contrib.sum()) > 0
    if mode == "depth_only":
        return
    g = torch.Generator().manual_seed(9)
    cts = [torch.randn(x.shape, generator=g) for x in
           (a.color, a.normal, a.final_t, a.buf_depth, a.buf_weight)]

    def loss(o):
        return sum((x * c).sum() for x, c in
                   zip((o.color, o.normal, o.final_t, o.buf_depth,
                        o.buf_weight), cts))

    # columns 13 and 14 (FAX, FAY) carry the walk's per-pixel absolute
    # screen-gradient sums for the densification statistics, no gradient
    # of the forward: the reference does not compute them
    ga, = torch.autograd.grad(loss(a), feats)
    gb, = torch.autograd.grad(loss(b), feats)
    ga, gb = ga[:, :13], gb[:, :13]
    scale = gb.abs().amax(0, keepdim=True) + 1e-12
    assert float(((ga - gb).abs() / scale).max()) < 1e-4
