"""The kernels' inputs on the converged bundle (bench_bundle.npz), for
tests/test_torch_gpu.py and chip_smoke.py's kernel table: the bundle at
960x544 and 1920x1088, its prepared renders, a train state and sources,
the kernels' arguments in one real backward of the training objective in
render_geo (iteration 13,000) and colour (5,000) mode; the random 1M
scene of `ibgs_tpu_torch.bench`; a seeded train step's optimizer inputs
at any slot count; the comparisons that hold each kernel to its plain
twin, and exact launch counts.  Nothing here runs at import.
"""
import contextlib
import math
import os
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(ROOT, "bench_bundle.npz")
SIZES = [(960, 544), (1920, 1088)]
ITER_GEO, ITER_COLOR = 13000, 5000  # after / before geometry rendering
FIELDS = ("color", "normal", "final_t", "n_contrib", "buf_depth",
          "buf_weight", "buf_contrib")


@contextlib.contextmanager
def recording():
    """Record the arguments of every blend backward, rgb10 pack, warp
    forward and backward and projection forward and backward launch while
    the block runs: yields {name: [args, ...]}."""
    from ibgs_tpu_torch.ops import blend, epilogue
    from ibgs_tpu_torch.ops import preprocess as pre
    slots = ((blend, "blend_bwd"), (epilogue, "rgb10_pack"),
             (epilogue, "warp_fwd"), (epilogue, "warp_bwd"),
             (pre, "preprocess_fwd"), (pre, "preprocess_bwd"))
    seen = {name: [] for _, name in slots}
    kernels = [getattr(mod, name + "_cuda") for mod, name in slots]

    def recorder(fn, name):
        def call(*a):
            seen[name].append(a)
            return fn(*a)
        return call
    for (mod, name), fn in zip(slots, kernels):
        setattr(mod, name + "_cuda", recorder(fn, name))
    try:
        yield seen
    finally:
        for (mod, name), fn in zip(slots, kernels):
            setattr(mod, name + "_cuda", fn)


def warp_args(fwd, bwd):
    """(the eight tensor inputs of the forward, the intrinsics, the two
    cotangents) of a recorded warp forward and backward call, detached."""
    *tensors, fx, fy, cx, cy = fwd
    return (tuple(t.detach() for t in tensors), (fx, fy, cx, cy),
            tuple(g.detach() for g in bwd[-2:]))


def preprocess_args(model, cam, learnt, tile_h, tile_w):
    """preprocess_fwd_cuda's arguments for `model` seen from `cam`, as
    rasterize passes them."""
    nw, off = model.oriented_normal(cam.cam_pos, learnt=learnt)
    return (model.params.xyz.detach(), model.scale.detach(),
            model.quat_unit.detach(), model.opacity.detach(),
            model.sh_coeffs.detach(), model.active_sh_degree, nw.detach(),
            off.detach(), cam, tile_h, tile_w, model.alive)


def random_scene(dev, wh, n=1_000_000):
    """`ibgs_tpu_torch.bench`'s random scene of n splats in 1.31 n slots
    and its camera at wh."""
    from ibgs_tpu_torch.bench import random_model, round_up, simple_camera
    return (random_model(n, round_up(1.31 * n, 1024), dev),
            simple_camera(*wh, device=dev))


def bundle_inputs(dev, sizes=SIZES, path=BUNDLE):
    """A namespace of the bundle on `dev`: `d` (its arrays), `opt`,
    `rcfg`, `scenes` and `preps` by size, `phases` and `iters` by mode (1
    render_geo, 0 colour), `bg`, `nearest`, `extent`, `train_inputs(wh)`
    (a fresh train state and the step's sources) and `captured` by (size,
    mode): the blend backward's arguments, the warp's (forward inputs,
    intrinsics, cotangents, images) in render_geo, the projection
    forward's arguments and backward's cotangents."""
    import numpy as np
    from ibgs_tpu_torch import convert
    from ibgs_tpu_torch.config import OptimizationParams, PipelineParams
    from ibgs_tpu_torch.models.aggregation import (ColorFusionResidualNet,
                                                   init_fusion_net)
    from ibgs_tpu_torch.ops.rasterize import RasterConfig, prepare
    from ibgs_tpu_torch.renderer import (render_depth_view,
                                         source_views_from_stacks)
    from ibgs_tpu_torch.train import trainer

    b = types.SimpleNamespace(d=dict(np.load(path)))
    b.opt, pipe = OptimizationParams(), PipelineParams()
    b.rcfg = RasterConfig(buffer_len=b.opt.buffer_length,
                          depth_error_threshold=b.opt.depth_error_threshold,
                          staircase_cull=pipe.staircase_cull,
                          row_cap=pipe.row_cap)
    b.scenes = {wh: convert.bundle_scene(b.d, wh[0], wh[1], dev)
                for wh in sizes}

    def prepared(sc):
        model, cam = sc["model"], sc["cam"]
        nw, off = model.oriented_normal(cam.cam_pos,
                                        learnt=b.opt.learnt_normal)
        return prepare(xyz=model.params.xyz, scale=model.scale,
                       quat=model.quat_unit, opacity=model.opacity,
                       sh_coeffs=model.sh_coeffs,
                       active_sh_degree=model.active_sh_degree,
                       normal_world=nw, plane_offset=off, cam=cam,
                       cfg=b.rcfg, alive=model.alive)

    b.preps = {wh: prepared(b.scenes[wh]) for wh in sizes}
    ref_view = b.scenes[sizes[0]]["cam"].view.cpu().numpy()
    b.extent = convert.cameras_extent(np.concatenate(
        [(-ref_view[:3, :3].T @ ref_view[:3, 3])[None],
         np.asarray(b.d["src_cam_pos"], np.float64)]))
    b.nearest = list(range(b.scenes[sizes[0]]["count"]))
    b.phases = {1: trainer.StepPhase(render_geo=True, use_aggregation=True),
                0: trainer.StepPhase(render_geo=False,
                                     use_aggregation=False)}
    b.iters = {1: ITER_GEO, 0: ITER_COLOR}
    b.bg = torch.zeros(3, device=dev)

    def train_inputs(wh):
        sc = b.scenes[wh]
        net = init_fusion_net(ColorFusionResidualNet(
            32, b.opt.feat_aggregate_mode), torch.Generator().manual_seed(0))
        state = convert.train_state_from_numpy(
            b.d, net=net, spatial_lr_scale=b.extent, device=dev)
        with torch.no_grad():
            depths = [render_depth_view(state.model, sc["train_cameras"][i],
                                        b.rcfg, b.opt.learnt_normal)
                      for i in b.nearest]
        S = b.rcfg.max_src
        idx = torch.zeros(S, dtype=torch.long)
        idx[:len(b.nearest)] = torch.as_tensor(b.nearest)
        idx = idx.to(dev)
        dstack = torch.stack(depths + [torch.zeros_like(depths[0])]
                             * (S - len(depths)))
        return state, source_views_from_stacks(
            sc["images"][idx], dstack, sc["w2v"][idx], sc["centers"][idx],
            torch.arange(S, device=dev), len(b.nearest), sc["cam"])

    def captured(wh, mode):
        sc = b.scenes[wh]
        state, src = train_inputs(wh)
        with recording() as seen:
            trainer.loss_and_grads(b.opt, b.rcfg, state.net, b.phases[mode],
                                   state, sc["cam"], 0, sc["gt"], src,
                                   b.iters[mode], b.bg, False, 1.0)
        torch.cuda.synchronize()
        feats, start, stop, *geom, saved, cts, row0 = seen["blend_bwd"][0]
        saved = type(saved)(*(getattr(saved, f).detach() for f in FIELDS))
        return ((feats.detach(), start, stop, *geom, saved,
                 tuple(c.detach() for c in cts), row0),
                (*warp_args(seen["warp_fwd"][0], seen["warp_bwd"][0]),
                 seen["rgb10_pack"][0][0]) if mode == 1 else None,
                tuple(a.detach() if torch.is_tensor(a) else a
                      for a in seen["preprocess_fwd"][0]),
                tuple(None if c is None else c.detach()
                      for c in seen["preprocess_bwd"][0][-1]))

    b.train_inputs = train_inputs
    b.captured = {(wh, mode): captured(wh, mode) for wh in sizes
                  for mode in (1, 0)}
    return b


def table_cts(P, dev, seed=2468):
    """Seeded cotangents of the projection's outputs, as strided slices of
    a (P, 15) table, the way rasterize's table hands them back."""
    tab = torch.randn(P, 15, generator=torch.Generator().manual_seed(
        seed)).to(dev)
    return tab[:, 0:2], tab[:, 2:5], tab[:, 6:9], tab[:, 9:12], tab[:, 12]


def ssim_inputs(H, W, stack, dev, seed):
    """Seeded (img1, img2, map gradient) at W x H: a frame pair, or the
    train step's stack: the ground truth expanded over 3 sources (batch
    stride 0) against the masked warps."""
    g = torch.Generator().manual_seed(seed)
    shape = (3, H, W, 3) if stack else (H, W, 3)
    a = torch.rand(shape[-3:], generator=g)
    b = (torch.rand(shape, generator=g) * 0.2 + 0.8 * a).clamp(0, 1)
    ct = torch.randn(shape, generator=g)
    a, b, ct = a.to(dev), b.to(dev), ct.to(dev)
    return (a[None].expand_as(b) if stack else a), b, ct


def optim_inputs(P, dev, seed, aggregation=True, wh=SIZES[0]):
    """A train step's optimizer inputs at P slots with SH 2, drawn from
    `seed` on `dev`: `state` (the model at step 6 with moments and
    statistics, 10% of its slots dead; the exposure table at step 2; the
    fusion net, its 22 tensors, at step 4), `g` (a Grads, the SH terms
    views of one tensor and the screen gradients of another: NaN, +inf and
    -inf planted in the gradients of live and dead slots, of the table, of
    the net and of both screen gradients; the net's zeros without
    aggregation, as a colour step has them), `radii` (int32, a third 0),
    the frame `wh`, the learning rates `lrs` of iteration 13,000, `phase`
    and `net_lr`: the arguments of trainer.apply_grads."""
    from ibgs_tpu_torch.config import OptimizationParams
    from ibgs_tpu_torch.models import gaussians as G
    from ibgs_tpu_torch.models.aggregation import (ColorFusionResidualNet,
                                                   init_fusion_net)
    from ibgs_tpu_torch.train import trainer

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape, scale=1.0, positive=False):
        x = torch.randn(shape, generator=gen, device=dev) * scale
        return x.abs() if positive else x

    def tree(scale=1.0, positive=False):
        return G.GaussianParams(**{
            k: randn((P, *s), scale, positive) for k, s in dict(
                xyz=(3,), sh_dc=(1, 3), sh_rest=(8, 3), log_scale=(3,),
                quat=(4,), opacity_logit=(1,), normal=(3,),
                offset=(1,)).items()})

    alive = torch.rand(P, generator=gen, device=dev) >= 0.1
    model = G.GaussianModel(
        params=tree(), alive=alive, active_sh_degree=2, max_sh_degree=2,
        mu=tree(1e-2), nu=tree(1e-4, True), step=6,
        **{k: randn((P,), 3.0, True) for k in G.STAT_FIELDS})
    g = tree(1e-2)
    # as the projection's backward hands them over: the SH gradient's DC
    # and rest terms are views of one (P, 9, 3) tensor
    sh = torch.cat([g.sh_dc, g.sh_rest], dim=1)
    g.sh_dc, g.sh_rest = sh[:, :1], sh[:, 1:]
    live, dead = alive.nonzero()[:, 0], (~alive).nonzero()[:, 0]
    nan, inf = float("nan"), float("inf")
    g.xyz[live[0], 1] = nan
    g.sh_rest[live[1], 3, 2] = inf
    g.offset[live[2], 0] = -inf
    g.opacity_logit[dead[0], 0] = nan
    g.quat[dead[1], 3] = -inf
    g.sh_rest[dead[2], 7, 0] = inf
    net = init_fusion_net(ColorFusionResidualNet(32, "mean"),
                          torch.Generator().manual_seed(seed)).to(dev)
    params = list(net.parameters())
    g_net = [randn(p.shape, 1e-3) if aggregation else torch.zeros_like(p)
             for p in params]
    if aggregation:
        g_net[4].view(-1)[5] = nan
        g_net[21][2] = inf
    app = (trainer.APP_CAPACITY, 2)
    g_app = randn(app, 1e-2)
    g_app[7, 1] = -inf
    # the screen gradients as column pairs of one (P, 4) table
    table = randn((P, 4), 1e-3)
    screen, screen_abs = table[:, :2], table[:, 2:]
    screen_abs.copy_(screen.abs() + randn((P, 2), 1e-4, True))
    screen[live[3], 0] = nan
    screen[dead[3], 1] = inf
    screen_abs[live[4], 1] = inf
    radii = torch.randint(0, 6, (P,), generator=gen, device=dev,
                          dtype=torch.int32) * (torch.rand(
                              P, generator=gen, device=dev) >= 1 / 3)

    def side(shapes, step):
        return trainer.SideOptState(
            mu=[randn(s, 1e-2) for s in shapes],
            nu=[randn(s, 1e-4, True) for s in shapes], step=step)
    state = trainer.TrainState(
        model=model, app_ab=randn(app, 0.1),
        app_opt=side([app], 2), net=net,
        net_opt=side([p.shape for p in params], 4), spatial_lr_scale=3.7)
    return types.SimpleNamespace(
        state=state, g=trainer.Grads(params=g, app_ab=g_app, net=g_net,
                                     screen=screen, screen_abs=screen_abs),
        radii=radii.to(torch.int32), wh=wh,
        lrs=G.lr_tree(trainer.make_lr_config(OptimizationParams()), ITER_GEO,
                      3.7),
        phase=trainer.StepPhase(True, aggregation), net_lr=1e-3)


def optim_run(x, kernel=True):
    """trainer.apply_grads on optim_inputs `x` (a copy of its net, updated
    in place), through the kernel or with the pass routed to the plain
    chain: (every tensor it returns or updates, the count)."""
    import copy
    import dataclasses
    from ibgs_tpu_torch.models.gaussians import PARAM_FIELDS, STAT_FIELDS
    from ibgs_tpu_torch.ops import optim
    from ibgs_tpu_torch.train import trainer

    net = copy.deepcopy(x.state.net)
    on_kernel = optim.on_kernel
    if not kernel:
        optim.on_kernel = lambda device: False
    try:
        new, count = trainer.apply_grads(
            dataclasses.replace(x.state, net=net), x.g, x.radii, *x.wh,
            x.lrs, net, x.phase, x.net_lr)
    finally:
        optim.on_kernel = on_kernel
    m = new.model
    outs = [*(getattr(getattr(m, t), k) for t in ("params", "mu", "nu")
              for k in PARAM_FIELDS), *(getattr(m, k) for k in STAT_FIELDS),
            new.app_ab, *new.app_opt.mu, *new.app_opt.nu, *net.parameters(),
            *new.net_opt.mu, *new.net_opt.nu]
    return [t.detach() for t in outs], count


# ------------------------------------------------ kernels against plain

def same_bits(a, b):
    """Bit for bit, NaN in the same places (their payloads aside)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def assert_fwd_matches(got, want, int_share=0.0):
    """Blend forward outputs: floats at the forward tolerance; integers
    equal on all but `int_share` of the pixels."""
    n_pix = want.final_t.numel()
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype == torch.int32:
            bad = int((a != b).reshape(n_pix, -1).any(-1).sum())
            assert bad <= int_share * n_pix, (f, bad)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=f)


def assert_columns_close(got, want):
    """Blend backward rows: finite, each column within 1e-4 of its
    largest plain value + 1e-7."""
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().amax(0)
    tol = 1e-4 * want.abs().amax(0) + 1e-7
    assert bool((err <= tol).all()), (err, tol)


def assert_bwd_pair(head, saved, cts, row0, stats=None):
    """blend_bwd_cuda against blend_bwd_plain (its `stats` passed on) by
    assert_columns_close, two runs bit-identical."""
    from ibgs_tpu_torch.ops import blend
    got = blend.blend_bwd_cuda(*head, saved, cts, row0)
    again = blend.blend_bwd_cuda(*head, saved, cts, row0)
    assert_columns_close(got, blend.blend_bwd_plain(*head, saved, cts, row0,
                                                    stats=stats))
    assert torch.equal(got, again)


def assert_warp_close(got, want, rel, abs_, per_column):
    """NaN in the same places; elsewhere |got - want| <= abs_ + rel·|want|
    (forward) or, per column, <= rel·max|want| + abs_ (backward)."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    err = (got - want).abs()[fin]
    if per_column:
        scale = float(want[fin].abs().max()) if fin.any() else 0.0
        assert (float(err.max()) if err.numel() else 0.0) \
            <= rel * scale + abs_
    else:
        assert bool((err <= abs_ + rel * want[fin].abs()).all())


def assert_warp_pair(args, intr, cts, images=None):
    """The pack (only where `images` are given) equal to the tables;
    warp_fwd_cuda's colour sums against warp_views_plain's (1e-5 abs +
    1e-5 rel), its wdepth and depth_err bit for bit, the `valid` mask
    equal; warp_bwd_cuda equal to warp_views_bwd_plain bit for bit, two
    runs bit-identical.  Returns the kernels' forward and backward."""
    from ibgs_tpu_torch.ops import epilogue
    if images is not None:
        assert torch.equal(epilogue.rgb10_pack_cuda(images), args[2])
    k_fwd = epilogue.warp_fwd_cuda(*args, *intr)
    p_fwd = epilogue.warp_views_plain(*args, *intr)
    k1 = epilogue.warp_bwd_cuda(*args[:6], intr, *cts)
    k2 = epilogue.warp_bwd_cuda(*args[:6], intr, *cts)
    p_bwd = epilogue.warp_views_bwd_plain(*args[:6], intr, *cts)
    torch.cuda.synchronize()
    for k, p in zip(k_fwd[:2], p_fwd[:2]):
        assert_warp_close(k, p, 1e-5, 1e-5, per_column=False)
    for k, p in zip(k_fwd[2:], p_fwd[2:]):
        assert same_bits(k, p)

    def valid(out):
        return (out[2] > 0.0) & (out[3] < 0.01)
    assert torch.equal(valid(k_fwd), valid(p_fwd))
    for a, b, p in zip(k1, k2, p_bwd):
        assert a.shape == p.shape and same_bits(a, p) and same_bits(a, b)
    return k_fwd, k1


def assert_pre_fwd(args):
    """preprocess_fwd_cuda against preprocess_fwd_plain on `args` as the
    wrapper takes them: integer fields equal, float fields at the forward
    tolerance, NaN in the same places."""
    from ibgs_tpu_torch.ops import preprocess as pre
    for name, a, b in zip(pre.OUTPUTS, pre.preprocess_fwd_cuda(*args),
                          pre.preprocess_fwd_plain(*args)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == torch.int32:
            assert torch.equal(a, b), name
            continue
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        fin = ~torch.isnan(b)
        assert bool(((a - b).abs()[fin] <= 1e-5 + 1e-5 * b.abs()[fin]).all()
                    ), name


def pre_bwd_args(args):
    """preprocess_bwd_*'s leading arguments from preprocess's."""
    x, s, q, _, sh, active, n, o, cam = args[:9]
    return x, s, q, sh, active, n, o, cam


def assert_pre_bwd_pair(bargs, cts):
    """preprocess_bwd_cuda against autograd of the plain version in
    float32 and float64, per column: the kernel's max |error| against
    float64 at most 2x float32's + 1e-7 of the column's largest |value|,
    non-finite values in the plain version's places; two runs
    bit-identical.  Returns the kernel's gradients."""
    from ibgs_tpu_torch.ops import preprocess as pre
    k1 = pre.preprocess_bwd_cuda(*bargs, cts)
    k2 = pre.preprocess_bwd_cuda(*bargs, cts)
    p32 = pre.preprocess_bwd_plain(*bargs, cts)

    def f64(x):
        return x.double() if torch.is_tensor(x) else x
    p64 = pre.preprocess_bwd_plain(*(f64(a) for a in bargs),
                                   tuple(f64(c) for c in cts))
    torch.cuda.synchronize()
    for a, b, c, a2 in zip(k1, p32, p64, k2):
        if a is None:
            assert b is None and a2 is None
            continue
        assert same_bits(a, a2)
        P = a.shape[0]
        a, b, c = (t.reshape(P, -1).double() for t in (a, b, c))
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
        fin = torch.isfinite(b) & torch.isfinite(c)
        zero = torch.zeros((), dtype=torch.float64, device=a.device)
        ek = torch.where(fin, (a - c).abs(), zero).amax(0)
        ep = torch.where(fin, (b - c).abs(), zero).amax(0)
        scale = torch.where(fin, c.abs(), zero).amax(0)
        assert bool((ek <= 2 * ep + 1e-7 * scale).all()), (ek, ep, scale)
    return k1


BIN_FIELDS = ("order", "rank", "gauss_id", "tile_id", "inst_valid",
              "tile_start", "tile_stop", "slot", "seg_off")


def assert_bins_equal(k, p):
    """Every TileBins field of the kernels equal to the plain version's,
    dtype and shape included, and the two totals."""
    for f in BIN_FIELDS:
        a, b = getattr(k, f), getattr(p, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    assert (k.n_instances, k.n_rows) == (p.n_instances, p.n_rows)


def bins_both(sp, cull, grid, cap=0, row_cap=0):
    """The staircase binning of sp through the kernels and the plain
    version on grid = (TX, TY, TH, TW)."""
    from ibgs_tpu_torch.ops import binning
    TX, TY, TH, TW = grid
    k = binning.bin_staircase_cuda(sp, TX, TY, cap, cull, TH, TW, row_cap)
    p = binning.bin_staircase_plain(sp, TX, TY, cap, cull, TH, TW, row_cap)
    return k, p


def ssim_grads(fn, a, b, ct, need=(True, True)):
    """The map of fn and the gradients of Σ map·ct w.r.t. the inputs that
    `need` one."""
    x = a.detach().requires_grad_(need[0])
    y = b.detach().requires_grad_(need[1])
    out = fn(x, y)
    ins = [t for t in (x, y) if t.requires_grad]
    return (out.detach(), *torch.autograd.grad((out * ct).sum(), ins))


def assert_ssim_pair(a, b, ct, needs=((True, True), (True, False),
                                      (False, True))):
    """The SSIM kernels against the plain chain: the map bit for bit, and
    each gradient bit for bit against autograd through the plain chain,
    for each pair of `needs`; a repeat bit-identical."""
    from ibgs_tpu_torch.ops import ssim as tssim
    from ibgs_tpu_torch.train import losses
    with torch.no_grad():
        assert same_bits(tssim.ssim_map_cuda(a, b),
                         losses.ssim_map_plain(a, b))
    for need in needs:
        k = ssim_grads(tssim.ssim_map_cuda, a, b, ct, need)
        p = ssim_grads(losses.ssim_map_plain, a, b, ct, need)
        for u, v in zip(k, p):
            assert same_bits(u, v), (need, float((u - v).abs().max()))
    again = ssim_grads(tssim.ssim_map_cuda, a, b, ct, need)
    assert all(same_bits(u, v) for u, v in zip(k, again))


def assert_optim_pair(x):
    """The optimizer kernel on optim_inputs `x` against the plain chain:
    every output bit for bit (NaN in the same places), the count exact
    and above 0, a repeat bit-identical.  Returns the count."""
    k, k_count = optim_run(x, True)
    p, p_count = optim_run(x, False)
    again, again_count = optim_run(x, True)
    assert int(k_count) == int(p_count) == int(again_count) > 0, \
        (int(k_count), int(p_count), int(again_count))
    for i, (a, b, c) in enumerate(zip(k, p, again)):
        assert same_bits(a, b), (i, tuple(a.shape), float(
            (a - b).abs().nan_to_num(0.0).max()))
        assert same_bits(a, c), i
    return int(p_count)


# ------------------------------------------------------ launches by path

def launched(fn):
    """fn's result and the kernel launches it made: `_cuda.LAUNCHES`
    zeroed just before, read after a sync, the kernels it did not launch
    left out."""
    from ibgs_tpu_torch.ops import _cuda
    _cuda.LAUNCHES.update(dict.fromkeys(_cuda.LAUNCHES, 0))
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n for k, n in _cuda.LAUNCHES.items() if n}


def want(renders, backwards=0, warps=0, warp_bwds=0, ssim=0,
         tile_passes=None, optim=0):
    """The launches of `renders` renders (each projects its splats and
    blends them; with `tile_passes`, each bins them through the kernels,
    its tile ids sorted in that many radix passes after the depth order's
    4), `backwards` of them backward, `warps` warps (each packs its
    sources first), `warp_bwds` warp backwards, `ssim` SSIM maps with
    their backwards and `optim` optimizer passes; zeros left out."""
    n = {"blend_fwd": renders, "blend_bwd": backwards, "rgb10_pack": warps,
         "warp_fwd": warps, "warp_bwd": warp_bwds,
         "preprocess_fwd": renders, "preprocess_bwd": backwards,
         "ssim_fwd": ssim, "ssim_bwd": ssim, "optim": optim}
    if tile_passes is not None:
        n.update(dict.fromkeys(("bin_key", "bin_count", "bin_emit",
                                "bin_ranges"), renders),
                 bin_radix=renders * (4 + tile_passes))
    return {k: v for k, v in n.items() if v}


def passes(wh, rcfg):
    """Radix passes of the tile sort on the tile grid of a wh frame."""
    from ibgs_tpu_torch.ops import _cuda
    return _cuda.bin_tile_passes(-(-wh[0] // rcfg.tile_w)
                                 * -(-wh[1] // rcfg.tile_h))


def finite(out):
    """Every floating tensor among the values of `out` finite."""
    return all(bool(torch.isfinite(v).all()) for v in out.values()
               if torch.is_tensor(v) and v.is_floating_point())


def served_view(b, wh):
    """One `render_one` of the bundle view at wh: (its outputs, the
    launches it made, the launches it should make: five renders, four
    source depths and one render_geo view, projected, binned and blended,
    one pack and one warp forward, no backward, no SSIM)."""
    from ibgs_tpu_torch.eval.render_driver import EvalRenderer
    from ibgs_tpu_torch.models.aggregation import (ColorFusionResidualNet,
                                                   init_fusion_net)
    sc = b.scenes[wh]
    net = init_fusion_net(ColorFusionResidualNet(
        32, b.opt.feat_aggregate_mode), torch.Generator().manual_seed(0))
    ev = EvalRenderer(sc["model"], net, sc["images"], sc["w2v"],
                      sc["centers"], sc["train_cameras"], b.opt, b.rcfg,
                      device=sc["cam"].view.device)
    out, got = launched(lambda: ev.render_one(sc["cam"], b.nearest))
    return out, got, want(5, warps=1, tile_passes=passes(wh, b.rcfg))


def train_steps(b, n_geo, wh=SIZES[0]):
    """`n_geo` render_geo + aggregation steps of the bundle at wh from a
    fresh state, then one colour-only step (iteration 5,000): per step (its
    loss, whether its losses and gradients are finite, the launches it
    made, the launches it should make: one of each kernel, three SSIM
    maps with their backward and one optimizer pass; the colour step no
    pack or warp, one SSIM map)."""
    from ibgs_tpu_torch.train import trainer
    sc, (state, src), out = b.scenes[wh], b.train_inputs(wh), []
    for mode, n in ((1, n_geo), (0, 1)):
        step = trainer.make_train_step(b.opt, b.rcfg, state.net,
                                       b.phases[mode])
        for _ in range(n):
            (state, aux), got = launched(lambda: step(
                state, sc["cam"], 0, sc["gt"], src, b.iters[mode], b.bg,
                False, 1.0, 1e-3))
            ok = int(aux["nonfinite_grads"]) == 0 and all(
                math.isfinite(float(aux[k])) for k in (
                    "loss", "image_loss", "normal_loss", "photo_loss",
                    "agg_loss", "l1", "psnr"))
            out.append((float(aux["loss"]), ok, got,
                        want(1, 1, mode, mode, 3 if mode else 1,
                             passes(wh, b.rcfg), optim=1)))
    return out
