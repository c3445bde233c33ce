"""IBR epilogue of the PyTorch port against the JAX package.

Both packages get the same numpy blend outputs (a near-planar median
buffer with empty slots) and S=3 source views whose images spill outside
[0, 1], so the rgb10 packing of the colour tables is exercised.
Tolerance: float fields rtol/atol 1e-5; integer fields exact.  The rgb10
words equal the JAX package's bit for bit, also for NaN and inf.

Gradients: the hand-written VJP of `warp_views` against the JAX package's
`_warp_views` VJP (both on the rgb10 footprint-row tables) and against
torch autograd of `warp_views_plain`; and the
gradient of a loss that reads every float field of IBROutputs w.r.t. the
buffer depths and weights against `jax.grad` through `ibr_epilogue`, which
stops the gradient at the source views, `camera_ray`, `cam_feat`,
`min_depth_diff`, `valid_src_weight` and the occlusion test.  Tolerance
rtol 1e-4 and atol 1e-5 x max |gradient| for the warp; atol 1e-4 x max
|gradient| for the whole epilogue, whose d median / d weight = (depth -
median) / sum of weights cancels about two digits on depths of 3 +- 0.03
(the two packages round the sums differently).  A gradient that leaks
through a stopped output differs by O(max |gradient|).  The warp's
occlusion outputs against the JAX package's depth sample at the forward
tolerance.
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
from ibgs_tpu_torch.ops import _cuda
from ibgs_tpu_torch.ops import epilogue as tep
from ibgs_tpu_torch.ops.blend_common import BlendOutputs
from tests.test_torch_slice import one_torch_thread  # noqa: F401
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


@pytest.mark.parametrize("case", ["pack", "rows", "unpack", "bilinear_rgb",
                                  "bilinear_gray"])
def test_rgb10_quantisation_and_bilinear(case):
    """`pack_rgb10` equals the JAX package's bit for bit, also on NaN, +-inf,
    negatives and values above 1, and `pack_rgb10_rows` its
    `pack_bilinear_corners_rgb10`; `unpack_rgb10` equals `_unpack_rgb10`
    and, for finite colours, the 10-bit grid round(clip(x, 0, 1)·1023) ·
    (1/1023); `bilinear_sample` equals the JAX package's."""
    r = np.random.default_rng(3)
    img = r.uniform(-0.2, 1.2, (9, 11, 3)).astype(np.float32)
    if case in ("pack", "rows", "unpack"):
        odd = img.copy()
        odd[0, :4] = [[np.nan, 0.5, 0.25], [np.inf, -np.inf, np.nan],
                      [-0.0, 1.0, 2.0], [0.5 / 1023, 1.5 / 1023, 1e30]]
        words = jep.pack_rgb10(jnp.asarray(odd))
        got = tep.pack_rgb10(torch.as_tensor(odd))
        if case == "pack":
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(words))
            return
        if case == "rows":
            rows = jep.pack_bilinear_corners_rgb10(jnp.asarray(odd))
            np.testing.assert_array_equal(
                tep.pack_rgb10_rows(torch.as_tensor(odd)).numpy(),
                np.asarray(rows).reshape(odd.shape[:2] + (4,)))
            return
        want = np.stack(jep._unpack_rgb10(words), -1)
        np.testing.assert_array_equal(tep.unpack_rgb10(got).numpy(), want)
        t = torch.as_tensor(img)
        grid = torch.round(torch.clamp(t, 0.0, 1.0) * 1023.0) * (1.0 / 1023.0)
        np.testing.assert_array_equal(
            tep.unpack_rgb10(tep.pack_rgb10(t)).numpy(), grid.numpy())
        return
    u = r.uniform(-2, 13, (5, 7)).astype(np.float32)
    v = r.uniform(-2, 11, (5, 7)).astype(np.float32)
    im = img if case == "bilinear_rgb" else img[..., 0]
    _close(tep.bilinear_sample(torch.as_tensor(im), torch.as_tensor(u),
                               torch.as_tensor(v)),
           jep.bilinear_sample(jnp.asarray(im), jnp.asarray(u),
                               jnp.asarray(v)))


def _warp_inputs(seed, src_hw=None, row0=0):
    """Buffer, sources, rays, intrinsics and cotangents of the warp;
    `src_hw` gives the sources another size than the view's, `row0` puts
    the view's rows at [row0, row0 + H) of the image (a band).  bd and bw
    are (H, W, B) numpy buffers; the median is the epilogue's."""
    bl, src = _f32(_blend(seed)), _f32(_sources(seed + 10))
    if src_hw is not None:
        r = np.random.default_rng(seed + 30)
        src["images"] = r.uniform(-0.1, 1.1, (S,) + src_hw + (3,)
                                  ).astype(np.float32)
        src["depths"] = (3.0 + r.normal(size=(S,) + src_hw) * 0.03
                         ).astype(np.float32)
    jc = simple_camera(W, H)
    bd, bw = bl["buf_depth"], bl["buf_weight"]
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32) + np.float32(row0))
    intr = [float(np.float32(v)) for v in (jc.fx, jc.fy, jc.cx, jc.cy)]
    pdx = ((gx - np.float32(intr[2])) / np.float32(intr[0])).astype(np.float32)
    pdy = ((gy - np.float32(intr[3])) / np.float32(intr[1])).astype(np.float32)
    src["median"] = ((bw * bd).sum(-1) / (bw.sum(-1) + np.float32(tep.EPS))
                     ).astype(np.float32)
    r = np.random.default_rng(seed + 20)
    cts = (r.normal(size=(S, H, W, 3)).astype(np.float32),
           r.normal(size=(S, H, W)).astype(np.float32))
    return bd, bw, src, pdx, pdy, intr, cts


def _close_grad(got, want, msg, atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=atol * np.abs(want).max(), err_msg=msg)


def _buffers(bd, bw, requires_grad=False):
    """The (B, H, W) views of (H, W, B) buffers that the epilogue passes."""
    return tuple(torch.as_tensor(x).requires_grad_(requires_grad)
                 for x in (bd, bw))


def _torch_warp_args(src, pdx, pdy):
    return dict(tables=tep.pack_rgb10_rows(torch.as_tensor(src["images"])),
                r2s=torch.as_tensor(src["ref_to_src"]),
                pdx=torch.as_tensor(pdx), pdy=torch.as_tensor(pdy),
                median=torch.as_tensor(src["median"]),
                depths=torch.as_tensor(src["depths"]))


def _warp_call(fn, d, w, t, intr):
    """fn(bd, bw, tables, r2s, pdx, pdy, median, depths, fx, fy, cx, cy)
    on the (B, H, W) views of the (H, W, B) tensors d, w."""
    return fn(d.permute(2, 0, 1), w.permute(2, 0, 1), t["tables"], t["r2s"],
              t["pdx"], t["pdy"], t["median"], t["depths"], *intr)


@pytest.mark.parametrize("seed,src_hw,row0", [
    (0, None, 0), (1, None, 0), (2, (20, 36), 0), (3, (44, 60), 16)],
    ids=["0", "1", "smaller_sources", "larger_sources_row0_16"])
def test_warp_views_vjp(seed, src_hw, row0):
    """The plain backward `warp_views_bwd_plain`, the autograd Function
    and torch autograd of `warp_views_plain` (the (B, H, W) views of the
    blend's (H, W, B) buffers, rgb10 footprint rows, the occlusion inputs)
    against
    the JAX `_warp_views` VJP, also with sources of another size than the
    view and on a band of rows starting at row0 > 0."""
    bd, bw, src, pdx, pdy, intr, cts = _warp_inputs(seed, src_hw, row0)
    Hs, Ws = src["images"].shape[1:3]
    tables = jnp.stack([jep.pack_bilinear_corners_rgb10(
        jnp.asarray(src["images"][s])).reshape(Hs, Ws, 4) for s in range(S)])
    _, vjp = jax.vjp(
        lambda d, w: jep._warp_views(d, w, tables,
                                     jnp.asarray(src["ref_to_src"]),
                                     jnp.asarray(pdx), jnp.asarray(pdy),
                                     jnp.asarray(intr, jnp.float32)),
        jnp.asarray(np.transpose(bd, (2, 0, 1))),
        jnp.asarray(np.transpose(bw, (2, 0, 1))))
    want_d, want_w = vjp(tuple(jnp.asarray(c) for c in cts))

    t = _torch_warp_args(src, pdx, pdy)
    d, w = _buffers(bd, bw)
    grads = {"bwd_plain": [x.numpy() for x in tep.warp_views_bwd_plain(
        d.permute(2, 0, 1), w.permute(2, 0, 1), t["tables"], t["r2s"],
        t["pdx"], t["pdy"], intr, *(torch.as_tensor(c) for c in cts))]}
    for name, fn in (("vjp", tep.warp_views), ("plain", tep.warp_views_plain)):
        d, w = _buffers(bd, bw, requires_grad=True)
        wsc, ws, *_ = _warp_call(fn, d, w, t, intr)
        loss = (wsc * torch.as_tensor(cts[0])).sum() \
            + (ws * torch.as_tensor(cts[1])).sum()
        grads[name] = [x.permute(2, 0, 1).numpy()
                       for x in torch.autograd.grad(loss, [d, w])]
    assert np.abs(np.asarray(want_d)).max() > 0
    for name, (gd, gw) in grads.items():
        _close_grad(gd, want_d, f"{name} dbd")
        _close_grad(gw, want_w, f"{name} dbw")
    # the Function's backward is the plain backward, bit for bit
    for a, b in zip(grads["vjp"], grads["bwd_plain"]):
        np.testing.assert_array_equal(a, b)
    if src_hw is not None and src_hw[1] < W:
        # the smaller sources' bounds mask some used entries out
        ws = _warp_call(tep.warp_views_plain, *_buffers(bd, bw), t, intr)[1]
        assert (ws.numpy() < bw.sum(-1)[None] * (1 - 1e-6)).any()


@pytest.mark.parametrize("seed,src_hw,row0", [
    (0, None, 0), (2, (20, 36), 0), (3, (44, 60), 16)],
    ids=["0", "smaller_sources", "larger_sources_row0_16"])
def test_warp_occlusion_outputs_match_jax(seed, src_hw, row0):
    """The plain forward's `wdepth` and `depth_err` against the JAX
    package's occlusion expressions (`ibr_epilogue`: its bilinear_sample_
    packed of pack_bilinear_corners(depths[s]) at the median point, the
    bound against the view's width) on the same median, also with sources
    of another size and on a band at row0 > 0; no gradient."""
    bd, bw, src, pdx, pdy, intr, _ = _warp_inputs(seed, src_hw, row0)
    Hs, Ws = src["depths"].shape[1:]
    fx, fy, cx, cy = intr
    m = jnp.asarray(src["median"])
    mx, my, mz = (jnp.asarray(pdx) * m)[None], (jnp.asarray(pdy) * m)[None], \
        m[None]
    r2s = jnp.asarray(src["ref_to_src"])

    def xform_m(i):
        return (r2s[:, i, 0][:, None, None] * mx
                + r2s[:, i, 1][:, None, None] * my
                + r2s[:, i, 2][:, None, None] * mz
                + r2s[:, i, 3][:, None, None])

    qmx, qmy, qmz = xform_m(0), xform_m(1), xform_m(2)
    inv_zm = 1.0 / (qmz + jep.EPS)
    pum = qmx * jnp.float32(fx) * inv_zm + jnp.float32(cx)
    pvm = qmy * jnp.float32(fy) * inv_zm + jnp.float32(cy)
    inbm = (pum >= 0.0) & (pum <= W - 1.0) & (pvm >= 0.0) & (pvm <= Hs - 1.0)
    wdepth = jnp.stack([jep.bilinear_sample_packed(
        jep.pack_bilinear_corners(jnp.asarray(src["depths"][s])), Hs, Ws,
        pum[s], pvm[s])[..., 0] for s in range(S)])
    wdepth = jnp.where(inbm, wdepth, 0.0)
    depth_err = jnp.abs(wdepth - qmz) * inv_zm

    t = _torch_warp_args(src, pdx, pdy)
    d, w = _buffers(bd, bw, requires_grad=True)
    out = _warp_call(tep.warp_views, d, w, t, intr)
    assert not out[2].requires_grad and not out[3].requires_grad
    _close(out[2].detach(), wdepth, "wdepth")
    _close(out[3].detach(), depth_err, "depth_err")
    inb = np.asarray(inbm)
    assert inb.any() and (np.asarray(wdepth)[inb] > 0).all()
    if src_hw is not None:
        assert not inb.all()          # some median points fall outside


def test_nan_source_texel_packs_as_jax():
    """A NaN source texel packs to 0 in both packages (the JAX package's
    rgb10 rule): both `ibr_epilogue`s give the same finite warped colours
    and every other output as the other package does."""
    bl, src = _f32(_blend(0)), _f32(_sources(10))
    src["images"][:, 8:24, 12:36, 1] = np.nan
    jc = simple_camera(W, H)
    tc = look_at_camera([0.0, 0.0, -3.0], [0.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                        0.8, 0.8, W, H, device="cpu")
    jout = jax.jit(jep.ibr_epilogue)(
        JBlendOutputs(**{k: jnp.asarray(v) for k, v in bl.items()}), jc,
        jep.SourceViews(count=jnp.int32(3),
                        **{k: jnp.asarray(v) for k, v in src.items()}))
    tout = tep.ibr_epilogue(
        BlendOutputs(**{k: torch.as_tensor(v) for k, v in bl.items()}), tc,
        tep.SourceViews(count=3,
                        **{k: torch.as_tensor(v) for k, v in src.items()}))
    assert bool(torch.isfinite(tout.warped_image).all())
    for f in dataclasses.fields(tep.IBROutputs):
        _close(getattr(tout, f.name), getattr(jout, f.name), f.name)


def test_warp_kernel_wrappers_refuse_cpu_tensors(monkeypatch):
    """warp_fwd_cuda / warp_bwd_cuda / rgb10_pack_cuda check their inputs
    and raise ValueError on CPU tensors (and on bad shapes or dtypes)
    before any build or launch."""
    from ibgs_tpu_torch.ops import _cuda

    def no_build(*a, **k):
        raise AssertionError("the kernel was built or loaded")
    monkeypatch.setattr(_cuda, "load", no_build)
    monkeypatch.setattr(_cuda, "build", no_build)
    bd, bw, src, pdx, pdy, intr, cts = _warp_inputs(0)
    t = _torch_warp_args(src, pdx, pdy)
    d, w = _buffers(bd, bw)
    args = (d.permute(2, 0, 1), w.permute(2, 0, 1), t["tables"], t["r2s"],
            t["pdx"], t["pdy"])
    occ = (t["median"], t["depths"])
    g = tuple(torch.as_tensor(c) for c in cts)
    with pytest.raises(ValueError, match="CUDA device"):
        tep.warp_fwd_cuda(*args, *occ, *intr)
    with pytest.raises(ValueError, match="CUDA device"):
        tep.warp_bwd_cuda(*args, intr, *g)
    with pytest.raises(ValueError, match="CUDA device"):
        tep.rgb10_pack_cuda(torch.as_tensor(src["images"]))
    with pytest.raises(ValueError):
        tep.rgb10_pack_cuda(torch.as_tensor(src["images"]).double())
    bad = {"double bw": (args[0], args[1].double()) + args[2:],
           "short pdx": args[:4] + (args[4][:-1],) + args[5:],
           "r2s of another S": args[:3] + (args[3][:-1],) + args[4:],
           "float tables": args[:2] + (args[2].float(),) + args[3:],
           "word tables": args[:2]
           + (tep.pack_rgb10(torch.as_tensor(src["images"])),) + args[3:]}
    for name, a in bad.items():
        with pytest.raises(ValueError):
            tep.warp_fwd_cuda(*a, *occ, *intr)
        with pytest.raises(ValueError):
            tep.warp_bwd_cuda(*a, intr, *g)
    with pytest.raises(ValueError, match="depths"):
        tep.warp_fwd_cuda(*args, occ[0], occ[1][:, :-1], *intr)
    with pytest.raises(ValueError, match="g_wsum"):
        tep.warp_bwd_cuda(*args, intr, g[0], g[1][:, :-1])


def test_cpu_warp_launches_no_kernel():
    """A CPU pack, warp forward and backward go through the plain versions
    and leave the kernels' launch counts at zero."""
    bd, bw, src, pdx, pdy, intr, cts = _warp_inputs(1)
    t = _torch_warp_args(src, pdx, pdy)
    t["tables"] = tep.rgb10_tables(torch.as_tensor(src["images"]))
    d, w = _buffers(bd, bw, requires_grad=True)
    out = _warp_call(tep.warp_views, d, w, t, intr)
    torch.autograd.grad((out[0].sum() + out[1].sum()), [d, w])
    assert {k: _cuda.LAUNCHES[k] for k in ("rgb10_pack", "warp_fwd",
                                           "warp_bwd")} == \
        {"rgb10_pack": 0, "warp_fwd": 0, "warp_bwd": 0}
    want = _warp_call(tep.warp_views_plain, *_buffers(bd, bw), t, intr)
    for a, b in zip(out, want):
        assert torch.equal(a.detach(), b)


def test_warp_kernel_is_built_and_bound():
    """The warp source is among the sources `_cuda.build` compiles, and
    each C entry's ctypes signature has as many arguments as the C
    declaration in csrc/warp.cu."""
    import re

    from ibgs_tpu_torch.ops import _cuda
    assert _cuda.SOURCES["warp"].name == "warp.cu"
    text = _cuda.SOURCES["warp"].read_text()
    for fn in ("ibgs_rgb10_pack", "ibgs_warp_fwd", "ibgs_warp_bwd",
               "ibgs_warp_info"):
        assert fn in _cuda._SIGNATURES
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert m, fn
        assert len(m.group(1).split(",")) == len(_cuda._SIGNATURES[fn][0])
    assert 'extern "C" const char* ibgs_cuda_error_string' in text


def test_epilogue_gradient_stops_match_jax():
    """A loss over every float field of IBROutputs: its gradient w.r.t. the
    buffer depths and weights flows only where the JAX package's does."""
    bl, src = _f32(_blend(0)), _f32(_sources(10))
    r = np.random.default_rng(30)
    weights = {k: r.normal(size=s).astype(np.float32) for k, s in (
        ("median_depth", (H, W)), ("camera_ray", (H, W, 3)),
        ("warped_image", (S, H, W, 3)), ("cam_feat", (S, H, W, 4)),
        ("min_depth_diff", (H, W)), ("valid_src_weight", (S, H, W)))}
    jc = simple_camera(W, H)
    tc = look_at_camera([0.0, 0.0, -3.0], [0.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                        0.8, 0.8, W, H, device="cpu")

    def jloss(bd, bw):
        b = JBlendOutputs(**{k: jnp.asarray(v) for k, v in bl.items()})
        out = jep.ibr_epilogue(b.replace(buf_depth=bd, buf_weight=bw), jc,
                               jep.SourceViews(count=jnp.int32(3), **{
                                   k: jnp.asarray(v) for k, v in src.items()}))
        return sum((getattr(out, k) * w).sum() for k, w in weights.items())

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(bl["buf_depth"]),
                                           jnp.asarray(bl["buf_weight"]))
    bd = torch.as_tensor(bl["buf_depth"]).requires_grad_(True)
    bw = torch.as_tensor(bl["buf_weight"]).requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in bl.items()}
    tb.update(buf_depth=bd, buf_weight=bw)
    out = tep.ibr_epilogue(BlendOutputs(**tb), tc, tep.SourceViews(
        count=3, **{k: torch.as_tensor(v) for k, v in src.items()}))
    loss = sum((getattr(out, k) * torch.as_tensor(w)).sum()
               for k, w in weights.items())
    got = torch.autograd.grad(loss, [bd, bw])
    for name, g, w in zip(("buf_depth", "buf_weight"), got, want):
        _close_grad(g.numpy(), w, name, atol=1e-4)
