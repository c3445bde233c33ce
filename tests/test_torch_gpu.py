"""The port on the card: its CUDA kernels against their plain PyTorch
versions, their launches on every path, and the paths and drivers that
only a card runs.  The one suite of on-card checks; marked `gpu`, each
test skips without a CUDA device.  It imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Forward tolerance: floats 1e-5 abs + 1e-5 rel, integers exact (the
kernels are built without multiply-add contraction), on the bundle's real
instances on all but 1e-4 of the pixels.  Backward, per gradient column:
max abs error <= 1e-4 x the plain column's max + 1e-7 (the sums over a
tile's pixels run in another order); repeats bit-identical.

The blend kernels on random, skewed (a 4,500-instance tile beside empty
ones) and mid-batch tiles.  The warp kernels (`-k warp`): the pack, the
occlusion outputs and the backward bit for bit, the colour sums at the
forward tolerance, on B = 1-12 entries, S = 1 and 5 sources, NaN, out of
bounds, bands and padded rows.  The projection kernels (`-k preprocess`)
on tests/torch_preprocess_cases.py, the backward within 2x the float32
plain version's error against float64.  The binning kernels (`-k bin`)
and the SSIM kernels (`-k ssim`) bit for bit.  The Tanks and Temples
frame (`-k tnt`, 960x540, its last tile row 12/16 live).  The optimizer's
kernel (`-k optim`) bit for bit at the bundle's, the 1M and the Tanks and
Temples capacities, with dead slots and planted NaN and infinities, and
three bundle train steps through it against the plain chain.

On the bundle (tests/torch_bundle_inputs.py, the kernel table's inputs in
chip_smoke.py): every kernel on the real instances and the cotangents of a
real backward of the training objective at 960x544 and 1920x1088, and on
the random 1M scene; exact launch counts of each of the 15 kernels per
served view and per train step (`_cuda.LAUNCHES`); row bands; the
Gaussian-sharded step at world size 1; the 300-iteration loop with its
resume, the evaluation path on its model, the CLI with `--gsp_shards 1`,
the production run at 1M seeds, the suite runner, and the measurement
drivers (bench, the probes, parse_trace).
"""
import contextlib
import dataclasses
import json
import math
import os
import zlib

import numpy as np
import pytest
import torch

from ibgs_tpu_torch.ops import _cuda as cu
from ibgs_tpu_torch.ops import blend, epilogue
from ibgs_tpu_torch.ops import preprocess as pre
from ibgs_tpu_torch.ops.blend_common import BlendConfig
import torch_binning_cases as bcases
import torch_bundle_inputs as tbi
import torch_preprocess_cases as pcases

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the kernels every render or backward launches, counted on every path
MAIN = ("blend_fwd", "blend_bwd", "rgb10_pack", "warp_fwd", "warp_bwd",
        "preprocess_fwd", "preprocess_bwd")


def _of(launched, names=MAIN):
    return {k: launched[k] for k in names if launched.get(k)}


def _table(r, mx, my, sx, sy, rho, op):
    """(n, 13) float32 instance table of splats with means (mx, my),
    standard deviations (sx, sy), correlation rho and opacity op; random
    colours, camera-facing plane normals and plane offsets."""
    n = len(mx)
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    conic = np.stack([sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det], 1)
    nrm = r.normal(size=(n, 3))
    nrm[:, 2] = np.abs(nrm[:, 2]) + 0.5
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    feats = np.concatenate(
        [mx[:, None], my[:, None], conic, op[:, None],
         r.uniform(0, 1, (n, 3)), nrm, -r.uniform(1, 5, (n, 1))], 1)
    return feats.astype(np.float32)


def _instances_for_counts(r, counts, tiles_x, tile_h, tile_w, op_range):
    """A random instance table with counts[t] rows for tile t, splats
    centred in their own tile, and the int32 tile ranges."""
    counts = np.asarray(counts)
    stop = np.cumsum(counts).astype(np.int32)
    start = (stop - counts).astype(np.int32)
    n = int(stop[-1])
    tile = np.repeat(np.arange(len(counts)), counts)
    mx = (tile % tiles_x) * tile_w + r.uniform(-4, tile_w + 4, n)
    my = (tile // tiles_x) * tile_h + r.uniform(-4, tile_h + 4, n)
    feats = _table(r, mx, my, r.uniform(0.5, 6, n), r.uniform(0.5, 6, n),
                   r.uniform(-0.8, 0.8, n), r.uniform(*op_range, n))
    return feats, start, stop


def _random_instances(seed, tiles_x, tiles_y, tile_h, tile_w, per_tile):
    r = np.random.default_rng(seed)
    return _instances_for_counts(r, r.integers(0, per_tile, tiles_x * tiles_y),
                                 tiles_x, tile_h, tile_w, (0.05, 0.99))


# One tile of 4,500 faint instances (pixels walk thousands of them) beside
# empty and short tiles; and ranges that end one past, one short of and
# inside the forward's 128- and the backward's 64-instance batches.
SKEWED = [0, 4500, 3, 0, 17, 1]
MID_BATCH = [129, 65, 63, 1, 0, 191]


def _blend_args(feats, start, stop, tiles_x, tiles_y, cfg, dev):
    return (torch.as_tensor(feats, device=dev),
            torch.as_tensor(start, device=dev),
            torch.as_tensor(stop, device=dev), tiles_x * cfg.tile_w,
            tiles_y * cfg.tile_h, 300.0, 310.0, 80.0, 24.0, cfg, 16.0)


def _blend_cts(Hp, Wp, B, seed, dev):
    """Seeded cotangents of the five blend outputs a backward reads."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn(s, generator=g).to(dev) for s in
                 [(Hp, Wp, 3), (Hp, Wp, 3), (Hp, Wp), (Hp, Wp, B),
                  (Hp, Wp, B)])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("B", [4, 1, 8])
def test_kernel_matches_plain(mode, B):
    dev = _cuda()
    tiles_x, tiles_y, th, tw = 5, 3, 16, 32
    feats, start, stop = _random_instances(mode * 10 + B, tiles_x, tiles_y,
                                           th, tw, 700)
    cfg = BlendConfig(tile_h=th, tile_w=tw, buffer_len=B,
                      render_geo=mode == 1, depth_only=mode == 2)
    args = _blend_args(feats, start, stop, tiles_x, tiles_y, cfg, dev)
    got, launched = tbi.launched(lambda: blend.blend_fwd_cuda(*args))
    assert launched == {"blend_fwd": 1}
    tbi.assert_fwd_matches(got, blend.blend_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("B", [4, 1, 8])
@pytest.mark.parametrize("counts", [SKEWED, MID_BATCH],
                         ids=["skewed", "mid_batch"])
def test_kernel_matches_plain_skewed_and_mid_batch(mode, B, counts):
    """Integer outputs exact and floats within tolerance on a skewed tile
    set and on ranges that end inside a batch; two runs bit-identical."""
    dev = _cuda()
    r = np.random.default_rng(100 + 10 * mode + B)
    feats, start, stop = _instances_for_counts(r, counts, 3, 16, 32,
                                               (0.003, 0.03))
    cfg = BlendConfig(tile_h=16, tile_w=32, buffer_len=B,
                      render_geo=mode == 1, depth_only=mode == 2)
    args = _blend_args(feats, start, stop, 3, 2, cfg, dev)
    got = blend.blend_fwd_cuda(*args)
    again = blend.blend_fwd_cuda(*args)
    torch.cuda.synchronize()
    tbi.assert_fwd_matches(got, blend.blend_plain(*args))
    for f in tbi.FIELDS:
        assert torch.equal(getattr(got, f), getattr(again, f)), f
    if counts is SKEWED and mode != 2:
        # the long tile's pixels walk far into its range
        assert int(got.n_contrib.max()) > 1000


@pytest.mark.gpu
def test_kernel_empty_and_bad_inputs():
    dev = _cuda()
    cfg = BlendConfig(tile_h=16, tile_w=32, buffer_len=4)
    z = torch.zeros(2, dtype=torch.int32, device=dev)
    out = blend.blend_fwd_cuda(torch.zeros(0, 13, device=dev), z, z, 64, 16,
                               10.0, 10.0, 32.0, 8.0, cfg)
    torch.cuda.synchronize()
    assert bool((out.final_t == 1).all()) and bool((out.color == 0).all())
    with pytest.raises(ValueError):
        blend.blend_fwd_cuda(torch.zeros(4, 13, device=dev), z.long(), z,
                             64, 16, 10.0, 10.0, 32.0, 8.0, cfg)
    with pytest.raises(ValueError):
        blend.blend_fwd_cuda(torch.zeros(4, 13), z.cpu(), z.cpu(), 64, 16,
                             10.0, 10.0, 32.0, 8.0, cfg)


@dataclasses.dataclass
class _Bins:
    tile_start: torch.Tensor
    tile_stop: torch.Tensor


def _bwd_inputs(mode, B, seed, dev):
    tiles_x, tiles_y, th, tw = 5, 3, 16, 32
    feats, start, stop = _random_instances(seed, tiles_x, tiles_y, th, tw,
                                           700)
    feats = np.concatenate([feats, np.zeros((feats.shape[0], 2),
                                            np.float32)], 1)
    cfg = BlendConfig(tile_h=th, tile_w=tw, buffer_len=B,
                      render_geo=mode == 1)
    Wp, Hp = tiles_x * tw, tiles_y * th
    args = (torch.as_tensor(feats, device=dev),
            torch.as_tensor(start, device=dev),
            torch.as_tensor(stop, device=dev), Wp, Hp, 300.0, 310.0, 80.0,
            24.0, cfg)
    return args, blend.blend_fwd_cuda(*args, 16.0), _blend_cts(Hp, Wp, B,
                                                               seed, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("B", [4, 1, 8])
def test_bwd_kernel_matches_plain(mode, B):
    dev = _cuda()
    args, saved, cts = _bwd_inputs(mode, B, 7 + mode * 10 + B, dev)
    (got, again), launched = tbi.launched(lambda: [
        blend.blend_bwd_cuda(*args, saved, cts, 16.0) for _ in range(2)])
    assert launched == {"blend_bwd": 2}
    want = blend.blend_bwd_plain(*args, saved, cts, 16.0)
    tbi.assert_columns_close(got, want)
    assert torch.equal(got, again)
    geo_cols = float(got[:, 9:13].abs().max())
    assert geo_cols > 0 if mode == 1 else geo_cols == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("counts", [SKEWED, MID_BATCH],
                         ids=["skewed", "mid_batch"])
def test_bwd_kernel_matches_plain_skewed_and_mid_batch(mode, counts):
    dev = _cuda()
    r = np.random.default_rng(200 + mode)
    feats, start, stop = _instances_for_counts(r, counts, 3, 16, 32,
                                               (0.003, 0.03))
    cfg = BlendConfig(tile_h=16, tile_w=32, buffer_len=4,
                      render_geo=mode == 1)
    args = _blend_args(feats, start, stop, 3, 2, cfg, dev)
    saved = blend.blend_fwd_cuda(*args)
    cts = _blend_cts(32, 96, 4, mode, dev)
    got = blend.blend_bwd_cuda(*args[:-1], saved, cts, 16.0)
    again = blend.blend_bwd_cuda(*args[:-1], saved, cts, 16.0)
    torch.cuda.synchronize()
    tbi.assert_columns_close(got,
                             blend.blend_bwd_plain(*args[:-1], saved, cts,
                                                   16.0))
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1])
def test_bwd_kernel_warps_stop_at_different_positions(mode):
    """In one 16x32 tile, the top-left 4x8 pixel block sees only the
    instance at position 1, while the right half walks 300 faint instances
    to the tile's end: the warps' walks (and the two sub-tile CTAs') end
    at 1 and at about 301."""
    dev = _cuda()
    r = np.random.default_rng(5 + mode)
    n_far = 300
    one = np.ones(1)
    feats = _table(
        r, np.concatenate([3.5 * one, r.uniform(24, 31, n_far)]),
        np.concatenate([1.5 * one, r.uniform(0, 15, n_far)]),
        np.concatenate([one, r.uniform(0.5, 3, n_far)]),
        np.concatenate([one, r.uniform(0.5, 3, n_far)]),
        np.concatenate([0 * one, r.uniform(-0.5, 0.5, n_far)]),
        np.concatenate([0.9 * one, r.uniform(0.01, 0.05, n_far)]))
    start = np.array([0, n_far + 1], np.int32)
    stop = np.array([n_far + 1, n_far + 1], np.int32)
    cfg = BlendConfig(tile_h=16, tile_w=32, buffer_len=4,
                      render_geo=mode == 1)
    args = (torch.as_tensor(feats, device=dev),
            torch.as_tensor(start, device=dev),
            torch.as_tensor(stop, device=dev), 64, 16, 300.0, 310.0, 32.0,
            8.0, cfg)
    saved = blend.blend_fwd_cuda(*args)
    nc = saved.n_contrib
    assert int(nc[0:4, 0:8].max()) == 1 and int(nc[:, 16:32].max()) > 250
    cts = _blend_cts(16, 64, 4, 11, dev)
    got = blend.blend_bwd_cuda(*args, saved, cts)
    again = blend.blend_bwd_cuda(*args, saved, cts)
    torch.cuda.synchronize()
    tbi.assert_columns_close(got, blend.blend_bwd_plain(*args, saved, cts))
    assert torch.equal(got, again)
    assert float(got[0].abs().max()) > 0


@pytest.mark.gpu
def test_occupancy_query():
    """The kernels' occupancy entries answer for the main path's CTA."""
    _cuda()
    for name, modes, limit in (("blend_fwd", (0, 1, 2), blend.FWD_CTA),
                               ("blend_bwd", (0, 1), blend.BWD_CTA)):
        sy, sx = blend.sub_tile_split(16, 32, limit)
        for mode in modes:
            blocks, threads = cu.occupancy(name, mode, 4, 16 // sy, 32 // sx)
            assert blocks >= 1 and threads == limit


@pytest.mark.gpu
def test_autograd_function_launches_both_kernels():
    dev = _cuda()
    args, saved, cts = _bwd_inputs(1, 4, 3, dev)
    f = args[0].clone().requires_grad_(True)

    def call():
        out = blend.blend_packed(f, _Bins(args[1], args[2]), *args[3:],
                                 row0=16.0)
        loss = (out.color * cts[0]).sum() + (out.buf_depth * cts[3]).sum()
        return torch.autograd.grad(loss, f)
    (g,), launched = tbi.launched(call)
    assert launched == {"blend_fwd": 1, "blend_bwd": 1}
    assert g.shape == f.shape and bool(torch.isfinite(g).all())


@pytest.mark.gpu
def test_bwd_kernel_empty_and_bad_inputs():
    dev = _cuda()
    cfg = BlendConfig(tile_h=16, tile_w=32, buffer_len=4)
    z = torch.zeros(2, dtype=torch.int32, device=dev)
    saved = blend.blend_fwd_cuda(torch.zeros(0, 13, device=dev), z, z, 64,
                                 16, 10.0, 10.0, 32.0, 8.0, cfg)
    cts = (torch.ones(16, 64, 3, device=dev), torch.ones(16, 64, 3,
                                                         device=dev),
           torch.ones(16, 64, device=dev), torch.ones(16, 64, 4, device=dev),
           torch.ones(16, 64, 4, device=dev))
    out = blend.blend_bwd_cuda(torch.zeros(0, 13, device=dev), z, z, 64, 16,
                               10.0, 10.0, 32.0, 8.0, cfg, saved, cts)
    torch.cuda.synchronize()
    assert out.shape == (0, 16)
    with pytest.raises(ValueError):        # wrong cotangent shape
        blend.blend_bwd_cuda(torch.zeros(4, 13, device=dev), z, z, 64, 16,
                             10.0, 10.0, 32.0, 8.0, cfg, saved,
                             cts[:4] + (torch.ones(16, 64, 3, device=dev),))
    with pytest.raises(ValueError):        # depth_only has no backward
        blend.blend_bwd_cuda(torch.zeros(4, 13, device=dev), z, z, 64, 16,
                             10.0, 10.0, 32.0, 8.0,
                             BlendConfig(16, 32, 4, False, True), saved, cts)
    with pytest.raises(ValueError):        # CPU tensors
        blend.blend_bwd_cuda(torch.zeros(4, 13), z.cpu(), z.cpu(), 64, 16,
                             10.0, 10.0, 32.0, 8.0, cfg, saved, cts)


# ---------------------------------------------------------------- the warp

# (B, S, source size) and the special cases: all-zero weights, projections
# wholly out of bounds, NaN source texels, a NaN buffer depth and source
# depth, a band at row0 272, buffers whose rows are padded (a crop)
WARP_CASES = [(b, s_, src) for b in (1, 3, 4, 8, 12) for s_ in (1, 5)
              for src in ("smaller", "larger")] + [
    (4, 5, "zero_weights"), (4, 5, "out_of_bounds"), (4, 5, "nan_texel"),
    (4, 5, "nan_depth"), (4, 5, "row0_272"), (4, 5, "padded_rows"),
    (3, 5, "padded_rows")]


def _warp_inputs(B, S, case, dev, H=48, W=80):
    """Seeded warp inputs on `dev`: ((bd, bw, tables, r2s, pdx, pdy,
    median, depths), the intrinsics, the two cotangents, the float source
    images), with bd and bw the (B, H, W) permuted views of (H, W, B)
    buffers, as the epilogue passes them, and tables their images'
    `pack_rgb10_rows` footprint rows."""
    r = np.random.default_rng(zlib.crc32(f"{B} {S} {case}".encode()))
    row0, img_h = (272, 544) if case == "row0_272" else (0, H)
    fx = fy = 60.0
    cx, cy = W / 2.0, img_h / 2.0
    Hs, Ws = {"smaller": (H // 2 + 3, W // 2 + 5),
              "larger": (2 * H + 1, 2 * W + 3)}.get(case, (img_h, W))
    Wp = W + 7 if case == "padded_rows" else W
    used = r.uniform(size=(H, Wp, B)) < 0.7
    bw = np.where(used, r.uniform(0.01, 0.5, (H, Wp, B)), 0.0)
    if case == "zero_weights":
        bw[:] = 0.0
    bd = np.where(used, 3.0 + r.normal(size=(H, Wp, B)) * 0.03, 0.0)
    images = r.uniform(-0.1, 1.1, (S, Hs, Ws, 3))
    depths = 3.0 + r.normal(size=(S, Hs, Ws)) * 0.03
    depths[:, ::7, ::5] = 0.0                 # holes in the depth maps
    if case == "nan_texel":
        images[:, H // 4:H // 2, W // 4:W // 2, 1] = np.nan
    if case == "nan_depth":
        bd[H // 2, W // 2, 0] = np.nan
        depths[0, H // 3, W // 3] = np.nan
    r2s = np.tile(np.eye(4), (S, 1, 1))
    for s_ in range(S):
        a = r.normal(size=3) * 0.02            # a small rotation
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        r2s[s_, :3, :3] += k
        r2s[s_, :3, 3] = r.normal(size=3) * [0.05, 0.05, 0.01]
    if case == "out_of_bounds":
        r2s[:, 0, 3] = 100.0
    gx, gy = np.meshgrid(np.arange(W), np.arange(H) + row0)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    buf_d, buf_w = f32(bd)[:, :W], f32(bw)[:, :W]
    median = ((buf_w * buf_d).sum(-1)
              / ((buf_w * (buf_w != 0)).sum(-1) + epilogue.EPS))
    img = f32(images)
    args = (buf_d.permute(2, 0, 1), buf_w.permute(2, 0, 1),
            epilogue.pack_rgb10_rows(img), f32(r2s), f32((gx - cx) / fx),
            f32((gy - cy) / fy), median.contiguous(), f32(depths))
    cts = (f32(r.normal(size=(S, H, W, 3))), f32(r.normal(size=(S, H, W))))
    return args, (fx, fy, cx, cy), cts, img


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,case", WARP_CASES)
def test_warp_kernels_match_plain(B, S, case):
    """rgb10_pack_cuda equals pack_rgb10_rows; warp_fwd_cuda's colour sums
    against warp_views_plain's (1e-5 abs + 1e-5 rel: the B-sum's order
    differs), its wdepth and depth_err bit for bit (the `valid` mask equal);
    warp_bwd_cuda equals warp_views_bwd_plain bit for bit, NaN in the same
    places; two backward runs bit-identical."""
    _check_warp(B, S, case, _cuda())


def _check_warp(B, S, case, dev, H=48, W=80):
    """test_warp_kernels_match_plain's comparisons on `_warp_inputs`."""
    args, intr, cts, images = _warp_inputs(B, S, case, dev, H, W)
    k_fwd, k1 = tbi.assert_warp_pair(args, intr, cts, images)
    nan = [bool(torch.isnan(t).any()) for t in (*k_fwd, *k1)]
    assert any(nan) == (case == "nan_depth")
    if case == "zero_weights":
        assert not bool(k_fwd[0].any()) and not bool(k_fwd[1].any())
    if case == "out_of_bounds":
        assert not bool(k_fwd[1].any()) and not bool(k1[1].any())
        assert not bool(k_fwd[2].any())


@pytest.mark.gpu
def test_warp_function_launches_each_kernel_once():
    """One pack and one `warp_views` forward and backward on the card
    launch each warp kernel exactly once, and each wrapper makes exactly
    one device launch (no layout copy), with the plain versions'
    results."""
    dev = _cuda()
    from ibgs_tpu_torch.utils import profiling
    args, intr, cts, images = _warp_inputs(4, 5, "larger", dev)
    d = args[0].detach().requires_grad_(True)
    w = args[1].detach().requires_grad_(True)

    def call():
        tables = epilogue.rgb10_tables(images)
        wsc, ws, _, _ = epilogue.warp_views(d, w, tables, *args[3:], *intr)
        return wsc, ws, *torch.autograd.grad(
            (wsc * cts[0]).sum() + (ws * cts[1]).sum(), [d, w])
    (wsc, ws, gd, gw), launched = tbi.launched(call)
    assert launched == {"rgb10_pack": 1, "warp_fwd": 1, "warp_bwd": 1}
    for k, p in zip((wsc, ws), epilogue.warp_views_plain(*args, *intr)):
        tbi.assert_warp_close(k, p, 1e-5, 1e-5, per_column=False)
    for k, p in zip((gd, gw),
                    epilogue.warp_views_bwd_plain(*args[:6], intr, *cts)):
        assert tbi.same_bits(k, p)
    for fn in (lambda: epilogue.rgb10_pack_cuda(images),
               lambda: epilogue.warp_fwd_cuda(*args, *intr),
               lambda: epilogue.warp_bwd_cuda(*args[:6], intr, *cts)):
        prof = profiling.device_time(fn, dev)
        assert prof.get("device_launches") == 1, prof


@pytest.mark.gpu
def test_warp_kernels_refuse_bad_inputs():
    """The wrappers raise ValueError on what the kernels do not take
    (among it buffers that are not (B, H, W) views of (H, W, B) ones) and
    count no launch."""
    dev = _cuda()
    args, intr, cts, images = _warp_inputs(4, 5, "larger", dev)
    before = dict(cu.LAUNCHES)
    bad = [(args[0].double(),) + args[1:],
           (args[0].contiguous(), args[1].contiguous()) + args[2:],
           (args[0], args[1].contiguous()) + args[2:],
           args[:2] + (args[2].cpu(),) + args[3:],
           args[:2] + (args[2].float(),) + args[3:],
           args[:2] + (epilogue.pack_rgb10(images),) + args[3:],
           args[:3] + (args[3][:2],) + args[4:],
           args[:4] + (args[4][:, :-1],) + args[5:]]
    for a in bad:
        with pytest.raises(ValueError):
            epilogue.warp_fwd_cuda(*a, *intr)
        with pytest.raises(ValueError):
            epilogue.warp_bwd_cuda(*a[:6], intr, *cts)
    for a in (args[:6] + (args[6].t().contiguous().t(),) + args[7:],
              args[:7] + (args[7][:, :, :-1],)):
        with pytest.raises(ValueError):
            epilogue.warp_fwd_cuda(*a, *intr)
    with pytest.raises(ValueError):
        epilogue.warp_bwd_cuda(*args[:6], intr, cts[0][:, 1:], cts[1])
    for im in (images.double(), images[..., :2], images.transpose(1, 2)):
        with pytest.raises(ValueError):
            epilogue.rgb10_pack_cuda(im)
    assert cu.LAUNCHES == before


# ------------------------------------------- the projection (preprocess)

PRE_CASES = list(pcases.CASES) + list(pcases.ZERO_Z)


def _pre_inputs(case, dev, n=400):
    """The seeded inputs of `case` on `dev`: (preprocess's positional
    arguments, alive, the cotangent table, the active degree, whether the
    colour is an override)."""
    deg, active, override, _, _ = {**pcases.CASES, **pcases.ZERO_Z}[case]
    f, table = pcases.inputs(case, n)
    t = {k: torch.as_tensor(v).to(dev) for k, v in f.items()}
    args = (t["xyz"], t["scale"], t["quat"], t["opacity"],
            None if override else t["sh"], active, t["normal"], t["offset"],
            pcases.camera(dev), *pcases.TILE)
    return args, t["alive"], torch.as_tensor(table).to(dev), t["rgb"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PRE_CASES + ["deg2_many"])
def test_preprocess_kernels_match_plain(case):
    """preprocess_fwd_cuda against preprocess_plain: integer fields equal,
    float fields within 1e-5 abs + 1e-5 rel (NaN in the same places);
    preprocess_bwd_cuda, on the strided cotangents of rasterize's table,
    against autograd of the plain version by tbi.assert_pre_bwd_pair; two
    backward runs bit-identical.  `deg2_many` takes 200,003 splats (a
    ragged last CTA)."""
    dev = _cuda()
    n = 200_003 if case == "deg2_many" else 400
    args, alive, table, rgb = _pre_inputs(
        "deg2_active1" if case == "deg2_many" else case, dev, n)
    override = args[4] is None
    k = pre.preprocess_fwd_cuda(*args, alive)
    p = pre.preprocess_plain(
        *args, alive=alive,
        rgb_override=rgb[:, :0] if override else None)
    names = ("mean2d", "depth", "conic", "rgb", "plane_normal",
             "plane_dist", "radius", "rect_min", "rect_max", "n_tiles")
    for name, a in zip(names, k):
        b = getattr(p, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == torch.int32:
            assert torch.equal(a, b), name
        else:
            assert torch.equal(torch.isnan(a), torch.isnan(b)), name
            fin = ~torch.isnan(b)
            assert bool(((a - b).abs()[fin]
                         <= 1e-5 + 1e-5 * b.abs()[fin]).all()), name
    if case == "band":
        from ibgs_tpu_torch.ops.rasterize import _band
        sp_k = dataclasses.replace(p, **dict(zip(names, k)))
        tiles_y = -(-pcases.BAND_ROWS // pcases.TILE[0])
        for a, b in ((_band(sp_k, pcases.BAND_ROW0, tiles_y, pcases.TILE[0]),
                      _band(p, pcases.BAND_ROW0, tiles_y, pcases.TILE[0])),):
            for name in names[6:]:
                assert torch.equal(getattr(a, name), getattr(b, name))
    k1 = tbi.assert_pre_bwd_pair(tbi.pre_bwd_args(args),
                                 pcases.cotangents(table, not override))
    nonfinite = any(not bool(torch.isfinite(g).all()) for g in k1
                    if g is not None)
    assert nonfinite == (case == "zero_z")


@pytest.mark.gpu
def test_preprocess_function_launches_each_kernel_once():
    """`preprocess` on CUDA tensors and autograd through it launch each
    preprocess kernel exactly once, each wrapper one device launch, with
    the plain version's outputs and gradients."""
    dev = _cuda()
    from ibgs_tpu_torch.utils import profiling
    args, alive, table, _ = _pre_inputs("deg3_active2", dev)
    leaves = [a.detach().requires_grad_(True) for a in
              (args[0], args[1], args[2], args[4], args[6], args[7])]
    full = (leaves[0], leaves[1], leaves[2], args[3], leaves[3], args[5],
            leaves[4], leaves[5], *args[8:])

    def call():
        sp = pre.preprocess(*full, alive=alive)
        tab = torch.cat([sp.mean2d, sp.conic, sp.opacity[:, None], sp.rgb,
                         sp.plane_normal, sp.plane_dist[:, None],
                         torch.zeros(len(table), 2, device=dev)], dim=1)
        return sp, torch.autograd.grad((tab * table).sum(), leaves)
    (sp, grads), launched = tbi.launched(call)
    assert launched == {"preprocess_fwd": 1, "preprocess_bwd": 1}
    assert sp.opacity is args[3]
    ref = pre.preprocess_plain(*args, alive=alive)
    assert torch.equal(sp.radius, ref.radius)
    bargs = tbi.pre_bwd_args(args)
    cts = pcases.cotangents(table)
    for g, k in zip(grads, pre.preprocess_bwd_cuda(*bargs, cts)):
        assert tbi.same_bits(g, k)
    for fn in (lambda: pre.preprocess_fwd_cuda(*args, alive),
               lambda: pre.preprocess_bwd_cuda(*bargs, cts)):
        prof = profiling.device_time(fn, dev)
        assert prof.get("device_launches") == 1, prof


@pytest.mark.gpu
def test_preprocess_kernels_refuse_bad_inputs():
    """The wrappers raise ValueError on what the kernels do not take and
    count no launch."""
    dev = _cuda()
    args, alive, table, _ = _pre_inputs("deg2_active1", dev)
    before = dict(cu.LAUNCHES)
    bad = [(args[0].double(),) + args[1:],
           (args[0].cpu(),) + args[1:],
           args[:2] + (args[2].t().contiguous().t(),) + args[3:],
           args[:4] + (args[4][:, :5].contiguous(),) + args[5:]]
    for a in bad:
        with pytest.raises(ValueError):
            pre.preprocess_fwd_cuda(*a, alive)
        with pytest.raises(ValueError):
            pre.preprocess_bwd_cuda(*tbi.pre_bwd_args(a),
                                    pcases.cotangents(table))
    with pytest.raises(ValueError):
        pre.preprocess_fwd_cuda(*args, alive.float())
    with pytest.raises(ValueError):
        pre.preprocess_bwd_cuda(*tbi.pre_bwd_args(args),
                                pcases.cotangents(table.double()))
    assert cu.LAUNCHES == before


# ---------------------------------------------- densify, KNN and the loop

def _densify_state(r, P=4096, n_alive=1500):
    """A model with random parameters, moments and statistics that clone,
    split (also through the absolute-gradient path) and prune."""
    from ibgs_tpu_torch.models import gaussians as tg

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    alive = np.zeros(P, bool)
    alive[r.choice(P, n_alive, replace=False)] = True
    big = r.uniform(size=P) < 0.4
    shapes = dict(xyz=(P, 3), sh_dc=(P, 1, 3), sh_rest=(P, 8, 3),
                  log_scale=(P, 3), quat=(P, 4), opacity_logit=(P, 1),
                  normal=(P, 3), offset=(P, 1))
    params = {k: r.normal(size=s) for k, s in shapes.items()}
    params["log_scale"] = np.where(big[:, None], r.uniform(-3, 0, (P, 3)),
                                   r.uniform(-9, -7, (P, 3)))
    denom = r.integers(0, 8, P)
    return tg.GaussianModel(
        params=tg.GaussianParams(**{k: t(v) for k, v in params.items()}),
        mu=tg.GaussianParams(**{k: t(np.abs(r.normal(size=s)))
                                for k, s in shapes.items()}),
        nu=tg.GaussianParams(**{k: t(np.abs(r.normal(size=s)))
                                for k, s in shapes.items()}),
        alive=torch.as_tensor(alive), active_sh_degree=2, max_sh_degree=2,
        step=3, denom=t(denom), denom_abs=t(denom),
        grad_accum=t(r.uniform(0, 6e-4, P) * denom),
        grad_accum_abs=t(r.uniform(0, 2e-3, P) * denom),
        max_radii2d=t(r.uniform(0, 60, P)))


def _to(model, dev):
    from ibgs_tpu_torch.models import gaussians as tg

    def tree(p):
        return tg.GaussianParams(**{k: getattr(p, k).to(dev)
                                    for k in tg.PARAM_FIELDS})
    return dataclasses.replace(
        model, params=tree(model.params), mu=tree(model.mu),
        nu=tree(model.nu), alive=model.alive.to(dev),
        **{k: getattr(model, k).to(dev) for k in tg.STAT_FIELDS})


@pytest.mark.gpu
def test_densify_and_prune_on_the_card_matches_the_cpu():
    """Slot for slot: the alive mask exactly, every float within 1e-6
    (the card's sampled positions round differently in the rotation)."""
    dev = _cuda()
    from ibgs_tpu_torch.models import gaussians as tg
    r = np.random.default_rng(7)
    model = _densify_state(r)
    noise = torch.as_tensor(r.normal(size=(3, 4096, 3)).astype(np.float32))
    cfg = tg.DensifyConfig(max_abs_split=40)
    for max_screen in (None, 20.0):
        want = tg.densify_and_prune(model, noise, cfg, 1.7, max_screen)
        got = tg.densify_and_prune(_to(model, dev), noise.to(dev), cfg, 1.7,
                                   max_screen)
        assert torch.equal(got.alive.cpu(), want.alive)
        assert int(want.alive.sum()) != int(model.alive.sum())
        for tree in ("params", "mu", "nu"):
            for k in tg.PARAM_FIELDS:
                np.testing.assert_allclose(
                    getattr(getattr(got, tree), k).cpu().numpy(),
                    getattr(getattr(want, tree), k).numpy(), rtol=1e-6,
                    atol=1e-6, err_msg=f"{tree}.{k}")
        for k in tg.STAT_FIELDS:
            assert not getattr(got, k).any()


@pytest.mark.gpu
def test_knn_on_the_card_matches_the_cpu():
    """Mean squared 3-NN distances within 4 float32 ulps of max |p|²
    (1.4e-6 here), with TF32 switched off at the call even when the caller
    allows it: TF32's 10-bit inputs would err by about 1e-3 |p|².  The
    log-scales are not compared at that level: the log turns the d²
    rounding of the closest pairs into up to 1e-4."""
    dev = _cuda()
    from ibgs_tpu_torch.core import knn
    pts = torch.as_tensor(np.random.default_rng(8).uniform(
        -1, 1, (5000, 3)).astype(np.float32))
    want = knn.mean_sq_dist_to_3nn(pts)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = knn.mean_sq_dist_to_3nn(pts.to(dev))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    atol = 4 * float(np.finfo(np.float32).eps) * float(
        (pts ** 2).sum(1).max())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=atol)
    assert bool(torch.isfinite(knn.initial_log_scales(pts.to(dev))).all())


@pytest.mark.gpu
def test_training_loop_on_the_card(tmp_path):
    """20 iterations of train() on the synthetic scene at 64x64 with two
    densify events: finite losses and exactly one launch of each kernel
    per iteration."""
    dev = _cuda()
    import json
    import math

    from ibgs_tpu_torch.config import (ModelParams, OptimizationParams,
                                       PipelineParams)
    from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
    from ibgs_tpu_torch.train import loop

    scene = make_synthetic_scene(n_views=6, width=64, height=64, n_gt=1200,
                                 n_seed=400, device=dev)
    opt = OptimizationParams(
        iterations=20, densify_from_iter=4, densification_interval=6,
        densify_until_iter=20, single_view_weight_from_iter=14,
        multi_view_weight_from_iter=14, start_color_aggregation_iter=12,
        number_src_frames=2)
    (state, stacks), launched = tbi.launched(lambda: loop.train(
        scene, ModelParams(), opt, PipelineParams(), str(tmp_path),
        save_iterations=(), test_iterations=(), log_every=1, quiet=True,
        device=dev))
    assert _of(launched, ("blend_fwd", "blend_bwd")) == \
        {"blend_fwd": 20, "blend_bwd": 20}
    with open(tmp_path / "train_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [m["iter"] for m in log] == list(range(1, 21))
    assert all(math.isfinite(m[k]) for m in log for k in loop.LOSS_KEYS)
    assert all(m["nonfinite_grads"] == 0 for m in log)
    assert state.model.alive.is_cuda and state.model.step == 20


def _sphere_views(n_views, W, H, radius, seed):
    """Ray-cast depth maps of a sphere at the origin from look-at cameras
    on a ring, with random colour images: [(depth, image, K, view)]."""
    from ibgs_tpu_torch.core.camera import look_at_camera
    r = np.random.default_rng(seed)
    out = []
    for k in range(n_views):
        a = 2 * np.pi * k / n_views
        cam = look_at_camera([1.2 * np.sin(a), 0.3, -3.0 + 0.5 * np.cos(a)],
                             [0, 0, 0], [0, -1, 0], 0.9, 0.7, W, H, "cpu")
        view = cam.view.numpy().astype(np.float64)
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
        d = np.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy,
                      np.ones_like(xs)], -1)
        c2w = np.linalg.inv(view)
        o, dw = c2w[:3, 3], d @ c2w[:3, :3].T
        a2, b, c = (dw ** 2).sum(-1), 2 * (dw @ o), o @ o - radius ** 2
        disc = b * b - 4 * a2 * c
        t = (-b - np.sqrt(np.clip(disc, 0, None))) / (2 * a2)
        K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                     np.float32)
        out.append((np.where(disc > 0, t, 0).astype(np.float32),
                    r.random((H, W, 3)).astype(np.float32), K,
                    view.astype(np.float32)))
    return out


@pytest.mark.gpu
def test_tsdf_on_the_card_matches_the_cpu(monkeypatch):
    """3 views of a sphere into a 67 x 67 x 67 grid, in chunks of 50,000
    voxels on the card and whole on the CPU: the weights equal and tsdf /
    colour within 1e-5 where the weight is positive, on all but 1e-4 of the
    voxels (a pixel index flipping at a rounding tie moves a voxel
    whole)."""
    dev = _cuda()
    from ibgs_tpu_torch.eval import tsdf
    from ibgs_tpu_torch.eval.tsdf import TSDFVolume
    lo, hi = np.array([-1.0, -1.0, -1.0]), np.array([1.0, 1.0, 1.0])
    card = TSDFVolume(lo, hi, voxel_size=0.03, device=dev)
    cpu = TSDFVolume(lo, hi, voxel_size=0.03, device="cpu")
    for depth, img, K, view in _sphere_views(3, 96, 72, 0.7, 3):
        cpu.integrate(depth, img, K, view)
        monkeypatch.setattr(tsdf, "CHUNK_VOXELS", 50_000)
        card.integrate(torch.as_tensor(depth).to(dev),
                       torch.as_tensor(img).to(dev), K, view)
        monkeypatch.undo()
    pos = cpu.weight > 0
    off = ((card.tsdf.cpu() - cpu.tsdf).abs() > 1e-5) \
        | ((card.color.cpu() - cpu.color).abs() > 1e-5).any(-1)
    off = (off & pos) | (card.weight.cpu() != cpu.weight)
    assert int(pos.sum()) > 1000
    assert int(off.sum()) <= 1e-4 * cpu.weight.numel()


@pytest.mark.gpu
def test_render_split_on_the_card(tmp_path):
    """`render_split` of the synthetic scene's test views on the card, FPS
    over 1 timed pass: 5 forward launches per view per pass (1 warm-up, 1
    timed, the PNG pass); the PNGs of renders, depth and normal within 1 of
    the CPU's on at most 0.1% of pixels (no fusion net: its bf16 matmuls
    round differently on the two devices)."""
    dev = _cuda()
    from ibgs_tpu_torch.config import OptimizationParams
    from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
    from ibgs_tpu_torch.eval.render_driver import EvalRenderer, render_split
    from ibgs_tpu_torch.models.gaussians import init_from_points
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    from ibgs_tpu_torch.utils import image_io

    opt = OptimizationParams(number_src_frames=4)
    pngs = {}
    for device in ("cpu", dev):
        scene = make_synthetic_scene(n_views=12, width=64, height=64,
                                     device=device)
        scene.test_nearest_ids = [[0, 1, 2, 3]] * len(scene.test_cameras)
        model = init_from_points(scene.points, scene.colors, 2,
                                 device=device)
        ev = EvalRenderer.from_scene(model, None, scene, opt, RasterConfig(),
                                     device)
        out = tmp_path / str(device)
        fps, launched = tbi.launched(lambda: render_split(
            ev, scene.test_cameras, scene.test_images,
            scene.test_nearest_ids, str(out), measure_fps=True, fps_loops=1))
        if device != "cpu":
            assert launched["blend_fwd"] == 3 * 5 * len(scene.test_cameras)
            assert fps > 0
        pngs[str(device)] = {
            p.relative_to(out): image_io.read_png(str(p)).astype(int)
            for p in out.rglob("*.png")}
    a, b = pngs["cpu"], pngs[str(dev)]
    assert sorted(a) == sorted(b) and len(a) == 4 * len(
        [p for p in a if p.parts[0] == "renders"])
    for k in a:
        diff = np.abs(a[k] - b[k])
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, k


def _synthetic_state(dev, W=64, H=128):
    """A train state on the synthetic scene's seed cloud (opacity 0.85,
    scale 0.06) with a seeded fusion net, its first camera and sources."""
    from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
    from ibgs_tpu_torch.models.aggregation import (ColorFusionResidualNet,
                                                   init_fusion_net)
    from ibgs_tpu_torch.models.gaussians import init_from_points
    from ibgs_tpu_torch.renderer import (render_depth_view,
                                         source_views_from_stacks)
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    from ibgs_tpu_torch.train import trainer

    scene = make_synthetic_scene(n_views=6, width=W, height=H, device=dev)
    m = init_from_points(scene.points, scene.colors, 2, device=dev)
    p = m.params
    m = dataclasses.replace(m, params=dataclasses.replace(
        p, opacity_logit=torch.full_like(p.opacity_logit, float(
            np.log(0.85 / 0.15))),
        log_scale=torch.full_like(p.log_scale, float(np.log(0.06)))))
    net = init_fusion_net(ColorFusionResidualNet(32),
                          torch.Generator().manual_seed(0)).to(dev)
    app = torch.zeros(trainer.APP_CAPACITY, 2, device=dev)
    state = trainer.TrainState(
        model=m, app_ab=app, app_opt=trainer.SideOptState.init([app]),
        net=net, net_opt=trainer.SideOptState.init(list(net.parameters())),
        spatial_lr_scale=1.0)
    w2v, centers, _ = scene.poses_stack()
    depths = torch.stack([render_depth_view(m, c, RasterConfig())
                          for c in scene.train_cameras])
    idx = torch.tensor([1, 2, 3, 0, 0], device=dev)
    cam = scene.train_cameras[0]
    src = source_views_from_stacks(
        torch.as_tensor(scene.images).to(dev), depths, w2v, centers, idx, 3,
        cam)
    return state, cam, src, torch.as_tensor(scene.images[0]).to(dev)


@pytest.mark.gpu
def test_band_kernels_match_plain():
    """Bands of rows [0, 64) and [64, 128) of a 64x128 view through
    `rasterize`'s viewport band on the card: stitched equal to the full
    frame (rtol 1e-5, atol 1e-6; n_contrib exact); on the second band
    (row0 64, a band-local tile grid) both kernels against their plain
    versions, the backward with the cotangents of a real loss."""
    dev = _cuda()
    from ibgs_tpu_torch.ops.rasterize import RasterConfig, prepare, rasterize

    state, cam, src, _ = _synthetic_state(dev)
    m, cfg = state.model, RasterConfig()
    nw, off = m.oriented_normal(cam.cam_pos)
    kw = dict(xyz=m.params.xyz, scale=m.scale, quat=m.quat_unit,
              opacity=m.opacity, sh_coeffs=m.sh_coeffs,
              active_sh_degree=m.active_sh_degree, normal_world=nw,
              plane_offset=off, cam=cam, cfg=cfg, alive=m.alive)
    with torch.no_grad():
        full = rasterize(**kw, bg=torch.zeros(3, device=dev), src=src)
        bands = [rasterize(**kw, bg=torch.zeros(3, device=dev), src=src,
                           viewport_row0=r0, viewport_rows=64)
                 for r0 in (0, 64)]
    for f in ("render", "final_t", "median_depth"):
        torch.testing.assert_close(torch.cat([getattr(b, f) for b in bands]),
                                   getattr(full, f), rtol=1e-5, atol=1e-6)
    assert torch.equal(torch.cat([b.n_contrib for b in bands]),
                       full.n_contrib)

    pr = prepare(**kw, viewport_row0=64, viewport_rows=64)
    assert pr.Hp == 64 and pr.row0 == 64 and pr.bins.n_instances > 0
    for mode in (0, 1, 2):
        bcfg = cfg.blend_cfg(render_geo=mode == 1, depth_only=mode == 2)
        args = (pr.feats_inst, pr.bins.tile_start, pr.bins.tile_stop, pr.Wp,
                pr.Hp, cam.fx, cam.fy, cam.cx, cam.cy, bcfg, 64.0)
        tbi.assert_fwd_matches(blend.blend_fwd_cuda(*args),
                               blend.blend_plain(*args))

    recorded, kernel = [], blend.blend_bwd_cuda

    def recorder(*a):
        recorded.append(a)
        return kernel(*a)
    leaf = m.params.sh_dc.detach().requires_grad_(True)
    blend.blend_bwd_cuda = recorder
    try:
        m2 = dataclasses.replace(m, params=dataclasses.replace(
            m.params, sh_dc=leaf))
        res = rasterize(**dict(kw, sh_coeffs=m2.sh_coeffs),
                        bg=torch.zeros(3, device=dev), src=src,
                        viewport_row0=64, viewport_rows=64)
        torch.autograd.grad(res.render.sum() + res.median_depth.mean(),
                            [leaf])
    finally:
        blend.blend_bwd_cuda = kernel
    *head, saved, cts, row0 = recorded[0]
    assert row0 == 64.0
    tbi.assert_bwd_pair(head, saved, cts, row0)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["synthetic", "bundle"])
def test_gsp_step_at_world_size_one_matches_single_chip(scene, request):
    """`gsp_full_train_step` on a 1 x 1 mesh under NCCL, on its fast path
    (exact caps) and its generic exchange (exchange_cap < cap_local,
    nothing dropped), against the single-chip step: losses within 2e-5
    relative, parameters within 2.05·lr of their group with at most 5% of
    entries over 1e-6 (tests/test_gsp.py's bounds), no overflow; the two
    paths' results bit-identical; each step one launch of every kernel.
    On the synthetic scene at 64x128 and on the bundle at 960x544."""
    dev = _cuda()
    import copy

    import torch.distributed as dist

    from ibgs_tpu_torch.models.gaussians import PARAM_FIELDS, lr_tree
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    from ibgs_tpu_torch.parallel import distributed, gsp, sharding
    from ibgs_tpu_torch.train import trainer
    from ibgs_tpu_torch.config import OptimizationParams

    phase = trainer.StepPhase(render_geo=True, use_aggregation=True)
    if scene == "bundle":
        b = request.getfixturevalue("bundle")
        wh = tbi.SIZES[0]
        (state, src), cam = b.train_inputs(wh), b.scenes[wh]["cam"]
        gt, opt, rcfg = b.scenes[wh]["gt"], b.opt, b.rcfg
    else:
        state, cam, src, gt = _synthetic_state(dev)
        opt = OptimizationParams(use_color_aggregation=True,
                                 number_src_frames=3, nb_visible_src_frames=2)
        rcfg = RasterConfig()
    args = (13000, torch.zeros(3, device=dev), False, 1.0, 1e-3)
    s1 = copy.deepcopy(state)
    s1, one = trainer.make_train_step(opt, rcfg, s1.net, phase)(
        s1, cam, 0, gt, src, *args)
    n = one["n_instances"]
    mesh = distributed.global_mesh(1, 1, ("dp", "gs"), dev)
    try:
        assert dist.get_backend() == "nccl"
        out = {}
        for name, caps in (("fast", (0, 0)), ("generic", (2 * n, n))):
            st = copy.deepcopy(state)
            st = dataclasses.replace(st, model=gsp.shard_model(st.model, mesh))
            step = gsp.gsp_full_train_step(opt, rcfg, st.net, phase, mesh,
                                           cam.width, cam.height, *caps)
            out[name], launched = tbi.launched(lambda: step(
                st, sharding._cam_stack([cam]), [0], gt[None],
                sharding.stack_sources([src]), *args))
            assert _of(launched) == tbi.want(1, 1, 1, 1), (name, launched)
    finally:
        dist.destroy_process_group()
    lrs = lr_tree(trainer.make_lr_config(opt), 13000, state.spatial_lr_scale)
    for name, (st, aux) in out.items():
        assert int(aux["n_overflow"]) == 0 and int(aux["nonfinite_grads"]) == 0
        for k in ("loss", "image_loss", "normal_loss", "agg_loss", "psnr"):
            a, b = float(one[k]), float(aux[k])
            assert abs(a - b) <= 2e-5 * max(abs(a), 1.0), (name, k, a, b)
        for f in PARAM_FIELDS:
            a, b = getattr(s1.model.params, f), getattr(st.model.params, f)
            if a.numel() == 0:
                continue
            d = (a - b).abs()
            assert float(d.max()) <= 2.05 * getattr(lrs, f), (name, f)
            assert float((d > 1e-6).float().mean()) < 0.05, (name, f)
    fast, gen = out["fast"][0].model, out["generic"][0].model
    for t in ("params", "mu", "nu"):
        for f in PARAM_FIELDS:
            assert torch.equal(getattr(getattr(fast, t), f),
                               getattr(getattr(gen, t), f)), (t, f)


@contextlib.contextmanager
def _plain_kernels():
    """Routes every kernel wrapper (blend, warp, projection, binning, SSIM)
    to its plain version, so a run takes its plain path on the card."""
    from ibgs_tpu_torch.ops import binning
    from ibgs_tpu_torch.ops import ssim as tssim
    from ibgs_tpu_torch.train import losses
    slots = ((blend, "blend_fwd_cuda", blend.blend_plain),
             (blend, "blend_bwd_cuda", blend.blend_bwd_plain),
             (epilogue, "rgb10_pack_cuda", epilogue.pack_rgb10_rows),
             (epilogue, "warp_fwd_cuda", epilogue.warp_views_plain),
             (epilogue, "warp_bwd_cuda", epilogue.warp_views_bwd_plain),
             (pre, "preprocess_fwd_cuda", pre.preprocess_fwd_plain),
             (pre, "preprocess_bwd_cuda", pre.preprocess_bwd_plain),
             (binning, "bin_staircase_cuda", binning.bin_staircase_plain),
             (tssim, "ssim_map_cuda", losses.ssim_map_plain))
    kernels = [getattr(mod, name) for mod, name, _ in slots]
    for mod, name, plain in slots:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(slots, kernels):
            setattr(mod, name, fn)


@pytest.mark.gpu
def test_example_on_the_card_matches_plain():
    """examples/render_synthetic: the kernels' render against the plain
    path on the card (forward tolerance), and a finite centre gradient."""
    dev = _cuda()
    from ibgs_tpu_torch.examples import render_synthetic as ex
    scene = ex.grid_scene(device=dev)
    k = ex.render(scene)
    with _plain_kernels():
        p = ex.render(scene)
    for f in ("render", "median_depth", "normal", "final_t"):
        a, b = getattr(k, f), getattr(p, f)
        assert bool(((a - b).abs() <= 1e-5 + 1e-5 * b.abs()).all()), f
    assert torch.equal(k.n_contrib, p.n_contrib)
    assert bool(torch.isfinite(ex.xyz_grad(scene)).all())


def _replays(d, cam, dev):
    """The replay of snapshot `d` through the kernels and through the
    plain path: {term: (leaves, screen, rows)} of each."""
    from ibgs_tpu_torch.scripts import replay_snapshot
    got = replay_snapshot.replay(d, cam, dev)
    with _plain_kernels():
        want = replay_snapshot.replay(d, cam, dev)
    return [{t: (r["leaves"], r["screen"], r["rows"])
             for t, r in x["terms"].items()} for x in (got, want)]


@pytest.mark.gpu
def test_replay_on_the_card_matches_plain(tmp_path):
    """A snapshot dumped by the loop in debug mode on the card (a NaN seed
    point): the replay's per-term, per-leaf non-finite counts through the
    kernels equal the plain path's, and name the poisoned row."""
    dev = _cuda()
    import dataclasses as dc

    from ibgs_tpu_torch.config import (ModelParams, OptimizationParams,
                                       PipelineParams)
    from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
    from ibgs_tpu_torch.train.loop import train
    scene = make_synthetic_scene(n_views=4, width=64, height=48, n_gt=600,
                                 n_seed=300, eval_every=8, device=dev)
    pts = scene.points.copy()
    pts[7] = np.nan
    opt = OptimizationParams(
        iterations=2, use_color_aggregation=False,
        single_view_weight_from_iter=10_000,
        multi_view_weight_from_iter=10_000, number_src_frames=2)
    with pytest.raises(FloatingPointError, match="snapshot_fw"):
        train(dc.replace(scene, points=pts), ModelParams(), opt,
              PipelineParams(debug=True), str(tmp_path), save_iterations=(),
              test_iterations=(), log_every=1, quiet=True, device=dev)
    d = dict(np.load(tmp_path / "snapshot_fw.npz"))
    got, want = _replays(d, scene.train_cameras[int(d["cam_idx"])], dev)
    assert got == want
    assert all(rows == [7] for _, _, rows in got.values())


@pytest.mark.gpu
def test_prod_run_on_the_card_grows(tmp_path):
    """A tiny `train_runs prod` on the card: the instance cap grows at the
    first steps, the capacity doubles at the densify event, one launch of
    each kernel per step plus the evaluation's 7 forwards."""
    dev = _cuda()
    from ibgs_tpu_torch.scripts import train_runs
    pl = train_runs.plan([
        "prod", str(tmp_path / "prod"), "--width", "96", "--height", "64",
        "--gt", "3000", "--seed_pts", "1000", "--iters", "10",
        "--init_capacity", "1024", "--cap", "256", "--debug", "1",
        "--log_every", "1", "--device", str(dev)])
    pl.opt = dataclasses.replace(
        pl.opt, densify_from_iter=2, densification_interval=4,
        densify_until_iter=6, single_view_weight_from_iter=30,
        multi_view_weight_from_iter=30)
    pl.train["test_iterations"] = (10,)
    scene = train_runs.build_scene(pl)      # renders its ground truth
    (res, state, _, _), launched = tbi.launched(lambda: train_runs.run(pl,
                                                                       scene))
    assert _of(launched, ("blend_fwd", "blend_bwd")) == \
        {"blend_fwd": 17, "blend_bwd": 10}
    kinds = {e["event"]: e for e in res["events"]}
    assert kinds["instance_cap"]["old"] == 256
    assert kinds["capacity"]["old"] == 1024
    assert res["densify"][0]["capacity"] == state.model.capacity > 1024
    assert res["nonfinite_logged"] == 0
    assert res["final_train_psnr"] > res["first_train_psnr"]


@pytest.mark.gpu
def test_prod_start_against_jax_capped_ground_truth(tmp_path, capsys,
                                                    monkeypatch):
    """The 20k-seed `ref30k` start on the card, twice for the first 100
    iterations of its schedule: against the port's exact ground truth and
    against the JAX package's (the render under its `gt_instance_cap` of
    2^21, which drops the deepest 36% of a view's 3.3M instances).  The capped ground truth
    holds the logged PSNR at iteration 100 at least 5 dB below the exact
    one's.  Prints both runs' PSNR at iterations 1 and 100."""
    import functools

    from ibgs_tpu_torch.data import synthetic
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    from ibgs_tpu_torch.scripts import train_runs
    dev = _cuda()
    got = {}
    for name, gt_cap in (("exact", 0), ("jax_cap", 1 << 21)):
        monkeypatch.setattr(synthetic, "RasterConfig", functools.partial(
            RasterConfig, instance_cap=gt_cap))
        pl = train_runs.plan([
            "ref30k", str(tmp_path / name), "--log_every", "100",
            "--bundle", "", "--eval_cap", "0", "--device", str(dev)])
        # the 30k schedule (its position-lr decay included), stopped at 100
        pl.opt = dataclasses.replace(pl.opt, iterations=100)
        pl.train.update(save_iterations=(), test_iterations=(),
                        checkpoint_iterations=())
        res, _, _, _ = train_runs.run(pl)
        got[name] = dict(res["psnr_trajectory"])
        assert res["nonfinite_logged"] == 0
    with capsys.disabled():
        print(f"\nref30k start, logged PSNR at iterations 1 / 100: {got}")
    assert got["jax_cap"][100] < got["exact"][100] - 5.0


@pytest.mark.gpu
def test_profiler_sessions_keep_every_launch(tmp_path):
    """A sub-millisecond call of 8 launches lost some or all of its device
    events in a few percent of bare torch.profiler sessions on the card;
    `device_time` and `trace` keep all 8 in each of 40 / 10 sessions."""
    import json

    from ibgs_tpu_torch.utils import profiling
    dev = _cuda()
    x = torch.ones(2048, 2048, device=dev)

    def small():
        for _ in range(8):
            x.mul_(1.0000001)

    for _ in range(40):
        r = profiling.device_time(small, dev)
        assert r.get("device_launches") == 8, r
    for i in range(10):
        with profiling.trace(str(tmp_path / str(i))):
            small()
        with open(tmp_path / str(i) / "trace.json") as f:
            got, lost = profiling.device_events(
                json.load(f)["traceEvents"])
        assert (len(got), lost) == (8, [])


# ------------------------------------------------------ staircase binning

def _assert_pack_rows_equal(k, p, P, dev, seed=0):
    """pack_rows through both TileBins: forward and backward bit for
    bit."""
    from ibgs_tpu_torch.ops import binning
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn(P, 16, device=dev, generator=g)
    ct = torch.randn(k.rank.shape[0], 16, device=dev, generator=g)
    outs = []
    for bins in (k, p):
        f = feats.clone().requires_grad_(True)
        out = binning.pack_rows(f, bins)
        (grad,) = torch.autograd.grad((out * ct).sum(), f)
        outs.append((out.detach(), grad))
    assert tbi.same_bits(outs[0][0], outs[1][0])
    assert tbi.same_bits(outs[0][1], outs[1][1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", bcases.CASES)
def test_binning_kernels_match_plain(case):
    """The staircase kernels (csrc/binning.cu) against the plain version on
    the seeded cases of tests/torch_binning_cases.py: every TileBins field
    bit for bit, pack_rows' forward and backward through both, repeats
    bit-identical."""
    dev = _cuda()
    sp, cull, *grid = bcases.scene(case, device=dev)
    cap = row_cap = 0
    if case == "caps":
        cap, row_cap = bcases.caps_inside(
            lambda c, rc: tbi.bins_both(sp, cull, grid, c, rc)[1], sp, cull,
            *grid)
    k, p = tbi.bins_both(sp, cull, grid, cap, row_cap)
    tbi.assert_bins_equal(k, p)
    tbi.assert_bins_equal(tbi.bins_both(sp, cull, grid, cap, row_cap)[0], k)
    _assert_pack_rows_equal(k, p, sp.depth.shape[0], dev)


def _bundle_splats(bundle, band=None):
    """The bundle's splats at 1920x1088 as `prepare` bins them (16x32
    tiles), on the full frame or on the band-local grid of image rows
    [row0, row0 + rows) for band = (row0, rows)."""
    from ibgs_tpu_torch.ops import rasterize as ras
    sp, TX, TY, row0 = bundle.preps[tbi.SIZES[1]].sp, 1920 // 32, 1088 // 16, 0
    if band is not None:
        row0, TY = band[0], band[1] // 16
        sp = ras._band(sp, row0, TY, 16)
    return sp, ras.cull_table(sp, row0), (TX, TY, 16, 32)


@pytest.mark.gpu
@pytest.mark.parametrize("band", [None, (544, 272)])
def test_binning_kernels_match_plain_on_the_bundle(band, bundle):
    """The bundle's 91,307 splats at 1920x1088 (16x32 tiles), on the full
    frame and on a band-local grid at row 544: every TileBins field bit for
    bit without caps and with cap and row_cap both cutting inside a
    Gaussian; pack_rows' forward and backward equal."""
    dev = _cuda()
    sp, cull, grid = _bundle_splats(bundle, band)
    k, p = tbi.bins_both(sp, cull, grid)
    tbi.assert_bins_equal(k, p)
    assert p.n_instances > 100_000
    _assert_pack_rows_equal(k, p, sp.depth.shape[0], dev)
    from ibgs_tpu_torch.ops import binning
    from ibgs_tpu_torch.utils import profiling
    prof = profiling.device_time(
        lambda: binning.bin_staircase_cuda(sp, grid[0], grid[1], 0, cull,
                                           grid[2], grid[3], 0), dev)
    # the zero fill, bin_key, 4 depth passes, bin_count, the totals' copy,
    # bin_emit, 2 tile passes (4,080 or 1,020 tiles), bin_ranges
    assert prof.get("device_launches") == 12, prof
    cap, row_cap = bcases.caps_inside(
        lambda c, rc: tbi.bins_both(sp, cull, grid, c, rc)[1], sp, cull, *grid)
    k, p = tbi.bins_both(sp, cull, grid, cap, row_cap)
    tbi.assert_bins_equal(k, p)
    assert p.rank.shape[0] == cap < p.n_instances
    _assert_pack_rows_equal(k, p, sp.depth.shape[0], dev, seed=1)


@pytest.mark.gpu
def test_bin_splats_launches_the_kernels_and_syncs_once():
    """`bin_splats(staircase=True)` on CUDA tensors launches each binning
    kernel once and makes exactly one blocking host read (counted under
    torch.cuda.set_sync_debug_mode("warn")); its device events are the
    four kernels, the two sorts' and the read's copy."""
    import warnings

    from ibgs_tpu_torch.ops import binning
    from ibgs_tpu_torch.utils import profiling
    dev = _cuda()
    sp, cull, TX, TY, TH, TW = bcases.scene("random", device=dev)

    def call():
        return binning.bin_splats(sp, TX, TY, 0, cull_tab=cull, tile_h=TH,
                                  tile_w=TW, staircase=True)
    call()
    torch.cuda.synchronize()
    before = dict(cu.LAUNCHES)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in seen]
    # 128 tiles: one tile sort pass
    assert {k: n - before[k] for k, n in cu.LAUNCHES.items()
            if n != before[k]} == {"bin_key": 1, "bin_radix": 5,
                                   "bin_count": 1, "bin_emit": 1,
                                   "bin_ranges": 1}
    prof = profiling.device_time(call, dev, top=40)
    print("\nbin_splats device events:", prof)
    assert prof.get("device_launches") == 11, prof


@pytest.mark.gpu
def test_bin_splats_refuses_rectangles_outside_the_grid():
    """A rectangle with rows outside the grid (which the projection never
    writes) makes the kernels' wrapper raise after its one host read."""
    from ibgs_tpu_torch.ops import binning
    dev = _cuda()
    sp, cull, TX, TY, TH, TW = bcases.scene("random", device=dev)
    g = int(torch.nonzero(sp.n_tiles > 0)[0])
    rect_max = sp.rect_max.clone()
    rect_max[g, 1] = TY + 2
    bad = dataclasses.replace(sp, rect_max=rect_max)
    with pytest.raises(ValueError, match="outside"):
        binning.bin_staircase_cuda(bad, TX, TY, 0, cull, TH, TW, 0)


# ------------------------------------------------ the Tanks and Temples frame

TNT_W, TNT_H = 960, 540         # 540 rows: 33.75 tile rows, padded to 544


def _tnt(dev, **cut):
    """The benchmark's `tnt-2m` scene at 960x540 (both exposure options
    on) and the port's and the reference's sides of it; `cut` overrides
    configuration keys (fewer splats)."""
    import dataclasses as dc

    from benchmark import harness, sides

    cfg, mod = harness.config_files("tnt-2m")
    s = mod.build(dict(cfg, **cut), {"width": TNT_W, "height": TNT_H},
                  2 ** 31 + 907, dev)
    out = []
    for m in (sides.port_modules(), sides.reference_modules()):
        side = sides.Side(m, s, dev)
        side.opt = dc.replace(side.opt, **cfg["options"])
        out.append(side)
    return s, out[0], out[1]


@pytest.fixture
def tf32_off():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.gpu
def test_tnt_serve_with_exposure_correction_matches_the_reference(tf32_off):
    """`render_one` of the Tanks and Temples configuration (2M splats,
    960x540, the exposure correction on) against the reference's served
    view, within the limits of the 1M serve cell
    (benchmark/checks/prod-1m.serve-544p.json): each output's relative L1
    gap, on both test views nearest two train views."""
    from benchmark import compare, harness

    dev = _cuda()
    s, port, ref = _tnt(dev)
    assert port.opt.enable_exposure_correction
    lim = harness.limits("prod-1m.serve-544p")
    names = {"render": "render_gap", "depth": "median_depth_gap",
             "warped": "warped_gap", "aggregate": "fused_gap"}
    ev = port.m.render_driver.EvalRenderer(
        port.model(), port.net(), s.images, port.w2v, port.centers,
        port.cams, port.opt, port.rcfg, device=dev)
    rmodel, rnet = ref.model(), ref.net().eval()
    for k in range(2):
        cam = port.camera(s.serve_views[k])
        got = ev.render_one(cam, s.serve_nearest[k])
        want = ref.m.serve.render_one(
            rmodel, rnet, ref.stacks(), ref.cams, ref.opt, ref.rcfg,
            ref.camera(s.serve_views[k]), s.serve_nearest[k])
        assert got["render"].shape == (TNT_H, TNT_W, 3)
        for key, name in names.items():
            gap = compare.rel_l1(got[key], want[key])
            assert gap <= lim[name], (k, key, gap)


@pytest.mark.gpu
def test_tnt_blend_kernels_match_plain_off_the_tile_grid():
    """The blend kernels against their plain versions on the instances of
    a geometry render at 960x540 (the tnt-2m scene cut to 50,000 splats),
    its last tile row 12/16 live: forward at the forward tolerance, the
    backward of seeded cotangents per column."""
    dev = _cuda()
    s, port, _ = _tnt(dev, seed_points=50_000, capacity=65_536)
    seen = []
    packed = blend.blend_packed

    def keep(*a, **k):
        seen.append(a)
        return packed(*a, **k)

    i = 0
    state = port.train_state()
    cache = {j: port.depth(state.model, j) for j in s.nearest[i][:4]}
    src = port.sources(i, cache, port.cams[i])
    blend.blend_packed = keep
    try:
        with torch.no_grad():
            port.m.renderer.render_view(state.model, port.cams[i],
                                        port.rcfg, port.bg, src=src)
    finally:
        blend.blend_packed = packed
    feats, bins, Wp, Hp, fx, fy, cx, cy, cfg = seen[-1][:9]
    assert (Wp, Hp) == (TNT_W, 544) and cfg.render_geo
    args = (feats, bins.tile_start, bins.tile_stop, Wp, Hp, float(fx),
            float(fy), float(cx), float(cy), cfg, 0.0)
    got = blend.blend_fwd_cuda(*args)
    want = blend.blend_plain(*args)
    tbi.assert_fwd_matches(got, want)
    cts = _blend_cts(Hp, Wp, cfg.buffer_len, 540, dev)
    tbi.assert_columns_close(blend.blend_bwd_cuda(*args[:-1], got, cts, 0.0),
                             blend.blend_bwd_plain(*args[:-1], got, cts, 0.0))


@pytest.mark.gpu
def test_tnt_warp_kernels_match_plain_at_540_rows():
    """The warp kernels against their plain versions at 960x540 with
    540-row source tables (test_warp_kernels_match_plain's comparisons)."""
    _check_warp(4, 4, "tnt_540", _cuda(), H=TNT_H, W=TNT_W)


# ------------------------------------------------------------ the SSIM loss

SSIM_CASES = {"frame_1080p": (1088, 1920, False),
              "frame_540": (540, 960, False),
              "stack_1080p": (1088, 1920, True),
              "stack_540": (540, 960, True)}


def _ssim_inputs(case, dev):
    """tbi.ssim_inputs of an SSIM case, seeded by its name."""
    return tbi.ssim_inputs(*SSIM_CASES[case], dev, zlib.crc32(case.encode()))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SSIM_CASES))
def test_ssim_kernels_match_plain(case):
    """The SSIM kernels (csrc/ssim.cu) against the plain chain on the card:
    the map bit for bit, and each gradient bit for bit against autograd
    through the plain chain, with both inputs, the first or the second
    needing one (tests/test_torch_ssim_kernels.py gives the reason);
    repeats bit-identical."""
    tbi.assert_ssim_pair(*_ssim_inputs(case, _cuda()))


@pytest.mark.gpu
def test_ssim_map_launches_once_and_never_syncs():
    """`losses.ssim_map` on CUDA tensors launches ssim_fwd once and, in the
    backward, ssim_bwd once (counted in `_cuda`; one device event forward
    under no_grad), and makes no blocking host call
    (torch.cuda.set_sync_debug_mode("warn")); `losses.ssim` and
    `photometric_ssim` go through it."""
    import warnings

    from ibgs_tpu_torch.train import losses
    from ibgs_tpu_torch.utils import profiling
    dev = _cuda()
    a, b, ct = _ssim_inputs("stack_1080p", dev)
    y = b.clone().requires_grad_(True)

    def call():
        (g,) = torch.autograd.grad((losses.ssim_map(a, y) * ct).sum(), y)
        return g
    call()
    torch.cuda.synchronize()
    before = dict(cu.LAUNCHES)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    assert syncs == [], [str(w.message) for w in syncs]
    assert {k: n - before[k] for k, n in cu.LAUNCHES.items()
            if n != before[k]} == {"ssim_fwd": 1, "ssim_bwd": 1}

    def fwd():
        with torch.no_grad():
            losses.ssim_map(a, b)
    prof = profiling.device_time(fwd, dev)
    assert prof.get("device_launches") == 1, prof
    x = a[0].clone().requires_grad_(True)
    _, launched = tbi.launched(lambda: torch.autograd.grad(
        losses.dssim_l1(x, b[0]) + losses.photometric_ssim(a, y).mean(),
        (x, y)))
    assert launched == {"ssim_fwd": 2, "ssim_bwd": 2}


def _bundle_train_steps(dev, plain_ssim: bool, steps: int = 3,
                        plain_optim: bool = False):
    """The bundle-91k.train-1080p cell's first `steps` train steps (state,
    sources and view order as benchmark/drivers/train.py makes them, at
    one seed), with `ssim_map` on the kernels or routed to the plain chain
    and the optimizer's pass likewise: the loss terms of each step, the
    first step's gradient norms and the leaves' change norms."""
    from benchmark import compare, harness, sides
    from ibgs_tpu_torch.ops import optim
    from ibgs_tpu_torch.ops import ssim as tssim
    from ibgs_tpu_torch.train import losses

    cfg, mod = harness.config_files("bundle-91k")
    traffic = harness.traffic("train-1080p")
    s = mod.build(cfg, traffic, 2 ** 31 + 18, dev)
    port = sides.Side(sides.port_modules(), s, dev)
    order = [int(i) for i in np.random.default_rng(18).permutation(
        s.train_ids)]
    state = port.train_state()
    views = sorted({j for i in order for j in s.nearest[i][:4]})
    cache = {j: port.depth(state.model, j) for j in views}
    step = port.m.trainer.make_train_step(
        port.opt, port.rcfg, state.net,
        port.m.trainer.StepPhase(render_geo=True, use_aggregation=True))
    kernel, on_kernel = tssim.ssim_map_cuda, optim.on_kernel
    if plain_ssim:
        tssim.ssim_map_cuda = losses.ssim_map_plain
    if plain_optim:
        optim.on_kernel = lambda device: False
    try:
        losses_, grads = [], None
        for k in range(steps):
            i = order[k % len(order)]
            state, aux = step(state, port.cams[i], i, s.images[i],
                              port.sources(i, cache, port.cams[i]),
                              int(traffic["iteration"]) + k, port.bg,
                              bool(traffic["use_app"]),
                              float(traffic["burned_in"]),
                              float(traffic["net_lr"]))
            losses_.append({n: float(aux[n]) for n in compare.LOSS_TERMS})
            if k == 0:
                grads = compare.floats(compare.grad_norms(state))
        change = compare.floats(compare.leaf_norms(
            state, base=compare.base_leaves(s)))
    finally:
        tssim.ssim_map_cuda, optim.on_kernel = kernel, on_kernel
    return losses_, grads, change


@pytest.mark.gpu
def test_bundle_train_step_with_ssim_kernels_matches_plain(tf32_off):
    """Three train steps of the bundle at 1920x1088 (geometry and
    aggregation, iteration 13,000) with the SSIM kernels against the same
    steps with `ssim_map` routed to the plain chain: loss, gradient and
    change gaps (benchmark/compare.py's numbers) 0, the kernels' gradient
    terms being the plain chain's and added in its order; 3 + 3 SSIM
    launches a step."""
    from benchmark import compare
    dev = _cuda()
    (k_loss, k_grads, k_change), launched = tbi.launched(
        lambda: _bundle_train_steps(dev, False))
    assert _of(launched, ("ssim_fwd", "ssim_bwd")) == \
        {"ssim_fwd": 9, "ssim_bwd": 9}
    p_loss, p_grads, p_change = _bundle_train_steps(dev, True)
    leaves = compare.moved_leaves(p_grads)
    lg = compare.loss_gap(k_loss, p_loss)
    gg = compare.norm_gap(k_grads, p_grads, leaves)
    sg = compare.norm_gap(k_change, p_change, leaves)
    print(f"\nbundle steps, kernels against plain SSIM: loss {lg}, grad "
          f"{gg}, step {sg}")
    assert lg[0] == gg[0] == sg[0] == 0.0, (lg, gg, sg)


# ------------------------------------------------------------ the optimizer

def _optim_slots():
    """Slots of the optimizer cases: the bundle's capacity as the bundle
    cell loads it (one slot a splat), the 1M and the Tanks and Temples
    cells' capacities."""
    with np.load(tbi.BUNDLE) as d:
        return {"bundle": d["xyz"].shape[0], "1m": 1_310_720,
                "tnt": 2_620_416}


@pytest.mark.gpu
@pytest.mark.parametrize("aggregation", [True, False],
                         ids=["aggregation", "colour"])
@pytest.mark.parametrize("slots", ["bundle", "1m", "tnt"])
def test_optim_kernel_matches_plain(slots, aggregation):
    """The optimizer's kernel against its plain chain on a train step's
    state (tbi.optim_inputs: SH 2, 10% of the slots dead, NaN and +-inf
    planted in the gradients of live and dead slots, of the exposure
    table, of the net and of both screen gradients; the table at its own
    step count; the net's segments with aggregation, its zero gradients
    only counted without): every parameter, moment and statistic bit for
    bit, NaN in the same places, a repeat bit-identical, the count exact
    (12 planted with aggregation, 10 without); one launch a pass.
    Tolerance 0 throughout: the kernel keeps the plain chain's rounding
    points (csrc/optim.cu)."""
    dev = _cuda()
    x = tbi.optim_inputs(_optim_slots()[slots], dev, 2200 + len(slots),
                         aggregation)
    count, launched = tbi.launched(lambda: tbi.assert_optim_pair(x))
    assert count == (12 if aggregation else 10)
    assert launched == {"optim": 2}


@pytest.mark.gpu
def test_optim_kernel_refuses_bad_inputs():
    """A tensor on the host, a float64 or a non-contiguous tensor in a
    pass on the card: a ValueError when the segment is added, nothing
    launched; the card build's table layout is the wrapper's."""
    import ctypes
    from ibgs_tpu_torch.ops import optim
    dev = _cuda()
    t = [torch.zeros(6, 4, device=dev) for _ in range(4)]
    op = optim.OptimPass(dev)
    before = dict(cu.LAUNCHES)
    for k, bad, message in (
            (0, torch.zeros(6, 4), "is on cpu"),
            (3, torch.zeros(6, 4, dtype=torch.float64, device=dev),
             "must be torch.float32"),
            (1, torch.zeros(4, 6, device=dev).t(), "must be contiguous")):
        args = list(t)
        args[k] = bad
        with pytest.raises(ValueError, match=message):
            op.adam(*args, 1e-3, (0.1, 0.001), 0.9, 0.999, 1e-8)
    op.run()
    torch.cuda.synchronize()
    assert cu.LAUNCHES == before
    out = (ctypes.c_longlong * 6)()
    cu.load("optim").ibgs_optim_layout(out)
    T = cu.OptimTable
    assert list(out) == [ctypes.sizeof(T),
                         T.seg.offset + ctypes.sizeof(cu.OptimSeg),
                         T.hyper.offset, T.stats.offset, T.count.offset,
                         T.nseg.offset]


@pytest.mark.gpu
def test_bundle_train_steps_with_the_optim_kernel_match_plain(tf32_off):
    """Three train steps of the bundle at 1920x1088 (geometry and
    aggregation, iteration 13,000) with the optimizer's kernel against the
    same steps with its pass routed to the plain chain: loss, gradient and
    change gaps (benchmark/compare.py's numbers) 0, the kernel's outputs
    being the plain chain's bit for bit; one optim launch a step."""
    from benchmark import compare
    dev = _cuda()
    (k_loss, k_grads, k_change), launched = tbi.launched(
        lambda: _bundle_train_steps(dev, False))
    assert launched.get("optim") == 3
    p_loss, p_grads, p_change = _bundle_train_steps(dev, False,
                                                    plain_optim=True)
    leaves = compare.moved_leaves(p_grads)
    lg = compare.loss_gap(k_loss, p_loss)
    gg = compare.norm_gap(k_grads, p_grads, leaves)
    sg = compare.norm_gap(k_change, p_change, leaves)
    print(f"\nbundle steps, optimizer kernel against plain: loss {lg}, "
          f"grad {gg}, step {sg}")
    assert lg[0] == gg[0] == sg[0] == 0.0, (lg, gg, sg)


# ------------------------------------------------- the bundle and the paths

@pytest.fixture(scope="module")
def bundle():
    """The kernels' inputs on the bundle at 960x544 and 1920x1088
    (tests/torch_bundle_inputs.py), built once."""
    return tbi.bundle_inputs(_cuda())


def _geo_steps(opt, n_train, first, last):
    """Render_geo steps among the loop's iterations first..last."""
    geo_from = opt.single_view_weight_from_iter - 2 * n_train
    return max(0, last - max(first - 1, geo_from))


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _randn_like(ts, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(t.shape, generator=g).to(t.device) for t in ts)


@pytest.mark.gpu
def test_blend_kernels_match_plain_on_the_bundle(bundle):
    """On the bundle's instances at 960x544: the blend forward in every
    mode against plain; the backward in render_geo and colour mode on the
    cotangents of a real backward of the training objective and on seeded
    ones, repeats bit-identical; the binning kernels bit for bit."""
    from ibgs_tpu_torch.ops.rasterize import cull_table
    wh = tbi.SIZES[0]
    pr, cam = bundle.preps[wh], bundle.scenes[wh]["cam"]
    for mode in (0, 1, 2):
        cfg = bundle.rcfg.blend_cfg(render_geo=mode == 1,
                                    depth_only=mode == 2)
        args = (pr.feats_inst, pr.bins.tile_start, pr.bins.tile_stop, pr.Wp,
                pr.Hp, cam.fx, cam.fy, cam.cx, cam.cy, cfg)
        tbi.assert_fwd_matches(blend.blend_fwd_cuda(*args),
                               blend.blend_plain(*args), int_share=1e-4)
    for mode in (1, 0):
        *head, saved, cts, row0 = bundle.captured[(wh, mode)][0]
        for c in (cts, _randn_like(cts, 1234 + mode)):
            tbi.assert_bwd_pair(head, saved, c, row0)
    grid = (pr.Wp // bundle.rcfg.tile_w, pr.Hp // bundle.rcfg.tile_h,
            bundle.rcfg.tile_h, bundle.rcfg.tile_w)
    tbi.assert_bins_equal(*tbi.bins_both(pr.sp, cull_table(pr.sp), grid))


@pytest.mark.gpu
@pytest.mark.parametrize("wh", tbi.SIZES, ids=lambda wh: "%dx%d" % wh)
def test_warp_and_projection_kernels_match_plain_on_the_bundle(bundle, wh):
    """On the inputs and cotangents of a real render_geo backward of the
    training objective, and on seeded cotangents: the warp kernels by
    test_warp_kernels_match_plain's comparisons (the pack equal to the
    recorded tables), the projection kernels by
    test_preprocess_kernels_match_plain's."""
    _, (wa, intr, cts, images), pre_args, pre_cts = \
        bundle.captured[(wh, 1)]
    tbi.assert_warp_pair(wa, intr, cts, images)
    tbi.assert_warp_pair(wa, intr, _randn_like(cts, 4321))
    tbi.assert_pre_fwd(pre_args)
    for c in (pre_cts, tbi.table_cts(pre_args[0].shape[0], images.device)):
        tbi.assert_pre_bwd_pair(tbi.pre_bwd_args(pre_args), c)


@pytest.mark.gpu
def test_projection_and_binning_kernels_match_plain_on_the_1m_scene():
    """The random scene of 1M splats in 1,310,720 slots at 960x544: the
    projection kernels against plain (seeded cotangents as slices of a
    (P, 15) table) and the binning kernels bit for bit."""
    from ibgs_tpu_torch.ops.rasterize import cull_table
    dev = _cuda()
    args = tbi.preprocess_args(*tbi.random_scene(dev, (960, 544)), True, 16,
                               32)
    tbi.assert_pre_fwd(args)
    tbi.assert_pre_bwd_pair(tbi.pre_bwd_args(args),
                            tbi.table_cts(args[0].shape[0], dev))
    with torch.no_grad():
        sp = pre.preprocess(*args)
    k, p = tbi.bins_both(sp, cull_table(sp), (30, 34, 16, 32))
    tbi.assert_bins_equal(k, p)
    assert p.n_instances > 1_000_000


@pytest.mark.gpu
@pytest.mark.parametrize("wh", tbi.SIZES, ids=lambda wh: "%dx%d" % wh)
def test_served_view_launches_each_kernel_exactly(bundle, wh):
    """`render_one` of the bundle view: finite, and exactly five renders
    (four source depths, one render_geo view) projected, binned and
    blended, one pack and one warp forward, no backward, no SSIM."""
    out, launched, want = tbi.served_view(bundle, wh)
    assert launched == want and tbi.finite(out)


@pytest.mark.gpu
def test_train_steps_launch_each_kernel_exactly(bundle):
    """Ten render_geo + aggregation steps of the bundle at 960x544, each
    one launch of every kernel, three SSIM maps with their backward and
    one optimizer pass, finite, no non-finite gradient, the loss falling;
    one colour-only step (iteration 5,000): no pack or warp, one SSIM map,
    one optimizer pass."""
    steps = tbi.train_steps(bundle, 10)
    for k, (_, ok, launched, want) in enumerate(steps):
        assert ok and launched == want, (k, launched)
    assert steps[9][0] < steps[0][0]


@pytest.mark.gpu
def test_bands_on_the_bundle_match_the_full_frame(bundle):
    """2 bands of 272 rows at 960x544 and 4 at 1920x1088 through
    `rasterize`'s viewport band with the warp, stitched against the full
    frame (rtol 1e-5, atol 1e-6; n_contrib exact), one launch of each
    forward kernel a band and a frame; on the last 960x544 band with a
    backward, the blend and warp kernels against their plain versions on
    its recorded arguments, the warp's rays from image row 272."""
    from ibgs_tpu_torch.models.gaussians import PARAM_FIELDS
    from ibgs_tpu_torch.ops.rasterize import prepare, rasterize
    b = bundle
    srcs = {wh: b.train_inputs(wh)[1] for wh in tbi.SIZES}

    def render(model, wh, row0=None, rows=None):
        cam = b.scenes[wh]["cam"]
        nw, off = model.oriented_normal(cam.cam_pos,
                                        learnt=b.opt.learnt_normal)
        return rasterize(
            xyz=model.params.xyz, scale=model.scale, quat=model.quat_unit,
            opacity=model.opacity, sh_coeffs=model.sh_coeffs,
            active_sh_degree=model.active_sh_degree, normal_world=nw,
            plane_offset=off, cam=cam, bg=b.bg, cfg=b.rcfg,
            src=srcs[wh], alive=model.alive, render_geo=True,
            viewport_row0=row0, viewport_rows=rows)

    for wh in tbi.SIZES:
        model, n = b.scenes[wh]["model"], wh[1] // 272
        with torch.no_grad():
            full, launched = tbi.launched(lambda: render(model, wh))
            assert _of(launched) == tbi.want(1, warps=1)
            bands, launched = tbi.launched(lambda: [
                render(model, wh, k * 272, 272) for k in range(n)])
        assert _of(launched) == tbi.want(n, warps=n)
        for f in ("render", "final_t", "median_depth"):
            torch.testing.assert_close(
                torch.cat([getattr(x, f) for x in bands]), getattr(full, f),
                rtol=1e-5, atol=1e-6)
        assert torch.equal(torch.cat([x.n_contrib for x in bands]),
                           full.n_contrib)
    wh, row0 = tbi.SIZES[0], 272
    model, cam = b.scenes[wh]["model"], b.scenes[wh]["cam"]
    leaves = dataclasses.replace(model, params=type(model.params)(**{
        k: getattr(model.params, k).detach().requires_grad_(True)
        for k in PARAM_FIELDS}))
    with tbi.recording() as seen:
        res = render(leaves, wh, row0, 272)
        torch.autograd.grad(res.render.sum() + (res.median_depth ** 2).mean()
                            + res.ibr.warped_image.abs().mean(),
                            [leaves.params.xyz, leaves.params.sh_dc])
    nw, off = model.oriented_normal(cam.cam_pos, learnt=b.opt.learnt_normal)
    pr = prepare(xyz=model.params.xyz, scale=model.scale,
                 quat=model.quat_unit, opacity=model.opacity,
                 sh_coeffs=model.sh_coeffs,
                 active_sh_degree=model.active_sh_degree, normal_world=nw,
                 plane_offset=off, cam=cam, cfg=b.rcfg, alive=model.alive,
                 viewport_row0=row0, viewport_rows=272)
    for mode in (0, 1, 2):
        cfg = b.rcfg.blend_cfg(render_geo=mode == 1, depth_only=mode == 2)
        args = (pr.feats_inst, pr.bins.tile_start, pr.bins.tile_stop, pr.Wp,
                pr.Hp, cam.fx, cam.fy, cam.cx, cam.cy, cfg, row0)
        tbi.assert_fwd_matches(blend.blend_fwd_cuda(*args),
                               blend.blend_plain(*args), int_share=1e-4)
    *head, saved, cts, r0 = seen["blend_bwd"][0]
    assert r0 == row0
    saved = type(saved)(*(getattr(saved, f).detach() for f in tbi.FIELDS))
    head[0], cts = head[0].detach(), tuple(c.detach() for c in cts)
    tbi.assert_bwd_pair(head, saved, cts, r0)
    wa, intr, wcts = tbi.warp_args(seen["warp_fwd"][0], seen["warp_bwd"][0])
    assert len(seen["warp_fwd"]) == 1
    assert abs(float(wa[5][0, 0]) * intr[1] + intr[3] - row0) <= 1e-3
    tbi.assert_warp_pair(wa, intr, wcts, seen["rgb10_pack"][0][0])


# the loop's cut of the schedule on the bundle's 5 views: colour-only to
# 110, aggregation from 151, densify at 100, 150 and 200, the opacity
# reset at 200; an evaluation, a PLY and a checkpoint at 300
LOOP_SCHEDULE = dict(
    iterations=300, position_lr_max_steps=300, densify_from_iter=50,
    densification_interval=50, densify_until_iter=250,
    opacity_reset_interval=200, single_view_weight_from_iter=120,
    multi_view_weight_from_iter=120, start_color_aggregation_iter=150,
    color_aggregate_burnin_steps=50)
LOOP_PROFILE = (60, 10)            # traced colour-only iterations (from, n)


@pytest.fixture(scope="module")
def bundle_loop(tmp_path_factory):
    """`train/loop.train` on the bundle's 5 views at 960x544 from its
    91,307 splat centres, LOOP_SCHEDULE with a trace window at
    LOOP_PROFILE, then a resume from its checkpoint for iteration 301;
    each run's launches."""
    from ibgs_tpu_torch import convert
    from ibgs_tpu_torch.config import (ModelParams, OptimizationParams,
                                       PipelineParams)
    from ibgs_tpu_torch.train import loop
    dev = _cuda()
    d = dict(np.load(tbi.BUNDLE))
    scene = convert.bundle_train_scene(d, 960, 544, dev)
    out = str(tmp_path_factory.mktemp("loop"))
    opt = OptimizationParams(**LOOP_SCHEDULE)
    (state, _), run = tbi.launched(lambda: loop.train(
        scene, ModelParams(sh_degree=2), opt, PipelineParams(
            profile_from_iter=LOOP_PROFILE[0],
            profile_num_steps=LOOP_PROFILE[1]),
        out, save_iterations=(300,), test_iterations=(300,),
        checkpoint_iterations=(300,), quiet=True, seed=24, log_every=1,
        device=dev))
    (_, stacks), resume = tbi.launched(lambda: loop.train(
        scene, ModelParams(sh_degree=2),
        OptimizationParams(**dict(LOOP_SCHEDULE, iterations=301)),
        PipelineParams(), os.path.join(out, "resume"), save_iterations=(),
        test_iterations=(), start_checkpoint=os.path.join(
            out, "chkpnt300.npz"), quiet=True, seed=24, log_every=1,
        device=dev))
    return dict(d=d, scene=scene, out=out, opt=opt, state=state, run=run,
                resume=resume, stacks=stacks)


@pytest.mark.gpu
def test_loop_on_the_bundle_and_its_resume(bundle_loop):
    """The native KNN against the device KNN on the seed cloud (4 float32
    ulps of max |p|²); the run: every iteration logged, finite, a densify
    event that changes the alive count, the image loss falling (last 20
    against first 20), exactly the launches its schedule implies, SSIM
    launched, a PLY, a trace window that kept every device event with less
    device time a step than a colour step's wall time, a checkpoint that
    reloads bit-exact; the resume: iteration 301 alone, finite, the depth
    cache rebuilt for every view, its launches."""
    from ibgs_tpu_torch.core import knn
    from ibgs_tpu_torch.train import checkpoint, loop
    from ibgs_tpu_torch.utils import native, profiling
    r = bundle_loop
    pts, n_train, out = r["scene"].points, r["scene"].n_train, r["out"]
    d2 = knn.mean_sq_dist_to_3nn(torch.as_tensor(pts).to("cuda")).cpu()
    np.testing.assert_allclose(
        d2.numpy(), native.knn_mean_sq_dist_3(pts), rtol=0,
        atol=4 * float(np.finfo(np.float32).eps) * float(
            (pts ** 2).sum(1).max()))
    log = _read_jsonl(os.path.join(out, "train_log.jsonl"))
    events = _read_jsonl(os.path.join(out, "densify_log.jsonl"))
    assert [m["iter"] for m in log] == list(range(1, 301))
    assert all(m["nonfinite_grads"] == 0 and all(
        math.isfinite(m[k]) for k in loop.LOSS_KEYS) for m in log)
    assert any(e["n_alive_after"] != e["n_alive_before"] for e in events)
    assert np.mean([m["image_loss"] for m in log[-20:]]) < np.mean(
        [m["image_loss"] for m in log[:20]])
    geo = _geo_steps(r["opt"], n_train, 1, 300)
    assert _of(r["run"]) == tbi.want(300 + 5, 300, geo + 5, geo)
    assert r["run"].get("ssim_fwd") and r["run"].get("ssim_bwd")
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_300",
                                       "point_cloud.ply"))
    with open(os.path.join(out, "trace", "trace.json")) as f:
        dev_events, lost = profiling.device_events(
            json.load(f).get("traceEvents", []))
    by_it = {m["iter"]: m for m in log}
    p0, pn = LOOP_PROFILE
    colour_ms = sorted((by_it[i]["elapsed"] - by_it[i - 1]["elapsed"]) * 1e3
                       for i in range(p0 + pn + 1, 100))
    assert dev_events and not lost
    assert sum(e.get("dur", 0) for e in dev_events) / 1e3 / pn \
        <= colour_ms[len(colour_ms) // 2]
    loaded, it = checkpoint.load_state(r["state"],
                                       os.path.join(out, "chkpnt300.npz"))
    a, b = (checkpoint.state_arrays(s) for s in (r["state"], loaded))
    assert it == 300 and sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
        for k in a)
    rlog = _read_jsonl(os.path.join(out, "resume", "train_log.jsonl"))
    assert [m["iter"] for m in rlog] == [301]
    assert all(math.isfinite(rlog[0][k]) for k in loop.LOSS_KEYS)
    assert rlog[0]["nonfinite_grads"] == 0
    geo = _geo_steps(r["opt"], n_train, 301, 301)
    assert _of(r["resume"]) == tbi.want(1 + n_train, 1, geo, geo)
    assert int((r["stacks"]["depths"].flatten(1).amax(1) > 0).sum()) \
        == n_train


@pytest.mark.gpu
def test_eval_path_on_the_loop_model(bundle_loop, monkeypatch):
    """On the loop's model directory, the bundle view as the test view:
    `render.render_model` (the test split with FPS, the train views, the
    TSDF mesh at a voxel of the bounds' largest extent / 256): every PNG
    written, each decoding to the truncated float image it was written
    from, all finite; the card's TSDF against the CPU's integration of the
    same inputs (1e-5 on all but 1e-4 of the voxels), a non-empty finite
    mesh; `metrics.evaluate_model_dir` (LPIPS null, SSIM on the card
    within 1e-5 of the CPU's); 12 video frames; one viewer frame intact
    over a loopback socket; exactly the forward launches these imply, no
    backward; eval_geometry's chamfer of the mesh against itself 0 and
    against a copy shifted by 1e-4 along x within 1%."""
    import socket
    import struct
    import threading
    import time
    from collections import Counter

    from ibgs_tpu_torch import convert
    from ibgs_tpu_torch import render as render_cli
    from ibgs_tpu_torch.config import ModelParams, PipelineParams
    from ibgs_tpu_torch.eval import render_driver, tsdf, video, viewer
    from ibgs_tpu_torch.eval.metrics import evaluate_model_dir, ssim
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    from ibgs_tpu_torch.renderer import render_view, source_views_from_stacks
    from ibgs_tpu_torch.scripts import eval_geometry
    from ibgs_tpu_torch.utils import image_io
    dev, r, total = _cuda(), bundle_loop, Counter()
    model_dir, opt, mp = r["out"], r["opt"], ModelParams(sh_degree=2)
    pipe = PipelineParams()
    scene = convert.bundle_eval_scene(r["d"], 960, 544, dev)
    written, fused, save = {}, {"inputs": []}, render_driver._save_png

    def save_png(path, img):
        a = img.detach().cpu().numpy() if torch.is_tensor(img) \
            else np.asarray(img)
        written[path] = (bool(np.isfinite(a).all()),
                         (np.clip(a, 0, 1) * 255).astype(np.uint8))
        save(path, img)

    class Volume(tsdf.TSDFVolume):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            fused.update(volume=self, args=(a, kw))

        def integrate(self, *a, **kw):
            fused["inputs"].append([x.detach().cpu().numpy()
                                    if torch.is_tensor(x) else np.array(x)
                                    for x in a])
            super().integrate(*a, **kw)
    monkeypatch.setattr(render_driver, "_save_png", save_png)
    monkeypatch.setattr(tsdf, "TSDFVolume", Volume)
    res, launched = tbi.launched(lambda: render_cli.render_model(
        scene, mp, opt, pipe, model_dir, 300, render_geo=True,
        voxel_size=float(np.ptp(scene.points, 0).max()) * 1.4 / 256,
        use_depth_filter=True, src_image_ext="png", device=dev))
    monkeypatch.undo()
    total.update(launched)
    n_test, n_train = len(scene.test_cameras), scene.n_train
    for split, n in (("test", n_test), ("train", n_train)):
        for sub in ("renders", "renders_aggregate", "gt", "depth", "normal"):
            assert len(os.listdir(os.path.join(model_dir, split, "ours_300",
                                               sub))) == n, (split, sub)
    assert written and all(fin and np.array_equal(image_io.read_image(p), w)
                           for p, (fin, w) in written.items())
    assert all(math.isfinite(res[k]) for k in ("fps", "model_mb", "memory"))
    kw = dict(fused["args"][1], device="cpu")
    cpu, vol = tsdf.TSDFVolume(*fused["args"][0], **kw), fused["volume"]
    for a in fused["inputs"]:
        cpu.integrate(*a)
    off = ((vol.tsdf.cpu() - cpu.tsdf).abs() > 1e-5) \
        | ((vol.color.cpu() - cpu.color).abs() > 1e-5).any(-1)
    off = (off & (cpu.weight > 0)) | (vol.weight.cpu() != cpu.weight)
    assert int(off.sum()) <= 1e-4 * cpu.weight.numel()
    mesh = os.path.join(model_dir, "mesh.ply")
    verts, faces = tsdf.load_mesh_ply(mesh)
    assert len(faces) and np.isfinite(verts).all()

    scores, launched = tbi.launched(lambda: evaluate_model_dir(model_dir,
                                                              device=dev))
    total.update(launched)
    assert sorted(scores) == ["ours_300/renders",
                              "ours_300/renders_aggregate"]
    assert all(v["lpips"] is None for v in scores.values())
    base = os.path.join(model_dir, "test", "ours_300")
    for split in ("renders", "renders_aggregate"):
        for nm in os.listdir(os.path.join(base, split)):
            im, gt = ((image_io.read_image(os.path.join(base, s, nm))
                       / 255.0).astype(np.float32) for s in (split, "gt"))
            assert abs(ssim(im, gt, dev) - ssim(im, gt, "cpu")) <= 1e-5

    model, _ = render_cli.model_from_ply(os.path.join(
        model_dir, "point_cloud", "iteration_300", "point_cloud.ply"),
        mp.sh_degree, dev)
    rcfg = RasterConfig(buffer_len=opt.buffer_length,
                        depth_error_threshold=opt.depth_error_threshold,
                        staircase_cull=pipe.staircase_cull)
    ev = render_driver.EvalRenderer.from_scene(
        model, render_cli.restore_net(model, opt, model_dir, dev)[0], scene,
        opt, rcfg, dev)
    vpath, launched = tbi.launched(lambda: video.render_video(
        ev, os.path.join(model_dir, "video.mp4"), n_frames=12))
    total.update(launched)
    if os.path.isdir(vpath):               # the PNG sequence (no cv2)
        assert len(os.listdir(vpath)) == 12
    else:                                  # cv2 wrote an mp4
        import cv2
        assert int(cv2.VideoCapture(vpath).get(cv2.CAP_PROP_FRAME_COUNT)) \
            == 12

    wvt = scene.test_cameras[0].view.cpu().numpy().astype(np.float64).T
    wvt[:, 1:3] *= -1.0
    msg = json.dumps(dict(
        resolution_x=960, resolution_y=544, train=True, keep_alive=True,
        fov_x=float(r["d"]["fovx"]), fov_y=float(r["d"]["fovy"]),
        z_near=0.01, z_far=100.0, scaling_modifier=1.0,
        view_matrix=wvt.reshape(-1).tolist(),
        view_projection_matrix=np.eye(4).reshape(-1).tolist())).encode()
    port, reply, frame = viewer.init(port=0), {}, {}

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=30) as c:
            c.sendall(struct.pack("<i", len(msg)) + msg)
            f = c.makefile("rb")
            img = f.read(960 * 544 * 3)
            (n,) = struct.unpack("<i", f.read(4))
            reply.update(image=img, verify=f.read(n).decode())

    def render_fn(cam, msg):
        # the training loop's viewer render: sources off
        st = ev.stacks
        src = source_views_from_stacks(
            st["images"], torch.zeros_like(st["images"][..., 0]), st["w2v"],
            st["centers"], torch.zeros(rcfg.max_src, dtype=torch.long,
                                       device=dev), 0, cam)
        img = render_view(model, cam, rcfg, torch.zeros(3, device=dev),
                          src=src, learnt_normal=opt.learnt_normal,
                          return_depth_normal=False)[0].render
        frame["bytes"] = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(
            np.uint8).tobytes()
        return img

    thread = threading.Thread(target=client, daemon=True)

    def serve():
        thread.start()
        t0 = time.perf_counter()
        while "bytes" not in frame and time.perf_counter() - t0 < 30:
            viewer.serve_once(render_fn, verify="ok", device=dev)
            time.sleep(0.001)
        thread.join(timeout=30)
    try:
        total.update(tbi.launched(serve)[1])
    finally:
        viewer.shutdown()
    assert not thread.is_alive() and reply.get("verify") == "ok"
    assert reply.get("image") == frame.get("bytes")
    # each view: its sources' depths and one render_geo render with the
    # warp (FPS: 5 timed passes and a warm-up of the test view; its PNG
    # pass; the train views twice: PNGs and TSDF; the video); the viewer
    # frame: one render_geo render
    views = (5 + 1) * n_test + n_test + 2 * n_train + 12
    assert _of(total) == tbi.want((opt.number_src_frames + 1) * views + 1,
                                  warps=views + 1)
    assert total["ssim_fwd"] > 0

    shifted = os.path.join(model_dir, "mesh_shifted.ply")
    tsdf.save_mesh_ply(shifted, verts + np.array([1e-4, 0.0, 0.0],
                                                 np.float32), faces)
    same, moved = (eval_geometry.main(["chamfer", "--mesh", m, "--gt", mesh,
                                       "--downsample", "0"])
                   for m in (mesh, shifted))
    assert same["overall"] == 0.0 and abs(moved["overall"] - 1e-4) <= 1e-6


# the CLI's cut of the schedule: densify at 20 and 40, the opacity reset
# at 40 (which 40 Adam steps do not undo: the PSNR is held to rise on each
# side of it), geometry from 36, aggregation from 61, PLY and checkpoint 80
GSP_LOOP_SCHEDULE = dict(
    iterations=80, position_lr_max_steps=80, densify_from_iter=10,
    densification_interval=20, densify_until_iter=45,
    opacity_reset_interval=40, single_view_weight_from_iter=45,
    multi_view_weight_from_iter=45, start_color_aggregation_iter=60,
    color_aggregate_burnin_steps=10)


@pytest.mark.gpu
def test_train_cli_with_gsp_shards_1_on_the_bundle(bundle, tmp_path,
                                                   monkeypatch, capsys):
    """`python -m ibgs_tpu_torch.train --gsp_shards 1` in process on the
    bundle's 5 views (GSP_LOOP_SCHEDULE): exit 0, finite, the evaluation
    PSNR rising from 1 to 39 and from 41 to 80, exactly the launches the
    schedule implies, densify through gsp_densify_fn, the checkpoint
    reloading bit-exact, finite, its alive rows the PLY's."""
    import re

    from ibgs_tpu_torch import convert
    from ibgs_tpu_torch.config import OptimizationParams
    from ibgs_tpu_torch.data import dataset, ply
    from ibgs_tpu_torch.train import __main__ as train_cli
    from ibgs_tpu_torch.train import checkpoint, trainer
    dev = _cuda()
    scene = convert.bundle_train_scene(bundle.d, 960, 544, dev)
    monkeypatch.setattr(dataset, "load_scene", lambda *a, **k: scene)
    out, evals = str(tmp_path / "gsp"), (1, 39, 41, 80)
    argv = ["-s", tbi.BUNDLE, "-m", out, "--gsp_shards", "1", "--device",
            str(dev), "--quiet", "--test_iterations", *map(str, evals),
            "--save_iterations", "80", "--checkpoint_iterations", "80"]
    for k, v in GSP_LOOP_SCHEDULE.items():
        argv += [f"--{k}", str(v)]
    code, launched = tbi.launched(lambda: train_cli.main(argv))
    psnr = {int(i): float(v) for i, v in re.findall(
        r"\[ITER (\d+)\] Evaluating train: PSNR (\S+)",
        capsys.readouterr().out)}
    log = _read_jsonl(os.path.join(out, "train_log.jsonl"))
    events = _read_jsonl(os.path.join(out, "densify_log.jsonl"))
    assert code == 0 and [m["iter"] for m in log] == [1]
    assert all(math.isfinite(m["image_loss"]) and not m["nonfinite_grads"]
               for m in log)
    assert psnr[39] > psnr[1] and psnr[80] > psnr[41], psnr
    geo = _geo_steps(OptimizationParams(**GSP_LOOP_SCHEDULE), scene.n_train,
                     1, 80)
    assert _of(launched) == tbi.want(80 + 5 * len(evals), 80,
                                     geo + 5 * len(evals), geo)
    assert launched.get("ssim_fwd") and launched.get("ssim_bwd")
    assert events and all(e.get("gsp_shards") == 1 for e in events)
    ck, st = os.path.join(out, "chkpnt80.npz"), bundle.train_inputs(
        tbi.SIZES[0])[0]
    loaded, it = checkpoint.load_state(trainer.TrainState(
        model=st.model, app_ab=st.app_ab, app_opt=st.app_opt, net=st.net,
        net_opt=None, spatial_lr_scale=1.0), ck)
    raw, again = dict(np.load(ck)), checkpoint.state_arrays(loaded)
    assert it == 80 and all(again[k].tobytes() == raw[k].tobytes()
                            for k in again)
    xyz = ply.load_gaussian_ply(os.path.join(
        out, "point_cloud", "iteration_80", "point_cloud.ply"))["xyz"]
    assert np.array_equal(xyz, raw["params.xyz"][raw["alive"]])
    assert all(np.isfinite(v).all() for v in raw.values()
               if v.dtype.kind == "f")


@pytest.mark.gpu
def test_prod_run_at_1m_seeds_and_its_bundle(tmp_path, monkeypatch):
    """`train_runs prod` at the JAX package's 1M configuration (1M seeds,
    1.5M ground-truth points, 16 views at 960x544, thresholds 8e-5 /
    1.6e-4, debug on) cut to 60 iterations: the native KNN once, the
    instance cap (2^16) grown, the capacity (2^20, 95% full) grown before
    the densify event at 20, finite, the PSNR rising, exactly the launches
    of 60 steps and 7 evaluation renders; its bundle served once: 5
    renders, 1 warp, finite, the run's splats; a snapshot of every 16th
    alive row of its model (so that the plain path's backward walks take
    seconds) with the alive row nearest view 0's centre ray poisoned,
    replayed through the kernels and the plain path: per term the same
    non-finite counts, the poisoned row among the rows named."""
    from ibgs_tpu_torch import convert
    from ibgs_tpu_torch.config import OptimizationParams
    from ibgs_tpu_torch.eval.render_driver import EvalRenderer
    from ibgs_tpu_torch.models.aggregation import (ColorFusionResidualNet,
                                                   init_fusion_net)
    from ibgs_tpu_torch.models.gaussians import PARAM_FIELDS
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    from ibgs_tpu_torch.renderer import source_views_from_stacks
    from ibgs_tpu_torch.scripts import train_runs
    from ibgs_tpu_torch.utils import native
    dev = _cuda()
    path, out = str(tmp_path / "bundle.npz"), str(tmp_path / "prod")
    pl = train_runs.plan([
        "prod", out, "--bundle", path, "--device", str(dev), "--seed_pts",
        "1000000", "--gt", "1500000", "--grad_th", "8e-5", "--abs_th",
        "1.6e-4", "--init_capacity", str(1 << 20), "--cap", str(1 << 16),
        "--debug", "1", "--log_every", "1", "--iters", "60"])
    pl.opt = dataclasses.replace(
        pl.opt, densify_from_iter=10, densification_interval=10,
        densify_until_iter=25, single_view_weight_from_iter=60,
        multi_view_weight_from_iter=60)
    pl.train["test_iterations"] = (60,)
    scene = train_runs.build_scene(pl)
    knn, calls = native.knn_mean_sq_dist_3, []
    monkeypatch.setattr(native, "knn_mean_sq_dist_3",
                        lambda pts: calls.append(len(pts)) or knn(pts))
    (res, state, stacks, _), launched = tbi.launched(
        lambda: train_runs.run(pl, scene))
    log = _read_jsonl(os.path.join(out, "train_log.jsonl"))
    events = _read_jsonl(os.path.join(out, "densify_log.jsonl"))
    assert calls == [1_000_000]
    assert {"instance_cap", "capacity"} <= {e["event"] for e in res["events"]}
    assert events[0]["capacity"] > 1 << 20
    assert events[0]["n_alive_before"] > 0.9 * (1 << 20)
    assert [m["iter"] for m in log] == list(range(1, 61))
    assert all(m["nonfinite_grads"] == 0 and all(math.isfinite(m[k]) for k in (
        "image_loss", "normal_loss", "photo_loss", "agg_loss", "psnr"))
        for m in log)
    assert log[-1]["psnr"] > log[0]["psnr"]
    geo = _geo_steps(pl.opt, scene.n_train, 1, 60)
    assert _of(launched) == tbi.want(60 + 7, 60, geo + 7, geo)
    assert launched.get("ssim_fwd") and launched.get("ssim_bwd")

    d = dict(np.load(path))
    sc = convert.bundle_scene(d, 960, 544, dev)
    net = init_fusion_net(ColorFusionResidualNet(
        32, pl.opt.feat_aggregate_mode), torch.Generator().manual_seed(0))
    ev = EvalRenderer(sc["model"], net, sc["images"], sc["w2v"],
                      sc["centers"], sc["train_cameras"], OptimizationParams(),
                      RasterConfig(staircase_cull=True), device=dev)
    o, launched = tbi.launched(lambda: ev.render_one(sc["cam"],
                                                     list(range(sc["count"]))))
    assert _of(launched) == tbi.want(5, warps=1) and tbi.finite(o)
    assert int(d["xyz"].shape[0]) == res["points_final"]

    cam, m, idx = scene.train_cameras[0], state.model, np.zeros(5, np.int64)
    nb = list(scene.nearest_ids[0][:pl.opt.number_src_frames])
    idx[:len(nb)] = nb
    src = source_views_from_stacks(
        stacks["images"], stacks["depths"], stacks["w2v"], stacks["centers"],
        torch.as_tensor(idx).to(dev), len(nb), cam)
    pc = m.params.xyz.detach() @ cam.view[:3, :3].T + cam.view[:3, 3]
    off = torch.hypot(pc[:, 0], pc[:, 1]) / pc[:, 2].clamp_min(1e-6)
    near = int(torch.where(m.alive & (pc[:, 2] > 0.2), off, math.inf).argmin())
    keep = np.union1d(np.flatnonzero(m.alive.cpu().numpy())[::16], [near])
    row = int(np.searchsorted(keep, near))
    snap = {k: getattr(m.params, k).detach().cpu().numpy()[keep]
            for k in PARAM_FIELDS}
    snap["log_scale"][row, 0] = np.nan
    snap.update(iter=60, cam_idx=0, src_idx=idx, src_count=len(nb),
                alive=np.ones(len(keep), bool), bg=np.zeros(3, np.float32),
                gt=stacks["images"][0].cpu().numpy(), burned_in=0.5,
                use_app=False, nonfinite_grads=0, **{
                    "src_" + k: getattr(src, k).cpu().numpy()
                    for k in ("images", "depths", "ref_to_src", "cam_pos")})
    got, want = _replays(snap, cam, dev)
    assert {t: (a, b, len(r)) for t, (a, b, r) in got.items()} == \
        {t: (a, b, len(r)) for t, (a, b, r) in want.items()}
    assert any(row in r for _, _, r in got.values())


# the suite runner's schedule: the JAX package's tests/test_colmap_e2e.py
SUITE_EXTRA = [
    "--eval", "--iterations", "15", "--densify_from_iter", "6",
    "--densification_interval", "6", "--densify_until_iter", "12",
    "--single_view_weight_from_iter", "8", "--multi_view_weight_from_iter",
    "8", "--use_color_aggregation", "--start_color_aggregation_iter", "10",
    "--color_aggregate_burnin_steps", "3", "--number_src_frames", "2",
    "--nb_visible_src_frames", "2", "--position_lr_max_steps", "15",
    "--multi_view_num", "3", "--multi_view_max_angle", "120",
    "--multi_view_max_dis", "10", "--instance_cap", "16384",
    "--save_iterations", "15", "--test_iterations", "15",
    "--checkpoint_iterations", "15", "--quiet"]


@pytest.mark.gpu
def test_exp_script_chain_on_the_card(tmp_path):
    """`python -m ibgs_tpu_torch.exp_script` on the COLMAP fixture: train,
    render and metrics as subprocesses on the card; exit 0, its result
    files, both splits' PSNR finite and above 5 dB."""
    import subprocess
    import sys
    dev = _cuda()
    proc = subprocess.run(
        [sys.executable, "-m", "ibgs_tpu_torch.exp_script", "--data_root",
         os.path.join(tbi.ROOT, "tests", "fixtures"), "--out_root",
         str(tmp_path), "--scenes", "mini_colmap", "--device", str(dev),
         "--extra", *SUITE_EXTRA], cwd=tbi.ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    scene_dir = tmp_path / "custom" / "mini_colmap"
    for f in ("result_fps_mem.json", "per_view_renders.json"):
        assert (scene_dir / f).exists(), f
    for f in ("results_renders.json", "results_renders_aggregate.json"):
        (vals,) = json.loads((scene_dir / f).read_text()).values()
        assert math.isfinite(vals["PSNR"]) and vals["PSNR"] > 5.0, f


def _finite_json(x):
    if isinstance(x, dict):
        return all(_finite_json(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite_json(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


@pytest.mark.gpu
def test_bench_on_the_card(tmp_path):
    """`ibgs_tpu_torch.bench` on its four default configs (train mode), the
    bundle in render mode, the 1M scene and the bundle traced: finite, no
    config skipped, no profile error, a chain of 5 steps 5 launches of
    each forward (and, training, backward) kernel; parse_trace's device
    total the trace's, one bench_step span a step."""
    from ibgs_tpu_torch import bench
    from ibgs_tpu_torch.scripts import parse_trace
    from ibgs_tpu_torch.utils import profiling
    dev, k = _cuda(), 5

    def run(argv, train):
        out = bench.run(bench.build_parser().parse_args(
            ["--device", str(dev), "--iters", str(k)] + argv))
        assert _finite_json(out) and out["value"] > 0
        assert "skipped_over_budget" not in out["detail"]
        for row in out["detail"]["configs"]:
            got = {**row["blend_launches"], **row["warp_launches"],
                   **row["preprocess_launches"]}
            assert _of(got) == tbi.want(k, k * train, k, k * train), row
            assert "profile_error" not in row, row
        return out

    out, launched = tbi.launched(lambda: run([], 1))
    assert launched.get("ssim_fwd") and launched.get("ssim_bwd")
    assert [f"{r['config']}@{r['resolution']}"
            for r in out["detail"]["configs"]] == [
        "random@960x544", "random@1920x1088", "converged@960x544",
        "converged@1920x1088"]
    run(["--ckpt", tbi.BUNDLE, "--mode", "render"], 0)
    run(["--n", "1000000", "--width", "960", "--height", "544",
         "--repeats", "1"], 1)
    out = run(["--ckpt", tbi.BUNDLE, "--width", "960", "--height", "544",
               "--repeats", "1", "--profile", str(tmp_path)], 1)
    path = os.path.join(str(tmp_path), "converged_" + out["detail"][
        "configs"][0]["resolution"], "trace.json")
    summ = parse_trace.summarize(parse_trace.load_events(path), k, top_n=20)
    with open(path) as f:
        dev_events, lost = profiling.device_events(
            json.load(f).get("traceEvents", []))
    own_ms = sum(e.get("dur", 0) for e in dev_events) / 1e3
    assert summ["device_events"] == len(dev_events) and summ["device_ms"] > 0
    assert not lost and not summ["lost_launches"]
    assert abs(summ["device_ms"] * k - own_ms) <= 1e-9 * own_ms
    steps = [x for x in summ["spans"] if x[0] == "bench_step"]
    assert steps and steps[0][6] == k


@pytest.mark.gpu
def test_probes_on_the_card():
    """gsp_tax on both exchanges (first losses within 2e-5 relative),
    gsp_scaling's row at world size 1 (exact, no overflow), kernel_probe
    (finite; both blend kernels against plain on its first 4 tile rows),
    perf_probe's six stages (finite, no profile error)."""
    import torch.distributed as dist

    from ibgs_tpu_torch.scripts import (gsp_scaling, gsp_tax, kernel_probe,
                                        perf_probe)
    dev = _cuda()
    for generic in (False, True):
        u, g = gsp_tax.run(gsp_tax.build_parser().parse_args(
            ["--device", str(dev)] + (["--generic"] if generic else [])))[:2]
        assert _finite_json([u, g])
        assert abs(u["loss"] - g["loss"]) <= 2e-5 * max(abs(u["loss"]), 1.0)
    opened = not dist.is_initialized()
    try:
        row = gsp_scaling.rank_row(1, str(dev), True)
    finally:
        if opened and dist.is_initialized():
            dist.destroy_process_group()
    assert row["exact"] and row["overflow"] == 0 and _finite_json(row)
    assert _finite_json(kernel_probe.run(device=dev))
    pl, cfg = kernel_probe.probe_list(device=dev), kernel_probe.config()
    top = pl.rows(4)
    k_out = blend.blend_fwd_cuda(*pl.args(cfg))
    tbi.assert_fwd_matches(k_out.crop(top.Hp, top.Wp),
                           blend.blend_plain(*top.args(cfg)), int_share=1e-4)
    cts = tuple(torch.ones_like(getattr(k_out, f)) for f in
                ("color", "normal", "final_t", "buf_depth", "buf_weight"))
    m = int(top.stop[-1])
    k1, k2 = (blend.blend_bwd_cuda(*pl.args(cfg), k_out, cts)[:m]
              for _ in range(2))
    tbi.assert_columns_close(k1, blend.blend_bwd_plain(
        *top.args(cfg), k_out.crop(top.Hp, top.Wp),
        tuple(c[:top.Hp] for c in cts))[:m])
    assert torch.equal(k1, k2)
    stages = [r for r in perf_probe.run(device=dev)
              if r["probe"].startswith("stage_")]
    assert [r["probe"] for r in stages] == list(perf_probe.STAGES)
    assert _finite_json(stages)
    assert not any("profile_error" in r for r in stages)
