"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips when no CUDA device is present.  This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Forward tolerance: float outputs 1e-5 abs + 1e-5 rel; integer outputs
exact (the kernel is built without multiply-add contraction, so its float
ops round as the plain version's do).  Backward tolerance, per gradient
column: max abs error <= 1e-4 x max |column of the plain version| + 1e-7
(each per-pixel term rounds as the plain version's, but the sums over a
tile's 512 pixels are taken in another order); repeat runs bit-identical.

Beside random tiles, the cases cover what the kernels' layout adds: a
skewed tile set (one tile of 4,500 instances beside empty and short ones:
many staging rounds, two sub-tile CTAs of very different lengths,
longest-first order), ranges that end inside a batch, bit-identical
forward repeats, and a backward tile whose warps stop at very different
positions.

The warp kernels (csrc/warp.cu) are held to their plain versions: the
rgb10 pack and the backward bit for bit, the forward's occlusion outputs
bit for bit (so the `valid` mask is equal at every pixel) and its colour
sums at the forward tolerance (the B entries are summed in another order),
non-finite values in the same places; on the (B, H, W) views of seeded
(H, W, B) buffers of B = 1, 3, 4, 8 and 12 entries (every template
instantiation: the slots of B <= 4 and B <= 8 and the generic loop) and S
= 1 and 5 sources smaller and larger than the view, all-zero weights,
projections wholly out of bounds, NaN source texels (finite outputs: the
pack maps NaN to 0), a NaN buffer depth and source depth, a band at row0
272 and buffers with padded rows.

The projection kernels (csrc/preprocess.cu, `-k preprocess`) are held to
the plain version on the seeded cases of tests/torch_preprocess_cases.py
(SH degrees 0..3, active degree below the maximum, rgb_override, a band,
splats behind the camera, at the near plane, dead and nearly transparent,
one exactly at view z = 0, 200,003 splats): the forward's integer fields
equal, its float fields at the forward tolerance; the backward, per
column, within 2x the float32 plain version's error against a float64 run
of it + 1e-7 of the column's largest value, non-finite values in the
plain version's places, repeats bit-identical.

The staircase binning kernels (csrc/binning.cu, `-k bin`) are held to the
plain version bit for bit on every TileBins field, and on pack_rows'
forward and backward through both: on the seeded cases of
tests/torch_binning_cases.py (caps cutting inside a Gaussian, a band-local
grid, no visible splat, one splat, splats clipping every edge, degenerate
conics, NaN / inf in the cull table, long runs of equal depths and of
equal tiles) and on the bundle at 1920x1088, full frame and a band at row
544, without and with caps (12 device events a call there); one
`bin_splats` launches each kernel once (the radix pass once per digit)
and makes one blocking host read.

The Tanks and Temples frame (`-k tnt`: the benchmark's `tnt-2m` scene at
960x540, whose last tile row is 12/16 live): `render_one` with the
exposure correction on against the benchmark's reference within the 1M
serve cell's limits; the blend kernels against their plain versions on
the instances of a geometry render of that frame; the warp kernels
against theirs at 540 rows with 540-row source tables.
"""
import dataclasses
import zlib

import numpy as np
import pytest
import torch

from ibgs_tpu_torch.ops import blend, epilogue
from ibgs_tpu_torch.ops import preprocess as pre
from ibgs_tpu_torch.ops.blend_common import BlendConfig
import torch_binning_cases as bcases
import torch_preprocess_cases as pcases

FIELDS = ("color", "normal", "final_t", "n_contrib", "buf_depth",
          "buf_weight", "buf_contrib")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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


def _assert_fwd_matches(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype == torch.int32:
            assert torch.equal(a, b), f
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=f)


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
    args = (torch.as_tensor(feats, device=dev),
            torch.as_tensor(start, device=dev),
            torch.as_tensor(stop, device=dev), tiles_x * tw, tiles_y * th,
            300.0, 310.0, 80.0, 24.0, cfg, 16.0)
    before = blend.LAUNCHES["blend_fwd"]
    got = blend.blend_fwd_cuda(*args)
    torch.cuda.synchronize()
    assert blend.LAUNCHES["blend_fwd"] == before + 1
    _assert_fwd_matches(got, blend.blend_plain(*args))


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
    _assert_fwd_matches(got, blend.blend_plain(*args))
    for f in FIELDS:
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
    saved = blend.blend_fwd_cuda(*args, 16.0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    cts = tuple(torch.randn(s, generator=g).to(dev) for s in
                [(Hp, Wp, 3), (Hp, Wp, 3), (Hp, Wp), (Hp, Wp, B),
                 (Hp, Wp, B)])
    return args, saved, cts


def _assert_columns_close(got, want):
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().amax(0)
    tol = 1e-4 * want.abs().amax(0) + 1e-7
    assert bool((err <= tol).all()), (err, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("B", [4, 1, 8])
def test_bwd_kernel_matches_plain(mode, B):
    dev = _cuda()
    args, saved, cts = _bwd_inputs(mode, B, 7 + mode * 10 + B, dev)
    before = blend.LAUNCHES["blend_bwd"]
    got = blend.blend_bwd_cuda(*args, saved, cts, 16.0)
    again = blend.blend_bwd_cuda(*args, saved, cts, 16.0)
    torch.cuda.synchronize()
    assert blend.LAUNCHES["blend_bwd"] == before + 2
    want = blend.blend_bwd_plain(*args, saved, cts, 16.0)
    _assert_columns_close(got, want)
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
    g = torch.Generator(device="cpu").manual_seed(mode)
    cts = tuple(torch.randn(s, generator=g).to(dev) for s in
                [(32, 96, 3), (32, 96, 3), (32, 96), (32, 96, 4),
                 (32, 96, 4)])
    got = blend.blend_bwd_cuda(*args[:-1], saved, cts, 16.0)
    again = blend.blend_bwd_cuda(*args[:-1], saved, cts, 16.0)
    torch.cuda.synchronize()
    _assert_columns_close(got,
                          blend.blend_bwd_plain(*args[:-1], saved, cts, 16.0))
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
    g = torch.Generator(device="cpu").manual_seed(11)
    cts = tuple(torch.randn(s, generator=g).to(dev) for s in
                [(16, 64, 3), (16, 64, 3), (16, 64), (16, 64, 4),
                 (16, 64, 4)])
    got = blend.blend_bwd_cuda(*args, saved, cts)
    again = blend.blend_bwd_cuda(*args, saved, cts)
    torch.cuda.synchronize()
    _assert_columns_close(got, blend.blend_bwd_plain(*args, saved, cts))
    assert torch.equal(got, again)
    assert float(got[0].abs().max()) > 0


@pytest.mark.gpu
def test_occupancy_query():
    """The kernels' occupancy entries answer for the main path's CTA."""
    _cuda()
    from ibgs_tpu_torch.ops import _cuda as cu
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
    before = dict(blend.LAUNCHES)
    out = blend.blend_packed(f, _Bins(args[1], args[2]), *args[3:],
                             row0=16.0)
    loss = (out.color * cts[0]).sum() + (out.buf_depth * cts[3]).sum()
    (g,) = torch.autograd.grad(loss, f)
    torch.cuda.synchronize()
    assert blend.LAUNCHES["blend_fwd"] == before["blend_fwd"] + 1
    assert blend.LAUNCHES["blend_bwd"] == before["blend_bwd"] + 1
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


def _same_bits(a, b):
    """Bit for bit, NaN in the same places (their payloads aside)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _assert_warp_close(got, want, rel, abs_, per_column):
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
    packed = epilogue.rgb10_pack_cuda(images)
    k_fwd = epilogue.warp_fwd_cuda(*args, *intr)
    p_fwd = epilogue.warp_views_plain(*args, *intr)
    k1 = epilogue.warp_bwd_cuda(*args[:6], intr, *cts)
    k2 = epilogue.warp_bwd_cuda(*args[:6], intr, *cts)
    p_bwd = epilogue.warp_views_bwd_plain(*args[:6], intr, *cts)
    torch.cuda.synchronize()
    assert torch.equal(packed, args[2])
    for k, p in zip(k_fwd[:2], p_fwd[:2]):
        _assert_warp_close(k, p, 1e-5, 1e-5, per_column=False)
    for k, p in zip(k_fwd[2:], p_fwd[2:]):
        assert _same_bits(k, p)

    def valid(out):
        return (out[2] > 0.0) & (out[3] < 0.01)
    assert torch.equal(valid(k_fwd), valid(p_fwd))
    for a, b, p in zip(k1, k2, p_bwd):
        assert a.shape == p.shape and _same_bits(a, p) and _same_bits(a, b)
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
    before = dict(epilogue.LAUNCHES)
    tables = epilogue.rgb10_tables(images)
    wsc, ws, _, _ = epilogue.warp_views(d, w, tables, *args[3:], *intr)
    gd, gw = torch.autograd.grad((wsc * cts[0]).sum() + (ws * cts[1]).sum(),
                                 [d, w])
    torch.cuda.synchronize()
    assert {k: epilogue.LAUNCHES[k] - before[k] for k in before} == \
        {"rgb10_pack": 1, "warp_fwd": 1, "warp_bwd": 1}
    for k, p in zip((wsc, ws), epilogue.warp_views_plain(*args, *intr)):
        _assert_warp_close(k, p, 1e-5, 1e-5, per_column=False)
    for k, p in zip((gd, gw),
                    epilogue.warp_views_bwd_plain(*args[:6], intr, *cts)):
        assert _same_bits(k, p)
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
    before = dict(epilogue.LAUNCHES)
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
    assert epilogue.LAUNCHES == before


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


def _pre_bwd_args(args):
    """preprocess_bwd_*'s leading arguments from preprocess's."""
    x, s, q, _, sh, active, n, o, cam = args[:9]
    return x, s, q, sh, active, n, o, cam


def _assert_pre_bwd(k, p32, p64):
    """Per column: the kernel's max |error| against the float64 plain
    version at most 2x the float32 plain version's + 1e-7 of the column's
    largest |value|; non-finite values in the plain version's places."""
    for a, b, c in zip(k, p32, p64):
        if a is None:
            assert b is None
            continue
        P = a.shape[0]
        a2, b2, c2 = (t.reshape(P, -1).double() for t in (a, b, c))
        assert torch.equal(torch.isfinite(a2), torch.isfinite(b2))
        fin = torch.isfinite(b2) & torch.isfinite(c2)
        zero = torch.zeros((), dtype=torch.float64, device=a.device)
        ek = torch.where(fin, (a2 - c2).abs(), zero).amax(0)
        ep = torch.where(fin, (b2 - c2).abs(), zero).amax(0)
        scale = torch.where(fin, c2.abs(), zero).amax(0)
        assert bool((ek <= 2 * ep + 1e-7 * scale).all()), (ek, ep, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PRE_CASES + ["deg2_many"])
def test_preprocess_kernels_match_plain(case):
    """preprocess_fwd_cuda against preprocess_plain: integer fields equal,
    float fields within 1e-5 abs + 1e-5 rel (NaN in the same places);
    preprocess_bwd_cuda, on the strided cotangents of rasterize's table,
    against autograd of the plain version by _assert_pre_bwd; two backward
    runs bit-identical.  `deg2_many` takes 200,003 splats (a ragged last
    CTA)."""
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
    cts = pcases.cotangents(table, not override)
    bargs = _pre_bwd_args(args)
    k1 = pre.preprocess_bwd_cuda(*bargs, cts)
    k2 = pre.preprocess_bwd_cuda(*bargs, cts)
    p32 = pre.preprocess_bwd_plain(*bargs, cts)

    def f64(x):
        return x.double() if torch.is_tensor(x) else x
    p64 = pre.preprocess_bwd_plain(*(f64(a) for a in bargs),
                                   tuple(f64(c) for c in cts))
    torch.cuda.synchronize()
    _assert_pre_bwd(k1, p32, p64)
    for a, b in zip(k1, k2):
        assert (a is None and b is None) or _same_bits(a, b)
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
    before = dict(pre.LAUNCHES)
    sp = pre.preprocess(*full, alive=alive)
    tab = torch.cat([sp.mean2d, sp.conic, sp.opacity[:, None], sp.rgb,
                     sp.plane_normal, sp.plane_dist[:, None],
                     torch.zeros(len(table), 2, device=dev)], dim=1)
    grads = torch.autograd.grad((tab * table).sum(), leaves)
    torch.cuda.synchronize()
    assert {k: pre.LAUNCHES[k] - before[k] for k in before} == \
        {"preprocess_fwd": 1, "preprocess_bwd": 1}
    assert sp.opacity is args[3]
    ref = pre.preprocess_plain(*args, alive=alive)
    assert torch.equal(sp.radius, ref.radius)
    bargs = _pre_bwd_args(args)
    cts = pcases.cotangents(table)
    for g, k in zip(grads, pre.preprocess_bwd_cuda(*bargs, cts)):
        assert _same_bits(g, k)
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
    before = dict(pre.LAUNCHES)
    bad = [(args[0].double(),) + args[1:],
           (args[0].cpu(),) + args[1:],
           args[:2] + (args[2].t().contiguous().t(),) + args[3:],
           args[:4] + (args[4][:, :5].contiguous(),) + args[5:]]
    for a in bad:
        with pytest.raises(ValueError):
            pre.preprocess_fwd_cuda(*a, alive)
        with pytest.raises(ValueError):
            pre.preprocess_bwd_cuda(*_pre_bwd_args(a),
                                    pcases.cotangents(table))
    with pytest.raises(ValueError):
        pre.preprocess_fwd_cuda(*args, alive.float())
    with pytest.raises(ValueError):
        pre.preprocess_bwd_cuda(*_pre_bwd_args(args),
                                pcases.cotangents(table.double()))
    assert pre.LAUNCHES == before


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
    for k in blend.LAUNCHES:
        blend.LAUNCHES[k] = 0
    state, stacks = loop.train(scene, ModelParams(), opt, PipelineParams(),
                               str(tmp_path), save_iterations=(),
                               test_iterations=(), log_every=1, quiet=True,
                               device=dev)
    torch.cuda.synchronize()
    assert blend.LAUNCHES == {"blend_fwd": 20, "blend_bwd": 20}
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
        before = blend.LAUNCHES["blend_fwd"]
        out = tmp_path / str(device)
        fps = render_split(ev, scene.test_cameras, scene.test_images,
                           scene.test_nearest_ids, str(out),
                           measure_fps=True, fps_loops=1)
        if device != "cpu":
            torch.cuda.synchronize()
            assert blend.LAUNCHES["blend_fwd"] - before \
                == 3 * 5 * len(scene.test_cameras)
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
        _assert_fwd_matches(blend.blend_fwd_cuda(*args),
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
    got = blend.blend_bwd_cuda(*head, saved, cts, row0)
    again = blend.blend_bwd_cuda(*head, saved, cts, row0)
    _assert_columns_close(got, blend.blend_bwd_plain(*head, saved, cts, row0))
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_gsp_step_at_world_size_one_matches_single_chip():
    """`gsp_full_train_step` on a 1 x 1 mesh under NCCL, on its fast path
    (exact caps) and its generic exchange (exchange_cap < cap_local,
    nothing dropped), against the single-chip step: losses within 2e-5
    relative, parameters within 2.05·lr of their group with at most 5% of
    entries over 1e-6 (tests/test_gsp.py's bounds), no overflow; the two
    paths' results bit-identical."""
    dev = _cuda()
    import copy

    import torch.distributed as dist

    from ibgs_tpu_torch.models.gaussians import PARAM_FIELDS, lr_tree
    from ibgs_tpu_torch.ops.rasterize import RasterConfig
    from ibgs_tpu_torch.parallel import distributed, gsp, sharding
    from ibgs_tpu_torch.train import trainer
    from ibgs_tpu_torch.config import OptimizationParams

    state, cam, src, gt = _synthetic_state(dev)
    opt = OptimizationParams(use_color_aggregation=True, number_src_frames=3,
                             nb_visible_src_frames=2)
    phase = trainer.StepPhase(render_geo=True, use_aggregation=True)
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
            out[name] = step(st, sharding._cam_stack([cam]), [0], gt[None],
                             sharding.stack_sources([src]), *args)
    finally:
        dist.destroy_process_group()
    lrs = lr_tree(trainer.make_lr_config(opt), 13000, 1.0)
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


class _PlainBlend:
    """Routes the blend and warp wrappers to their plain versions on the
    card."""

    def __enter__(self):
        self.kernels = (blend.blend_fwd_cuda, blend.blend_bwd_cuda,
                        epilogue.rgb10_pack_cuda, epilogue.warp_fwd_cuda,
                        epilogue.warp_bwd_cuda)
        blend.blend_fwd_cuda = blend.blend_plain
        blend.blend_bwd_cuda = blend.blend_bwd_plain
        epilogue.rgb10_pack_cuda = epilogue.pack_rgb10_rows
        epilogue.warp_fwd_cuda = epilogue.warp_views_plain
        epilogue.warp_bwd_cuda = epilogue.warp_views_bwd_plain

    def __exit__(self, *exc):
        (blend.blend_fwd_cuda, blend.blend_bwd_cuda, epilogue.rgb10_pack_cuda,
         epilogue.warp_fwd_cuda, epilogue.warp_bwd_cuda) = self.kernels


@pytest.mark.gpu
def test_example_on_the_card_matches_plain():
    """examples/render_synthetic: the kernels' render against the plain
    path on the card (forward tolerance), and a finite centre gradient."""
    dev = _cuda()
    from ibgs_tpu_torch.examples import render_synthetic as ex
    scene = ex.grid_scene(device=dev)
    k = ex.render(scene)
    with _PlainBlend():
        p = ex.render(scene)
    for f in ("render", "median_depth", "normal", "final_t"):
        a, b = getattr(k, f), getattr(p, f)
        assert bool(((a - b).abs() <= 1e-5 + 1e-5 * b.abs()).all()), f
    assert torch.equal(k.n_contrib, p.n_contrib)
    assert bool(torch.isfinite(ex.xyz_grad(scene)).all())


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
    from ibgs_tpu_torch.scripts import replay_snapshot
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
    cam = scene.train_cameras[int(d["cam_idx"])]
    got = replay_snapshot.replay(d, cam, dev)
    with _PlainBlend():
        want = replay_snapshot.replay(d, cam, dev)
    for t in replay_snapshot.TERMS:
        a, b = got["terms"][t], want["terms"][t]
        assert (a["leaves"], a["screen"], a["rows"]) == \
            (b["leaves"], b["screen"], b["rows"]), t
        assert a["rows"] == [7], t


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
    for k in blend.LAUNCHES:
        blend.LAUNCHES[k] = 0
    res, state, _, _ = train_runs.run(pl, scene)
    torch.cuda.synchronize()
    assert blend.LAUNCHES == {"blend_fwd": 17, "blend_bwd": 10}
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

BIN_FIELDS = ("order", "rank", "gauss_id", "tile_id", "inst_valid",
              "tile_start", "tile_stop", "slot", "seg_off")


def _assert_bins_equal(k, p):
    """Every TileBins field of the kernels equal to the plain version's,
    dtype and shape included, and the two totals."""
    for f in BIN_FIELDS:
        a, b = getattr(k, f), getattr(p, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    assert (k.n_instances, k.n_rows) == (p.n_instances, p.n_rows)


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
    assert _same_bits(outs[0][0], outs[1][0])
    assert _same_bits(outs[0][1], outs[1][1])


def _bins_both(sp, cull, grid, cap=0, row_cap=0):
    from ibgs_tpu_torch.ops import binning
    TX, TY, TH, TW = grid
    k = binning.bin_staircase_cuda(sp, TX, TY, cap, cull, TH, TW, row_cap)
    p = binning.bin_staircase_plain(sp, TX, TY, cap, cull, TH, TW, row_cap)
    return k, p


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
            lambda c, rc: _bins_both(sp, cull, grid, c, rc)[1], sp, cull,
            *grid)
    k, p = _bins_both(sp, cull, grid, cap, row_cap)
    _assert_bins_equal(k, p)
    _assert_bins_equal(_bins_both(sp, cull, grid, cap, row_cap)[0], k)
    _assert_pack_rows_equal(k, p, sp.depth.shape[0], dev)


def _bundle_splats(dev, band=None):
    """The bundle's splats at 1920x1088 as `prepare` bins them (16x32
    tiles), on the full frame or on the band-local grid of image rows
    [row0, row0 + rows) for band = (row0, rows)."""
    from pathlib import Path

    from ibgs_tpu_torch import convert
    from ibgs_tpu_torch.ops import rasterize as ras
    d = dict(np.load(Path(__file__).resolve().parent.parent
                     / "bench_bundle.npz"))
    sc = convert.bundle_scene(d, 1920, 1088, dev)
    m, cam = sc["model"], sc["cam"]
    nw, off = m.oriented_normal(cam.cam_pos)
    TH, TW = 16, 32
    with torch.no_grad():
        sp = pre.preprocess(m.params.xyz, m.scale, m.quat_unit, m.opacity,
                            m.sh_coeffs, m.active_sh_degree, nw, off, cam,
                            TH, TW, alive=m.alive)
    TX, TY, row0 = 1920 // TW, 1088 // TH, 0
    if band is not None:
        row0, rows = band
        TY = rows // TH
        sp = ras._band(sp, row0, TY, TH)
    return sp, ras.cull_table(sp, row0), (TX, TY, TH, TW)


@pytest.mark.gpu
@pytest.mark.parametrize("band", [None, (544, 272)])
def test_binning_kernels_match_plain_on_the_bundle(band):
    """The bundle's 91,307 splats at 1920x1088 (16x32 tiles), on the full
    frame and on a band-local grid at row 544: every TileBins field bit for
    bit without caps and with cap and row_cap both cutting inside a
    Gaussian; pack_rows' forward and backward equal."""
    dev = _cuda()
    sp, cull, grid = _bundle_splats(dev, band)
    k, p = _bins_both(sp, cull, grid)
    _assert_bins_equal(k, p)
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
        lambda c, rc: _bins_both(sp, cull, grid, c, rc)[1], sp, cull, *grid)
    k, p = _bins_both(sp, cull, grid, cap, row_cap)
    _assert_bins_equal(k, p)
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
    before = dict(binning.LAUNCHES)
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
    assert {k: binning.LAUNCHES[k] - before[k] for k in before} == \
        {"bin_key": 1, "bin_radix": 5, "bin_count": 1, "bin_emit": 1,
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
    _assert_fwd_matches(got, want)
    g = torch.Generator(device="cpu").manual_seed(540)
    B = cfg.buffer_len
    cts = tuple(torch.randn(sh, generator=g).to(dev) for sh in
                [(Hp, Wp, 3), (Hp, Wp, 3), (Hp, Wp), (Hp, Wp, B),
                 (Hp, Wp, B)])
    _assert_columns_close(blend.blend_bwd_cuda(*args[:-1], got, cts, 0.0),
                          blend.blend_bwd_plain(*args[:-1], got, cts, 0.0))


@pytest.mark.gpu
def test_tnt_warp_kernels_match_plain_at_540_rows():
    """The warp kernels against their plain versions at 960x540 with
    540-row source tables (test_warp_kernels_match_plain's comparisons)."""
    _check_warp(4, 4, "tnt_540", _cuda(), H=TNT_H, W=TNT_W)


# ------------------------------------------------------------ the SSIM loss

SSIM_CASES = {"frame_1080p": (1088, 1920, False),
              "frame_540": (540, 960, False),
              "stack_1080p": (1088, 1920, True)}


def _ssim_inputs(case, dev):
    """Seeded (img1, img2, map gradient) of an SSIM case: a frame pair, or
    the train step's stack: the ground truth expanded over 3 sources
    (batch stride 0) against the masked warps."""
    H, W, stack = SSIM_CASES[case]
    g = torch.Generator(device="cpu").manual_seed(zlib.crc32(case.encode()))
    shape = (3, H, W, 3) if stack else (H, W, 3)
    a = torch.rand(shape[-3:], generator=g)
    b = (torch.rand(shape, generator=g) * 0.2 + 0.8 * a).clamp(0, 1)
    ct = torch.randn(shape, generator=g)
    a, b, ct = a.to(dev), b.to(dev), ct.to(dev)
    if stack:
        a = a[None].expand_as(b)
    return a, b, ct


def _ssim_grads(fn, a, b, ct, need=(True, True)):
    """The map of fn and the gradients of Σ map·ct w.r.t. the inputs that
    `need` one."""
    x = a.detach().requires_grad_(need[0])
    y = b.detach().requires_grad_(need[1])
    out = fn(x, y)
    ins = [t for t in (x, y) if t.requires_grad]
    return (out.detach(), *torch.autograd.grad((out * ct).sum(), ins))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SSIM_CASES))
def test_ssim_kernels_match_plain(case):
    """The SSIM kernels (csrc/ssim.cu) against the plain chain on the card:
    the map bit for bit, and each gradient bit for bit against autograd
    through the plain chain, with both inputs, the first or the second
    needing one (tests/test_torch_ssim_kernels.py gives the reason);
    repeats bit-identical."""
    from ibgs_tpu_torch.ops import ssim as tssim
    from ibgs_tpu_torch.train import losses
    dev = _cuda()
    a, b, ct = _ssim_inputs(case, dev)
    with torch.no_grad():
        assert _same_bits(tssim.ssim_map_cuda(a, b),
                          losses.ssim_map_plain(a, b))
    for need in ((True, True), (True, False), (False, True)):
        k = _ssim_grads(tssim.ssim_map_cuda, a, b, ct, need)
        p = _ssim_grads(losses.ssim_map_plain, a, b, ct, need)
        for u, v in zip(k, p):
            assert _same_bits(u, v), (need, float((u - v).abs().max()))
    again = _ssim_grads(tssim.ssim_map_cuda, a, b, ct, need)
    assert all(_same_bits(u, v) for u, v in zip(k, again))


@pytest.mark.gpu
def test_ssim_map_launches_once_and_never_syncs():
    """`losses.ssim_map` on CUDA tensors launches ssim_fwd once and, in the
    backward, ssim_bwd once (counted by LAUNCHES; one device event forward
    under no_grad), and makes no blocking host call
    (torch.cuda.set_sync_debug_mode("warn")); `losses.ssim` and
    `photometric_ssim` go through it."""
    import warnings

    from ibgs_tpu_torch.ops import ssim as tssim
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
    before = dict(tssim.LAUNCHES)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    assert syncs == [], [str(w.message) for w in syncs]
    assert {k: tssim.LAUNCHES[k] - before[k] for k in before} == \
        {"ssim_fwd": 1, "ssim_bwd": 1}

    def fwd():
        with torch.no_grad():
            losses.ssim_map(a, b)
    prof = profiling.device_time(fwd, dev)
    assert prof.get("device_launches") == 1, prof
    before = dict(tssim.LAUNCHES)
    x = a[0].clone().requires_grad_(True)
    loss = losses.dssim_l1(x, b[0]) + losses.photometric_ssim(a, y).mean()
    torch.autograd.grad(loss, (x, y))
    assert {k: tssim.LAUNCHES[k] - before[k] for k in before} == \
        {"ssim_fwd": 2, "ssim_bwd": 2}


def _bundle_train_steps(dev, plain_ssim: bool, steps: int = 3):
    """The bundle-91k.train-1080p cell's first `steps` train steps (state,
    sources and view order as benchmark/drivers/train.py makes them, at
    one seed), with `ssim_map` on the kernels or routed to the plain
    chain: the loss terms of each step, the first step's gradient norms
    and the leaves' change norms."""
    from benchmark import compare, harness, sides
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
    kernel = tssim.ssim_map_cuda
    if plain_ssim:
        tssim.ssim_map_cuda = losses.ssim_map_plain
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
        tssim.ssim_map_cuda = kernel
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
    from ibgs_tpu_torch.ops import ssim as tssim
    dev = _cuda()
    before = dict(tssim.LAUNCHES)
    k_loss, k_grads, k_change = _bundle_train_steps(dev, False)
    assert {k: tssim.LAUNCHES[k] - before[k] for k in before} == \
        {"ssim_fwd": 9, "ssim_bwd": 9}
    p_loss, p_grads, p_change = _bundle_train_steps(dev, True)
    leaves = compare.moved_leaves(p_grads)
    lg = compare.loss_gap(k_loss, p_loss)
    gg = compare.norm_gap(k_grads, p_grads, leaves)
    sg = compare.norm_gap(k_change, p_change, leaves)
    print(f"\nbundle steps, kernels against plain SSIM: loss {lg}, grad "
          f"{gg}, step {sg}")
    assert lg[0] == gg[0] == sg[0] == 0.0, (lg, gg, sg)
