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
"""
import dataclasses

import numpy as np
import pytest
import torch

from ibgs_tpu_torch.ops import blend
from ibgs_tpu_torch.ops.blend_common import BlendConfig

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
