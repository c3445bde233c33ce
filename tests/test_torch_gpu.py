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


def _random_instances(seed, tiles_x, tiles_y, tile_h, tile_w, per_tile):
    """A random instance table whose rows are grouped by tile, with splats
    centred in their own tile, and the int32 tile ranges."""
    r = np.random.default_rng(seed)
    counts = r.integers(0, per_tile, tiles_x * tiles_y)
    stop = np.cumsum(counts).astype(np.int32)
    start = (stop - counts).astype(np.int32)
    n = int(stop[-1])
    tile = np.repeat(np.arange(tiles_x * tiles_y), counts)
    mx = (tile % tiles_x) * tile_w + r.uniform(-4, tile_w + 4, n)
    my = (tile // tiles_x) * tile_h + r.uniform(-4, tile_h + 4, n)
    sx, sy = r.uniform(0.5, 6, n), r.uniform(0.5, 6, n)
    rho = r.uniform(-0.8, 0.8, n)
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    conic = np.stack([sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det], 1)
    nrm = r.normal(size=(n, 3))
    nrm[:, 2] = np.abs(nrm[:, 2]) + 0.5
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    feats = np.concatenate(
        [mx[:, None], my[:, None], conic, r.uniform(0.05, 0.99, (n, 1)),
         r.uniform(0, 1, (n, 3)), nrm, -r.uniform(1, 5, (n, 1))], 1)
    return feats.astype(np.float32), start, stop


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
    want = blend.blend_plain(*args)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype == torch.int32:
            assert torch.equal(a, b), f
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=f)


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
