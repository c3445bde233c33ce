"""The staircase binning kernels (csrc/binning.cu) on the CPU: the dispatch,
the wrapper's input checks, the C entries' bindings, and the kernels'
per-item arithmetic against the plain version.

The kernels run only on a card (tests/test_torch_gpu.py holds them to the
plain version there).  Their per-Gaussian, per-row and per-instance work is
in functions that a host build of the same source (g++, no CUDA) runs in
sequence: `ibgs_bin_{key,count,emit,ranges}_host`.  With a stable sort of
the same unsigned keys between them (the order the kernels' radix passes
give), they must give the plain version's TileBins bit for bit on every
case of tests/torch_binning_cases.py: random splats, caps that cut a
Gaussian's rows and slots, a band-local grid, no visible splat, one
splat, splats clipping every edge, degenerate conics, NaN / inf in the
cull table, long runs of equal depths and of equal tiles, tile ids of
three digits; and the digit counts that bin_emit leaves for the tile
sort must be those of the ids it wrote.  What the host build cannot show
(the radix passes, the chained scans across CTAs, the launches) is the
card's test.
"""
import ctypes
import re
import subprocess

import pytest
import torch

import torch_binning_cases as bcases
from ibgs_tpu_torch.ops import _cuda
from ibgs_tpu_torch.ops import binning as tbin
from tests.test_torch_slice import one_torch_thread  # noqa: F401

FIELDS = ("order", "rank", "gauss_id", "tile_id", "inst_valid", "tile_start",
          "tile_stop", "slot", "seg_off")

_P, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_HOST = {"ibgs_bin_key_host": [_P, _P, _LL, _P],
         "ibgs_bin_count_host": [_P] * 5 + [_LL] + [_INT] * 4 + [_LL]
         + [_P] * 3,
         "ibgs_bin_emit_host": [_P] * 5 + [_LL] + [_INT] * 4 + [_P] * 2
         + [_LL] + [_P] * 3,
         "ibgs_bin_ranges_host": [_P] * 4 + [_LL, _INT] + [_P] * 5}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """binning.cu built for the host, without multiply-add contraction."""
    out = tmp_path_factory.mktemp("binning") / "libbinning_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-x", "c++", "-shared", "-fPIC", "-o", str(out),
                    str(_cuda.SOURCES["binning"])], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _HOST.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = None
    return lib


def _ptr(t):
    return t.data_ptr()


def tile_passes(num_tiles):
    """8-bit digits of the largest tile id (the tile sort's passes)."""
    p = 1
    while p < 4 and (num_tiles - 1) >> (8 * p):
        p += 1
    return p


def stable_order(keys_u32):
    """The stable ascending order of (n,) int32 tensors holding unsigned
    keys, as the kernels' radix sort orders them."""
    return torch.sort(keys_u32.long() & 0xFFFFFFFF, stable=True).indices


def host_bins(lib, sp, cull, tiles_x, tiles_y, tile_h, tile_w, cap,
              row_cap) -> tbin.TileBins:
    """The kernels' sequence with the host build's items: the depth keys,
    their stable order, counts and offsets, emission, the stable order of
    the tile ids, ranges."""
    P = sp.depth.shape[0]
    num_tiles = tiles_x * tiles_y
    i32, i64 = torch.int32, torch.int64
    key = torch.empty(P, dtype=i32)
    lib.ibgs_bin_key_host(_ptr(sp.depth), _ptr(sp.n_tiles), P, _ptr(key))
    order = stable_order(key)
    seg_off = torch.empty(P + 1, dtype=i64)
    kept = torch.empty(P, dtype=i32)
    totals = torch.empty(3, dtype=i64)
    grid = (tiles_x, tiles_y, tile_h, tile_w)
    lib.ibgs_bin_count_host(_ptr(order), _ptr(sp.n_tiles), _ptr(sp.rect_min),
                            _ptr(sp.rect_max), _ptr(cull), P, *grid, row_cap,
                            _ptr(seg_off), _ptr(kept), _ptr(totals))
    n_rows, total, outside = totals.tolist()
    assert outside == 0
    n = min(total, cap) if cap else total
    tile = torch.empty(n, dtype=i32)
    rank32 = torch.empty(n, dtype=i32)
    passes = tile_passes(num_tiles)
    hist = torch.zeros(passes, 256, dtype=i32)
    lib.ibgs_bin_emit_host(_ptr(order), _ptr(sp.n_tiles), _ptr(sp.rect_min),
                           _ptr(sp.rect_max), _ptr(cull), P, *grid,
                           _ptr(seg_off), _ptr(kept), n, _ptr(tile),
                           _ptr(rank32), _ptr(hist))
    # the digit counts the tile sort's passes read: the lowest digit's
    # difference array sums to its counts
    hist[0] = torch.cumsum(hist[0], 0)
    for p in range(passes):
        want = torch.bincount((tile.long() >> (8 * p)) & 255, minlength=256)
        assert torch.equal(hist[p].long(), want), p
    perm = stable_order(tile)
    tile_sorted = tile[perm].contiguous()
    rank, gauss_id, tile_id = (torch.empty(n, dtype=i64) for _ in range(3))
    valid = torch.empty(n, dtype=torch.bool)
    start = torch.empty(num_tiles + 1, dtype=i32)
    lib.ibgs_bin_ranges_host(_ptr(tile_sorted), _ptr(perm), _ptr(rank32),
                             _ptr(order), n, num_tiles, _ptr(rank),
                             _ptr(gauss_id), _ptr(tile_id), _ptr(valid),
                             _ptr(start))
    return tbin.TileBins(
        order=order, rank=rank, gauss_id=gauss_id, tile_id=tile_id,
        inst_valid=valid, tile_start=start[:num_tiles], tile_stop=start[1:],
        n_instances=total, slot=perm, seg_off=seg_off, n_rows=n_rows)


def assert_same_bins(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a.cpu(), b.cpu()), f
    assert (got.n_instances, got.n_rows) == (want.n_instances, want.n_rows)


@pytest.mark.parametrize("case", bcases.CASES)
def test_host_build_matches_plain(case, host_lib):
    sp, cull, TX, TY, TH, TW = bcases.scene(case)

    def plain(cap, row_cap):
        return tbin.bin_staircase_plain(sp, TX, TY, cap, cull, TH, TW,
                                        row_cap)
    cap = row_cap = 0
    if case == "caps":
        cap, row_cap = bcases.caps_inside(plain, sp, cull, TX, TY, TH, TW)
    want = plain(cap, row_cap)
    got = host_bins(host_lib, sp, cull, TX, TY, TH, TW, cap, row_cap)
    assert_same_bins(got, want)
    if case == "empty":
        assert want.n_instances == 0 and want.n_rows == 0
    elif case == "caps":
        assert want.n_instances > cap and want.rank.shape[0] == cap
    else:
        assert want.n_instances > 0


def test_depth_keys_order_as_the_stable_float_sort(host_lib):
    """The depth keys' unsigned order is torch's stable float order:
    negatives, -0 tied with +0, +inf, NaN last and tied; culled splats
    (+inf) after every finite depth and before NaN depths."""
    r = torch.Generator().manual_seed(5)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                            0.0, -1e-38, 1e-45, -1e-45, 3.0, -3.0, 1e30])
    depth = torch.cat([special, special, torch.randn(3000, generator=r),
                       torch.randint(-3, 4, (500,), generator=r).float()])
    depth = depth[torch.randperm(depth.shape[0], generator=r)].contiguous()
    n_tiles = (torch.rand(depth.shape[0], generator=r) < 0.8).int()
    key = torch.empty(depth.shape[0], dtype=torch.int32)
    host_lib.ibgs_bin_key_host(_ptr(depth), _ptr(n_tiles), depth.shape[0],
                               _ptr(key))
    want = torch.sort(torch.where(n_tiles > 0, depth, float("inf")),
                      stable=True).indices
    assert torch.equal(stable_order(key), want)


def test_rectangles_outside_the_grid_are_flagged(host_lib):
    """bin_count's flag, which makes the kernels' wrapper raise, marks a
    rectangle with rows outside the grid (whose tile ids would not sort
    below num_tiles) and no other."""
    sp, cull, TX, TY, TH, TW = bcases.scene("edges")

    def flag(sp):
        P = sp.depth.shape[0]
        order = torch.arange(P)
        seg_off = torch.empty(P + 1, dtype=torch.int64)
        kept = torch.empty(P, dtype=torch.int32)
        totals = torch.empty(3, dtype=torch.int64)
        host_lib.ibgs_bin_count_host(
            _ptr(order), _ptr(sp.n_tiles), _ptr(sp.rect_min),
            _ptr(sp.rect_max), _ptr(cull), P, TX, TY, TH, TW, 0,
            _ptr(seg_off), _ptr(kept), _ptr(totals))
        return int(totals[2])
    assert flag(sp) == 0
    g = int(torch.nonzero(sp.n_tiles > 0)[0])
    for field, col, value in (("rect_min", 0, -1), ("rect_max", 0, TX + 1),
                              ("rect_min", 1, -2), ("rect_max", 1, TY + 1)):
        bad = getattr(sp, field).clone()
        bad[g, col] = value
        assert flag(_replace(sp, **{field: bad})) == 1, (field, col)


def test_cpu_tensors_take_the_plain_path():
    """`bin_splats(staircase=True)` on CPU tensors is the plain version and
    launches nothing."""
    sp, cull, TX, TY, TH, TW = bcases.scene("random")
    before = dict(_cuda.LAUNCHES)
    got = tbin.bin_splats(sp, TX, TY, 0, cull_tab=cull, tile_h=TH,
                          tile_w=TW, staircase=True)
    assert _cuda.LAUNCHES == before
    assert {k: before[k] for k in _cuda.BIN_KERNELS} == {
        "bin_key": 0, "bin_radix": 0, "bin_count": 0, "bin_emit": 0,
        "bin_ranges": 0}
    assert_same_bins(got, tbin.bin_staircase_plain(
        sp, TX, TY, 0, cull, TH, TW, 0))


def _replace(sp, **kw):
    return tbin.Splats2D(**{**vars(sp), **kw})


def test_cuda_wrapper_rejects_bad_inputs():
    """The kernels' wrapper raises ValueError, before any build or launch,
    on a wrong dtype, shape or non-contiguous tensor, a bad grid or cap,
    and (checked last) tensors that are not on one CUDA device."""
    sp, cull, TX, TY, TH, TW = bcases.scene("random")
    P = sp.depth.shape[0]
    args = (TX, TY, 0, cull, TH, TW, 0)
    bad = [
        ((_replace(sp, depth=sp.depth.double()),) + args, "depth must be"),
        ((_replace(sp, n_tiles=sp.n_tiles.long()),) + args, "n_tiles must"),
        ((_replace(sp, rect_min=sp.rect_min[:, :1].contiguous()),) + args,
         "rect_min must be"),
        ((_replace(sp, rect_max=sp.rect_max.t().contiguous().t()),) + args,
         "rect_max must be contiguous"),
        ((sp, TX, TY, 0, cull[:, :5].contiguous(), TH, TW, 0),
         "cull_tab must be"),
        ((sp, TX, TY, 0, cull[:P - 1], TH, TW, 0), "cull_tab must be"),
        ((sp, TX, TY, 0, cull.double(), TH, TW, 0), "cull_tab must be"),
        ((sp, TX, 0, 0, cull, TH, TW, 0), "grid of 1"),
        ((sp, TX, TY, 0, cull, TH, 0, 0), "grid of 1"),
        ((sp, 1 << 16, 1 << 15, 0, cull, TH, TW, 0), "grid of 1"),
        ((sp, TX, TY, -1, cull, TH, TW, 0), "cap and row_cap"),
        ((sp, TX, TY, 0, cull, TH, TW, -3), "cap and row_cap"),
        ((sp,) + args, "one CUDA device"),
    ]
    before = dict(_cuda.LAUNCHES)
    for a, msg in bad:
        with pytest.raises(ValueError, match=msg):
            tbin.bin_staircase_cuda(*a)
    assert _cuda.LAUNCHES == before


def test_binning_kernels_are_built_and_bound():
    """binning.cu is among the sources `_cuda.build` compiles, each C
    entry's ctypes signature has as many arguments as its declaration, and
    the host entries the tests call have theirs."""
    assert _cuda.SOURCES["binning"].name == "binning.cu"
    text = _cuda.SOURCES["binning"].read_text()
    for fn in ("ibgs_bin_order", "ibgs_bin_count", "ibgs_bin_emit",
               "ibgs_bin_tiles", "ibgs_bin_ranges", "ibgs_binning_info",
               "ibgs_bin_workspace_words", "ibgs_bin_tile_passes",
               "ibgs_bin_tile_state_words"):
        assert fn in _cuda._SIGNATURES
        m = re.search(r'extern "C" (?:int|long long) ' + fn + r"\(([^)]*)\)",
                      text)
        assert m, fn
        assert len(m.group(1).split(",")) == len(_cuda._SIGNATURES[fn][0])
    for fn, argtypes in _HOST.items():
        m = re.search(r'extern "C" void ' + fn + r"\(([^)]*)\)", text)
        assert m, fn
        assert len(m.group(1).split(",")) == len(argtypes)
    assert 'extern "C" const char* ibgs_cuda_error_string' in text
    assert _cuda.BIN_KERNELS == tuple(k for k in _cuda.LAUNCHES
                                      if k.startswith("bin_"))
