"""Variants of the warp kernels, built from csrc/warp.cu and timed on the card.

    python -m ibgs_tpu_torch.scripts.warp_probe [--sizes 960x544,1920x1088]
        [--buffer 4] [--sources 5] [--iters 20] [--repeats 2] [--seed 0]

Each variant is a copy of the port's warp source (ops/csrc/warp.cu) with
one design choice changed, built by `nvcc` as a library of its own under
build/ (all variants in parallel).  The probe times its three kernels
(rgb10_pack, warp_fwd, warp_bwd) beside the port's own build on one set of
seeded inputs per size:

- the colour table format: "rows" (the port's: each texel's 2x2
  clamp-to-edge footprint of rgb10 words as one 16-byte row, one load per
  footprint) or "words" (one int32 word per texel, four loads per
  footprint, a quarter of the bytes): the probe rewrites the source's
  `fetch`, its pack kernel and TABLE_WORDS;
- the CTA tile: TILE_W pixels wide, 256 / TILE_W rows;
- the register cap: MIN_CTAS CTAs per SM (the port's 4 caps both warp
  kernels at 64 registers; 1 leaves them uncapped).

The inputs: the B entries of a buffer near depth 3 (70% used), S sources of
the view's size seen through small rotations, seeded cotangents.  CUDA
events time `--iters` launches after two warm-ups (the mean); the variants
are timed in turn, `--repeats` times, in reverse order on odd repeats.
Every variant's warp outputs are held to the port's build bit for bit and
its packed tables to the plain pack of its format (`epilogue.pack_rgb10`
or `pack_rgb10_rows`); a mismatch fails the probe.  One JSON line per
(size, repeat, variant) with its ms, registers, spill bytes and CTAs per
SM.  The launches go through `_cuda`'s wrappers with the variant's library
and count in `_cuda.LAUNCHES`.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np
import torch

from ibgs_tpu_torch.ops import _cuda, epilogue
from ibgs_tpu_torch.utils import profiling

TILE_WIDTHS = (8, 16, 32, 64, 256)
# (table format, CTA width, MIN_CTAS); the port's build is ("rows", 16, 4)
PORT = ("rows", 16, 4)
VARIANTS = ([("rows", w, 4) for w in TILE_WIDTHS]
            + [("words", 16, 4), ("rows", 16, 1), ("words", 16, 1)])

# the "words" format: a footprint is four 4-byte loads of one word each
_WORDS_FETCH = """__device__ __forceinline__ Foot fetch(const int* tab, int x0, int y0,
                                      const Params& a) {
  const int x1 = min(x0 + 1, a.Ws - 1), y1 = min(y0 + 1, a.Hs - 1);
  const int* r0 = tab + (long long)y0 * a.Ws;
  const int* r1 = tab + (long long)y1 * a.Ws;
  return Foot{(unsigned int)__ldg(r0 + x0), (unsigned int)__ldg(r0 + x1),
              (unsigned int)__ldg(r1 + x0), (unsigned int)__ldg(r1 + x1)};
}"""
_WORDS_PACK = """__global__ void __launch_bounds__(THREADS)
    rgb10_pack_kernel(const float* __restrict__ img, long long n, int Hs,
                      int Ws, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = pack_texel(img + 3 * i);
}"""


def _set_constant(src: str, name: str, value: int) -> str:
    out, n = re.subn(rf"constexpr int {name} = \d+;",
                     f"constexpr int {name} = {value};", src)
    if n != 1:
        raise RuntimeError(f"warp_probe: constant {name} found {n} times "
                           f"in warp.cu")
    return out


def _replace_definition(src: str, head: str, new: str) -> str:
    """`src` with the definition that starts at `head`, through the brace
    that closes its body, replaced by `new`."""
    if src.count(head) != 1:
        raise RuntimeError(f"warp_probe: {head!r} found {src.count(head)} "
                           f"times in warp.cu")
    start = src.index(head)
    depth, i = 0, src.index("{", start)
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
        if depth == 0:
            return src[:start] + new + src[i:]


def variant_source(table: str, tile_w: int, min_ctas: int) -> str:
    """The port's warp source with one table format, CTA width and
    MIN_CTAS."""
    src = _cuda.SOURCES["warp"].read_text()
    src = _set_constant(src, "TILE_W", tile_w)
    src = _set_constant(src, "MIN_CTAS", min_ctas)
    if table == "words":
        src = _set_constant(src, "TABLE_WORDS", 1)
        src = _replace_definition(
            src, "__device__ __forceinline__ Foot fetch(", _WORDS_FETCH)
        src = _replace_definition(
            src, "__global__ void __launch_bounds__(THREADS)\n"
                 "    rgb10_pack_kernel(", _WORDS_PACK)
    return src


def build_variants(variants) -> dict:
    """{variant: the name of its library in _cuda.SOURCES}, every variant
    but the port's written under build/ and compiled in parallel."""
    names = {}
    out_dir = _cuda.BUILD_DIR / "warp_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for v in variants:
        if v == PORT:
            names[v] = "warp"
            continue
        name = "warp_{}_{}_{}".format(*v)
        path = out_dir / f"{name}.cu"
        path.write_text(variant_source(*v))
        _cuda.SOURCES[name] = path
        names[v] = name
    _cuda.build(sorted(set(names.values())))
    return names


def _bits(t):
    return t.view(torch.int32)


def time_variants(names: dict, args, intr, cts, images, iters: int,
                  repeats: int, emit) -> list:
    """Times every variant of `names` (from `build_variants`) on one set of
    inputs: `args` the forward's eight tensors (bd, bw, tables, r2s, pdx,
    pdy, median, depths) as `epilogue.warp_fwd_cuda` takes them, `intr`
    (fx, fy, cx, cy), `cts` the cotangents (g_wsc, g_wsum), `images` the
    (S, Hs, Ws, 3) float sources.  Raises where a variant's outputs differ
    from the port's.  Returns the records (each also passed to `emit`)."""
    bd, bw, _, r2s, pdx, pdy, median, depths = args
    g_wsc, g_wsum = (g.contiguous() for g in cts)
    dev = bd.device
    (B, H, W), (S, Hs, Ws) = bd.shape, images.shape[:3]
    rs = epilogue._row_stride(bd)
    intr = tuple(float(v) for v in intr)
    plain_tables = {"rows": epilogue.pack_rgb10_rows(images),
                    "words": epilogue.pack_rgb10(images)}

    def calls(variant):
        lib = names[variant]
        packed = torch.empty_like(plain_tables[variant[0]])
        outs = (torch.empty(S, H, W, 3, device=dev),
                *(torch.empty(S, H, W, device=dev) for _ in range(3)))
        grads = tuple(torch.empty(H, W, B, device=dev) for _ in range(2))
        return packed, (*outs, *grads), {
            "pack": lambda: _cuda.rgb10_pack(images, packed, lib),
            "fwd": lambda: _cuda.warp_fwd(
                bd, bw, rs, packed, r2s, pdx, pdy, median, depths, intr,
                outs, lib),
            "bwd": lambda: _cuda.warp_bwd(
                bd, bw, rs, packed, r2s, pdx, pdy, intr, g_wsc, g_wsum,
                *grads, lib)}

    ref = None
    for variant in [PORT] + [v for v in names if v != PORT]:
        packed, results, fns = calls(variant)
        for fn in fns.values():
            fn()
        torch.cuda.synchronize(dev)
        if not torch.equal(packed, plain_tables[variant[0]]):
            raise AssertionError(f"warp_probe {variant}: the packed tables "
                                 f"differ from the plain pack")
        if ref is None:
            ref = [t.clone() for t in results]
        elif not all(torch.equal(_bits(a), _bits(b))
                     for a, b in zip(results, ref)):
            raise AssertionError(f"warp_probe {variant}: outputs differ "
                                 f"from the port's build")

    records = []
    order = list(names)
    for rep in range(repeats):
        for variant in (order if rep % 2 == 0 else order[::-1]):
            _, _, fns = calls(variant)
            ms = {k: profiling.wall_ms(fn, iters, 2, dev)
                  for k, fn in fns.items()}
            info = {k: _cuda.kernel_info(kernel, B, S,
                                         source=names[variant])
                    for k, kernel in (("pack", "rgb10_pack"),
                                      ("fwd", "warp_fwd"),
                                      ("bwd", "warp_bwd"))}
            rec = {"probe": "warp_variant", "size": [W, H], "repeat": rep,
                   "table": variant[0], "cta": [variant[1],
                                                256 // variant[1]],
                   "min_ctas": variant[2], "port": variant == PORT,
                   **{f"{k}_ms": v for k, v in ms.items()},
                   "pack_fwd_bwd_ms": sum(ms.values()),
                   "table_bytes": plain_tables[variant[0]].numel() * 4,
                   **{f"{k}_{f}": i[f] for k, i in info.items()
                      for f in ("registers", "local_bytes", "ctas_per_sm")},
                   "equal_to_port": True}
            records.append(rec)
            emit(rec)
    return records


def synthetic_inputs(width: int, height: int, B: int, S: int, seed: int,
                     dev):
    """Seeded warp inputs at one view size: (the forward's eight tensors,
    the intrinsics, the cotangents, the float source images)."""
    r = np.random.default_rng(seed)
    used = r.uniform(size=(height, width, B)) < 0.7
    bw = np.where(used, r.uniform(0.01, 0.5, (height, width, B)), 0.0)
    bd = np.where(used, 3.0 + r.normal(size=(height, width, B)) * 0.03, 0.0)
    r2s = np.tile(np.eye(4), (S, 1, 1))
    for s in range(S):
        a = r.normal(size=3) * 0.02            # a small rotation
        r2s[s, :3, :3] += [[0, -a[2], a[1]], [a[2], 0, -a[0]],
                           [-a[1], a[0], 0]]
        r2s[s, :3, 3] = r.normal(size=3) * [0.05, 0.05, 0.01]
    fx = fy = float(width)
    cx, cy = width / 2.0, height / 2.0
    gx, gy = np.meshgrid(np.arange(width), np.arange(height))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    buf_d, buf_w = f32(bd), f32(bw)
    median = ((buf_w * buf_d).sum(-1)
              / ((buf_w * (buf_w != 0)).sum(-1) + epilogue.EPS))
    images = f32(r.uniform(0.0, 1.0, (S, height, width, 3)))
    args = (buf_d.permute(2, 0, 1), buf_w.permute(2, 0, 1),
            epilogue.pack_rgb10_rows(images), f32(r2s), f32((gx - cx) / fx),
            f32((gy - cy) / fy), median.contiguous(),
            f32(3.0 + r.normal(size=(S, height, width)) * 0.03))
    cts = (f32(r.normal(size=(S, height, width, 3))),
           f32(r.normal(size=(S, height, width))))
    return args, (fx, fy, cx, cy), cts, images


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sizes", default="960x544,1920x1088",
                   help="view sizes WxH, comma-separated")
    p.add_argument("--buffer", type=int, default=4, help="entries B")
    p.add_argument("--sources", type=int, default=5, help="sources S")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    from ibgs_tpu_torch.bench import resolve_device, smi_line
    dev = resolve_device("cuda")

    def emit(rec):
        print(json.dumps(rec), flush=True)
    emit({"probe": "device", "dev": torch.cuda.get_device_name(dev),
          "nvidia_smi": smi_line(), "buffer": args.buffer,
          "sources": args.sources})
    names = build_variants(VARIANTS)
    for size in args.sizes.split(","):
        w, h = (int(v) for v in size.split("x"))
        time_variants(names, *synthetic_inputs(w, h, args.buffer,
                                               args.sources, args.seed, dev),
                      iters=args.iters, repeats=args.repeats, emit=emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
