"""Blend-kernel micro-bench (counterpart of scripts/kernel_probe.py; its
environment variables are flags here).

    python -m ibgs_tpu_torch.scripts.kernel_probe [--kp_instances 1370000]
        [--kp_iters 5] [--kp_data list.npz] [--device cuda]

Times the CUDA blend forward (render_geo, B = 4) and the forward+backward
through the port's wrappers, in isolation, on a synthetic instance list
shaped like the bench scene: 1.37M instances split uniformly over the
60x34 16x16 tiles of 960x544, each near its tile's centre (σ 6 px), with
the JAX probe's numpy draws (default_rng(0)).  `--kp_data` loads a real
list instead (npz keys n, feats, start, stop).  Each iteration writes
acc·1e-30 + i into the unused FPAD column of row 0, so no iteration
repeats the last; CUDA events time `--kp_iters` iterations after two
warm-ups (the mean).  One JSON line per kernel: ms, the bound (the larger
of the bytes moved over the card's memory rate and the float operations
of the walked and contributing pairs over its fp32 rate, from this list:
PERF.md §6), the share of it, and the plain PyTorch version's ms on the
same list.  The JAX probe's shard_map smoke
and its GSP step have no counterpart here: the port runs no Mosaic, and
its GSP step on the card is timed by gsp_tax.py.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import types

import numpy as np
import torch

from ibgs_tpu_torch.ops import blend
from ibgs_tpu_torch.ops.blend import CF, FPAD
from ibgs_tpu_torch.ops.blend_common import BlendConfig
from ibgs_tpu_torch.utils import profiling

W, H = 960, 544
TILE = 16
CHUNK = 128                    # the JAX probe's row padding (bp.CHUNK)
FX = FY = 500.0
B = 4
HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
FP32_FLOP_S = 67e12            # H100 SXM fp32 (non-tensor) peak
OPS_PER_PAIR = 17              # per walked (instance, pixel) pair
OPS_PER_CONTRIB_PAIR = 94      # backward, render_geo, per contributing pair


@dataclasses.dataclass
class ProbeList:
    feats: torch.Tensor        # (cap, 16) float32 instance table
    start: torch.Tensor        # (tiles,) int32
    stop: torch.Tensor
    n: int                     # instances
    Wp: int
    Hp: int

    def args(self, cfg: BlendConfig):
        """The blend wrappers' positional arguments."""
        return (self.feats, self.start, self.stop, self.Wp, self.Hp, FX, FY,
                W / 2, H / 2, cfg)

    def rows(self, tile_rows: int) -> "ProbeList":
        """The first `tile_rows` rows of tiles as a list of their own (the
        tiles' pixels keep their coordinates)."""
        t = tile_rows * (self.Wp // TILE)
        return dataclasses.replace(self, start=self.start[:t],
                                   stop=self.stop[:t], Hp=tile_rows * TILE)


def synthetic_list(n_inst: int):
    """The JAX probe's list (scripts/kernel_probe.py:60-79) as numpy:
    (feats (cap, 16), tile_start, tile_stop)."""
    tiles_x, tiles_y = W // TILE, H // TILE
    num_tiles = tiles_x * tiles_y
    cap = -(-n_inst // CHUNK) * CHUNK + CHUNK
    rng = np.random.default_rng(0)
    per = n_inst // num_tiles
    start = (np.arange(num_tiles) * per).astype(np.int32)
    stop = np.concatenate([start[1:], [n_inst]]).astype(np.int32)
    feats = np.zeros((cap, CF), np.float32)
    tile_of = np.repeat(np.arange(num_tiles), per)
    tile_of = np.concatenate(
        [tile_of, np.full(n_inst - tile_of.size, num_tiles - 1)])
    cx_t = (tile_of % tiles_x) * TILE + TILE / 2
    cy_t = (tile_of // tiles_x) * TILE + TILE / 2
    feats[:n_inst, blend.FX] = cx_t + rng.normal(0, 6, n_inst)
    feats[:n_inst, blend.FY] = cy_t + rng.normal(0, 6, n_inst)
    sig = rng.uniform(2.0, 8.0, n_inst)
    feats[:n_inst, blend.FCA] = 1.0 / sig ** 2
    feats[:n_inst, blend.FCC] = 1.0 / sig ** 2
    feats[:n_inst, blend.FOP] = rng.uniform(0.02, 0.9, n_inst)
    feats[:n_inst, blend.FR:blend.FB + 1] = rng.random((n_inst, 3))
    feats[:n_inst, blend.FNX:blend.FNZ + 1] = np.array([0.0, 0.0, 1.0])
    feats[:n_inst, blend.FD] = -rng.uniform(1.0, 5.0, n_inst)
    return feats, start, stop


def load_list(path: str):
    """A real list exported from a scene (npz: n, feats (m, <=16), start,
    stop), padded to CHUNK rows of 16 columns."""
    d = np.load(path)
    cap = -(-d["feats"].shape[0] // CHUNK) * CHUNK
    feats = np.zeros((cap, CF), np.float32)
    feats[:d["feats"].shape[0], :d["feats"].shape[1]] = d["feats"]
    if d["start"].size != (W // TILE) * (H // TILE):
        raise ValueError(f"{path}: {d['start'].size} tiles, expected "
                         f"{(W // TILE) * (H // TILE)}")
    return int(d["n"]), feats, d["start"].astype(np.int32), \
        d["stop"].astype(np.int32)


def probe_list(n_inst: int = 1_370_000, data: str = "",
               device="cuda") -> ProbeList:
    if data:
        n_inst, feats, start, stop = load_list(data)
    else:
        feats, start, stop = synthetic_list(n_inst)

    def t(x):
        return torch.as_tensor(x).to(device)

    return ProbeList(feats=t(feats), start=t(start), stop=t(stop), n=n_inst,
                     Wp=W, Hp=H)


def config() -> BlendConfig:
    return BlendConfig(tile_h=TILE, tile_w=TILE, buffer_len=B,
                       render_geo=True, depth_only=False)


def fwd_bound(pl: ProbeList, walked: int):
    """(bound ms, "bytes" | "operations") of the forward on this list:
    13 columns read per instance, the tile ranges, each pixel's outputs
    written; 17 ops per walked pair."""
    nbytes = (pl.feats.shape[0] * 13 * 4 + 2 * pl.start.numel() * 4
              + pl.Wp * pl.Hp * (8 + 3 * B) * 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, walked * OPS_PER_PAIR / FP32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bwd_bound(pl: ProbeList, walked: int, contrib: int):
    """The backward's bound: the table read and its 16-column gradient
    written, the ranges, the saved outputs and cotangents per pixel; the
    re-walk's 17 ops per walked pair plus 94 per contributing pair."""
    nbytes = (pl.feats.shape[0] * (13 + 16) * 4 + 2 * pl.start.numel() * 4
              + pl.Wp * pl.Hp * (9 + 6 + 4 * B) * 4)
    ops = walked * OPS_PER_PAIR + contrib * OPS_PER_CONTRIB_PAIR
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _objective(out) -> torch.Tensor:
    """The JAX probe's forward+backward objective: the sum of colour,
    normal, final T and both buffer parts."""
    return (out.color.sum() + out.final_t.sum() + out.buf_depth.sum()
            + out.buf_weight.sum() + out.normal.sum())


def run(n_inst: int = 1_370_000, iters: int = 5, data: str = "",
        device="cuda", emit=None) -> list:
    """Time both probes; returns (and passes to `emit`) their records."""
    dev = torch.device(device)
    pl = probe_list(n_inst, data, dev)
    cfg = config()
    records = []

    def out(rec):
        records.append(rec)
        if emit is not None:
            emit(rec)

    out({"probe": "device", "dev": (torch.cuda.get_device_name(dev)
                                    if dev.type == "cuda" else "cpu"),
         "n_inst": pl.n, "cap": pl.feats.shape[0]})
    fwd = blend.blend_fwd_cuda if dev.type == "cuda" else blend.blend_plain
    feats = pl.feats.clone()
    state = {"acc": torch.zeros((), device=dev), "i": 0}

    def perturbed():
        feats[0, FPAD] = state["acc"] * 1e-30 + float(state["i"])
        state["i"] += 1
        return feats

    def fwd_only():
        o = fwd(perturbed(), *pl.args(cfg)[1:])
        state["acc"] = (state["acc"] + o.color.sum() + o.final_t.sum()
                        + o.buf_depth.sum())

    def fwd_bwd():
        f = perturbed().detach().requires_grad_(True)
        o = blend.blend_packed(
            f, types.SimpleNamespace(tile_start=pl.start, tile_stop=pl.stop),
            pl.Wp, pl.Hp, FX, FY, W / 2, H / 2, cfg)
        v = _objective(o)
        g, = torch.autograd.grad(v, f)
        state["acc"] = state["acc"] + v.detach() + g.sum() * 1e-20

    o = fwd(*pl.args(cfg))
    walked = int(o.n_contrib.long().sum())
    stats = {}
    cts = (torch.ones_like(o.color), torch.ones_like(o.normal),
           torch.ones_like(o.final_t), torch.ones_like(o.buf_depth),
           torch.ones_like(o.buf_weight))
    plain_bwd_ms = profiling.wall_ms(
        lambda: blend.blend_bwd_plain(*pl.args(cfg), o, cts, stats=stats),
        device=dev)
    contrib = stats["contrib_pairs"]
    plain_fwd_ms = profiling.wall_ms(lambda: blend.blend_plain(*pl.args(cfg)),
                                     device=dev)
    fb, fb_by = fwd_bound(pl, walked)
    bb, bb_by = bwd_bound(pl, walked, contrib)
    for name, fn, bound, by, plain in (
            ("blend_fwd", fwd_only, fb, fb_by, plain_fwd_ms),
            ("blend_fwd_bwd", fwd_bwd, fb + bb, bb_by if bb >= fb else fb_by,
             plain_fwd_ms + plain_bwd_ms)):
        ms = profiling.wall_ms(fn, iters, warmup=2, device=dev)
        if not bool(torch.isfinite(state["acc"])):
            raise FloatingPointError(f"{name}: non-finite probe sum")
        out({"probe": name, "ms": ms, "bound_ms": bound, "bound_by": by,
             "bound_share": bound / ms, "plain_ms": plain,
             "walked_pairs": walked, "contrib_pairs": contrib,
             "iters": iters})
    out({"probe": "done"})
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--kp_instances", type=int, default=1_370_000)
    p.add_argument("--kp_iters", type=int, default=5)
    p.add_argument("--kp_data", default="",
                   help="a real list (npz: n, feats, start, stop)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ibgs_tpu_torch.bench import resolve_device
    run(args.kp_instances, args.kp_iters, args.kp_data,
        resolve_device(args.device),
        emit=lambda r: print(json.dumps(r), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
