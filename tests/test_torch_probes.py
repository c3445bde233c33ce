"""The port's measurement probes (`ibgs_tpu_torch/scripts/kernel_probe`,
`perf_probe`, `parse_trace`, `gsp_tax`, `gsp_scaling`) on the CPU, against
the JAX package where it computes the same thing.

* kernel_probe: its synthetic list (6,120 instances, 3 per tile) through
  the port's plain blend over the whole 960x544 grid and through JAX's
  oracle blend over the first two rows of tiles: floats within 1e-5
  (abs and relative), integers exactly; `run` prints both probes with a
  finite time and a positive bound;
* perf_probe: all six stages print with a finite time;
* parse_trace: exact totals, categories, kernels, labels and repo frames
  on a hand-built Chrome trace; host launches with no device event
  counted as lost; and a run on a trace that `utils/profiling.trace`
  wrote around a small CPU render;
* profiling.idle_share: the share as read, with an error where the busy
  time exceeds the wall time;
* gsp_scaling: the rows at gs 1 and 2 (gloo ranks) equal JAX's
  `gsp_render` rows on the 8-virtual-device mesh: the integers exactly,
  both `exact`;
* gsp_tax: the unsharded step and the step on a 1 x 1 mesh give the same
  first loss (within 1e-6 relative);
* warp_probe: each variant's source is the port's csrc/warp.cu with only
  its table format, CTA width and register cap changed (the kernels
  themselves build and run on the card only).
"""
import dataclasses
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.ops import blend_oracle as jbo
from ibgs_tpu.ops.blend_common import BlendConfig as JBlendConfig
from ibgs_tpu.ops.blend_common import Instances
from ibgs_tpu_torch.ops import blend
from ibgs_tpu_torch.ops import _cuda
from ibgs_tpu_torch.scripts import (gsp_scaling, gsp_tax, kernel_probe,
                                    parse_trace, perf_probe, warp_probe)
from ibgs_tpu_torch.utils import profiling
from tests.test_torch_slice import one_torch_thread  # noqa: F401

FIELDS = ("color", "normal", "final_t", "n_contrib", "buf_depth",
          "buf_weight", "buf_contrib")


@dataclasses.dataclass
class _Bins:
    tile_start: object
    tile_stop: object


def test_kernel_probe_list_plain_matches_oracle():
    pl = kernel_probe.probe_list(6120, device="cpu")
    cfg = kernel_probe.config()
    got = blend.blend_plain(*pl.args(cfg))
    top = pl.rows(2)                  # the first 2 rows of 60 tiles
    m = int(top.stop[-1])
    f = jnp.asarray(pl.feats[:m].numpy())
    inst = Instances(mean2d=f[:, 0:2], conic=f[:, 2:5], opacity=f[:, 5],
                     rgb=f[:, 6:9], normal=f[:, 9:12], dist=f[:, 12])
    jcfg = JBlendConfig(tile_h=16, tile_w=16, buffer_len=4, render_geo=True,
                        depth_only=False)
    want = jbo.blend_oracle(
        inst, _Bins(jnp.asarray(top.start.numpy()),
                    jnp.asarray(top.stop.numpy())), top.Wp, top.Hp,
        kernel_probe.FX, kernel_probe.FY, kernel_probe.W / 2,
        kernel_probe.H / 2, jcfg)
    assert m == 2 * 60 * 3
    for k in FIELDS:
        a = getattr(got, k)[:top.Hp].numpy()
        b = np.asarray(getattr(want, k))
        if b.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    assert int(got.n_contrib.sum()) > 0


def test_kernel_probe_runs_on_the_cpu():
    recs = {r["probe"]: r for r in kernel_probe.run(4080, iters=1,
                                                    device="cpu")}
    assert set(recs) == {"device", "blend_fwd", "blend_fwd_bwd", "done"}
    for k in ("blend_fwd", "blend_fwd_bwd"):
        r = recs[k]
        assert np.isfinite(r["ms"]) and r["bound_ms"] > 0
        assert r["walked_pairs"] >= r["contrib_pairs"] > 0
    assert recs["blend_fwd_bwd"]["bound_ms"] > recs["blend_fwd"]["bound_ms"]


def test_perf_probe_prints_every_stage(capsys):
    perf_probe.main(["--device", "cpu", "--width", "64", "--height", "32",
                     "--n", "1000", "--iters", "1"])
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    stages = [r for r in recs if r["probe"].startswith("stage_")]
    assert [r["probe"] for r in stages] == list(perf_probe.STAGES)
    assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in stages)
    assert all(r["device_busy_ms"] is None for r in stages)
    assert recs[0]["probe"] == "scene" and recs[0]["n_instances"] > 0


def _hand_trace():
    """Host thread 1 launches four device events inside the label "step";
    the first inside a repo frame (with a non-repo frame inside it)."""
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
                "ts": ts, "dur": dur, "args": args}
    blend_frame = "ibgs_tpu_torch/ops/blend.py(210): blend_fwd_cuda"
    return [
        x("user_annotation", "step", 0, 1000),
        x("python_function", blend_frame, 100, 200),
        x("python_function", "torch/x.py(1): f", 150, 100),
        x("cuda_runtime", "cudaLaunchKernel", 200, 5, correlation=1),
        x("kernel", "blend_fwd_kernel", 210, 50, tid=7, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 500, 5, correlation=2),
        x("kernel", "elementwise", 510, 20, tid=7, correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 600, 5, correlation=3),
        x("kernel", "elementwise", 610, 30, tid=7, correlation=3),
        x("cuda_runtime", "cudaMemcpyAsync", 700, 5, correlation=4),
        x("gpu_memcpy", "Memcpy DtoH", 710, 5, tid=7, correlation=4),
        x("gpu_memset", "Memset", 2000, 1, tid=7, correlation=5),
        x("gpu_user_annotation", "step", 0, 900, tid=7),
        x("user_annotation", "idle", 3000, 400),
        {"ph": "M", "name": "process_name", "pid": 1, "args": {}},
    ]


def test_parse_trace_hand_built(tmp_path, capsys):
    s = parse_trace.summarize(_hand_trace(), steps=2.0)
    assert s["device_events"] == 5 and s["lost_launches"] == 0
    assert s["device_ms"] == 0.106 / 2
    assert s["by_category"] == {"kernel": 0.05, "memcpy": 0.0025,
                                "memset": 0.0005}
    assert s["kernels"] == [["blend_fwd_kernel", 0.025, 1],
                            ["elementwise", 0.025, 2]]
    # spans over [0, 3400] µs: the memset has no launch (no span); the
    # gap before it splits at the end of "step"
    assert s["units"] == 0 and s["span_device_ms"] == pytest.approx(0.053)
    want = [["(no span)", 0.001, 1.999, 0, 1, 0.0, 0],
            ["step", 0.105, 0.895, 0, 4, 1.0, 1],
            ["idle", 0.0, 0.4, 0, 0, 0.4, 1]]
    assert [r[0] for r in s["spans"]] == [w[0] for w in want]
    for got, w in zip(s["spans"], want):
        assert got[3:5] == w[3:5] and got[6] == w[6]
        assert got[1:3] + [got[5]] == pytest.approx(
            [x / 2 for x in w[1:3] + [w[5]]], abs=1e-12)
    assert s["sources"] == [
        ["?", 0.056 / 2, 4],
        ["ibgs_tpu_torch/ops/blend.py(210): blend_fwd_cuda", 0.025, 1]]
    path = tmp_path / "t" / "trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps({"traceEvents": _hand_trace()}))
    assert parse_trace.main([str(tmp_path), "5", "2"]) == 0
    out = capsys.readouterr().out
    assert "total device self time: 0.053 ms (5 device events)" in out
    assert "blend_fwd_kernel" in out and "step" in out


def test_a_lost_device_event_is_counted(capsys):
    """A host launch whose kernel the profiler lost makes the trace
    incomplete; calls that enqueue no device work never do."""
    def x(cat, name, corr):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
                "ts": corr, "dur": 1, "args": {"correlation": corr}}
    events = _hand_trace() + [
        x("cuda_runtime", "cudaLaunchKernel", 9),
        x("cuda_driver", "cuLaunchKernel", 10),
        x("kernel", "triton_kernel", 10),
        x("cuda_runtime", "cudaStreamSynchronize", 11),
        x("cuda_runtime", "cudaLaunchHostFunc", 12),
        x("cuda_runtime", "cudaMemsetAsync", 13)]
    dev, lost = profiling.device_events(events)
    assert len(dev) == 6 and lost == [9, 13]
    s = parse_trace.summarize(events)
    assert s["lost_launches"] == 2 and s["device_events"] == 6
    print(parse_trace.report(s))
    assert "INCOMPLETE: 2 host launches" in capsys.readouterr().out


def test_idle_share_is_not_clamped():
    ok = profiling.idle_share({"device_busy_ms": 3.0}, 4.0)
    assert ok["idle_share"] == 0.25 and "error" not in ok
    bad = profiling.idle_share({"device_busy_ms": 6.0}, 4.0)
    assert bad["idle_share"] == -0.5 and "exceeds the wall" in bad["error"]
    none = profiling.idle_share({"error": "no CUDA device"}, 4.0)
    assert none["idle_share"] is None and none["error"] == "no CUDA device"


def test_parse_trace_reads_a_profiling_trace(tmp_path):
    from ibgs_tpu_torch import bench as tb
    from ibgs_tpu_torch.ops.rasterize import RasterConfig

    model = tb.random_model(300, 1024, "cpu")
    cam, src, gt = tb.make_inputs(np.random.default_rng(0), None, 64, 32,
                                  "cpu")
    with profiling.trace(str(tmp_path), with_stack=True):
        with profiling.annotate("bench_chain"):
            tb.chain(model, cam, RasterConfig(staircase_cull=True), src, gt,
                     1, "render")
    s = parse_trace.summarize(parse_trace.load_events(str(tmp_path)))
    assert s["device_ms"] == 0.0 and s["device_events"] == 0
    spans = {x[0]: x[1:] for x in s["spans"]}
    layers = {"render", "projection", "binning", "blend", "epilogue"}
    assert set(spans) == {"bench_chain", "bench_step", *layers}
    # host ms and times opened; each label's idle ms (no device: all of
    # the window) is the host time no span inside it claims
    assert spans["bench_chain"][4] >= spans["bench_step"][4] > 0
    assert spans["bench_chain"][5] == spans["bench_step"][5] == 1
    # one forward render: each layer once, binning twice (bin_splats and
    # pack_rows), no backward half
    assert all(spans[n][5] == 1 for n in layers - {"binning"})
    assert spans["binning"][5] == 2
    assert sum(r[1] for r in spans.values()) == pytest.approx(
        spans["bench_chain"][4], rel=1e-6)


def _jax_scaling_rows(sizes):
    """scripts/gsp_scaling.py's rows (:23-84) at the given mesh sizes."""
    from ibgs_tpu.models.gaussians import init_from_points
    from ibgs_tpu.ops import preprocess as pp
    from ibgs_tpu.ops.rasterize import RasterConfig
    from ibgs_tpu.parallel.gsp import gsp_render
    from ibgs_tpu.parallel.sharding import make_mesh
    from ibgs_tpu.renderer import render_view
    from tests.utils import simple_camera

    W, H, n = 64, 128, 2000
    rng = np.random.default_rng(0)
    pts = (rng.random((n, 3)) * 1.2 - 0.6).astype(np.float32)
    model = init_from_points(pts, rng.random((n, 3)).astype(np.float32),
                             max_sh_degree=1, capacity=2048)
    cam = simple_camera(W, H)
    cfg = RasterConfig(instance_cap=65536, backend="oracle")
    ref, _ = render_view(model, cam, cfg, jnp.zeros(3), render_geo=False,
                         return_depth_normal=False)
    nw, off = model.oriented_normal(cam.cam_pos, learnt=True)
    sp = pp.preprocess(model.params.xyz, model.scale, model.quat_unit,
                       model.opacity, model.sh_coeffs,
                       model.active_sh_degree, nw, off, cam, cfg.tile_h,
                       cfg.tile_w, alive=model.alive)
    total = int(jnp.where(sp.n_tiles > 0, sp.n_tiles, 0).sum())
    rows = []
    for gs in sizes:
        mesh = make_mesh(1, gs, axis_names=("dp", "gs"))
        img, ovf = gsp_render(model, cam, cfg, mesh,
                              cap_local=-(-65536 // gs),
                              exchange_cap=-(-65536 // (gs * gs)),
                              bg=jnp.zeros(3))
        err = float(np.abs(np.asarray(img) - np.asarray(ref.render)).max())
        rows.append({"gs": gs, "gaussians_per_device": model.capacity // gs,
                     "instances_binned_per_device_cap": -(-65536 // gs),
                     "exchange_rows_per_pair_cap": -(-65536 // (gs * gs)),
                     "total_scene_instances": total, "overflow": int(ovf),
                     "exact": bool(err < 1e-5)})
    return rows


def test_gsp_scaling_rows_match_jax(tmp_path):
    got = gsp_scaling.sweep((1, 2), "cpu", workdir=str(tmp_path))
    want = _jax_scaling_rows((1, 2))
    for g, w in zip(got, want):
        assert {k: g[k] for k in w} == w
        assert w["exact"] and g["max_err_vs_replicated"] < 1e-5


def test_gsp_tax_variants_agree():
    args = gsp_tax.build_parser().parse_args(
        ["--device", "cpu", "--width", "64", "--height", "32", "--n", "1000",
         "--capacity", "2048", "--iters", "1", "--repeats", "1"])
    recs = gsp_tax.run(args)
    u, g, tax = recs
    assert (u["variant"], g["variant"]) == ("unsharded", "gsp_1x1")
    np.testing.assert_allclose(g["loss"], u["loss"], rtol=1e-6)
    assert np.isfinite(u["loss"]) and np.isfinite(tax["tax_ms"])
    assert not torch.distributed.is_initialized()


def test_gsp_tax_profile_writes_a_trace(tmp_path):
    args = gsp_tax.build_parser().parse_args(
        ["--device", "cpu", "--width", "64", "--height", "32", "--n", "500",
         "--capacity", "1024", "--iters", "1", "--repeats", "1",
         "--profile", str(tmp_path)])
    recs = gsp_tax.run(args)
    assert recs[-1] == {"profile": str(tmp_path), "chain_iters": 1}
    s = parse_trace.summarize(parse_trace.load_events(str(tmp_path)))
    assert s["device_events"] == 0


@pytest.mark.parametrize("table,tile_w,min_ctas", warp_probe.VARIANTS)
def test_warp_probe_variant_sources(table, tile_w, min_ctas):
    """A warp_probe variant's source differs from csrc/warp.cu in its CTA
    width, register cap and, for one word per texel, the three places of
    the table format: TABLE_WORDS, `fetch`'s loads and the pack's store;
    the port's own variant is the source unchanged."""
    port = _cuda.SOURCES["warp"].read_text()
    src = warp_probe.variant_source(table, tile_w, min_ctas)
    if (table, tile_w, min_ctas) == warp_probe.PORT:
        assert src == port
    assert f"constexpr int TILE_W = {tile_w};" in src
    assert f"constexpr int MIN_CTAS = {min_ctas};" in src
    words = 4 if table == "rows" else 1
    assert f"constexpr int TABLE_WORDS = {words};" in src
    fetch = src[src.index("Foot fetch("):src.index("float channel(")]
    assert ("const int4 r = __ldg" in fetch) == (table == "rows")
    assert fetch.count("__ldg(") == (1 if table == "rows" else 4)
    pack = src[src.index("rgb10_pack_kernel(const float*"):]
    assert ("reinterpret_cast<int4*>(out)[i]" in pack) == (table == "rows")
    changed = {"TILE_W", "MIN_CTAS", "TABLE_WORDS"}
    strip = lambda t: [ln for ln in t.splitlines()
                       if not any(re.search(rf"constexpr int {c} = ", ln)
                                  for c in changed)]
    if table == "rows":
        assert strip(src) == strip(port)
    else:
        # the other definitions are the port's, line for line
        cut = lambda t: t[t.index("__device__ __forceinline__ float "
                                  "channel("):
                          t.index("__global__ void __launch_bounds__("
                                  "THREADS)\n    rgb10_pack_kernel")]
        assert cut(src) == cut(port)
