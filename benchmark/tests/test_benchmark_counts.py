"""The layer counts against hand-worked numbers, and the trace reduction
(busy time, idle share, launches, attribution to repo files, idle gaps)
on a synthetic trace with known answers."""
from __future__ import annotations

import pytest

from benchmark import harness, layers, peaks
from benchmark import trace as tr

TRAIN = {"kind": "train", "P": 10, "K": 9, "W": 32, "H": 16, "Hs": 16,
         "Ws": 32, "B": 4, "S": 5, "visible": 3, "tiles": 1, "net_width": 32,
         "blends": [{"mode": "render_geo", "walked": 100, "n_inst": 20,
                     "pixels": 512, "contrib": 40}]}
SERVE = dict(TRAIN, kind="serve", blends=[
    {"mode": "depth_only", "walked": 50, "n_inst": 20, "pixels": 512}] * 4
    + [{"mode": "render_geo", "walked": 100, "n_inst": 20, "pixels": 512}])


def test_preprocess_counts():
    c = harness.roofline("preprocess").count(TRAIN)
    # forward: 10 rows x (390 + 7·9); backward: 10 x (970 + 16·9)
    assert c["ops"] == 10 * 453 + 10 * 1114
    # forward: (15 + 27)·4 + 1 in, 13·4 + 6·4 out per row, the camera;
    # backward: (14 + 27)·4 in and out, 12·4 of cotangents, the camera
    assert c["bytes"] == (10 * (169 + 76) + 140) + (10 * (328 + 48) + 140)
    s = harness.roofline("preprocess").count(SERVE)
    assert s["ops"] == 5 * 10 * 453 and s["bytes"] == 5 * (10 * 245 + 140)


def test_blend_counts():
    c = harness.roofline("blend").count(TRAIN)
    assert c["ops"] == 100 * 17 + 100 * 17 + 40 * 94
    fwd = 20 * 52 + 8 + 512 * (8 + 12) * 4
    bwd = 20 * 28 * 4 + 8 + 512 * (9 + 6 + 16) * 4
    assert c["bytes"] == fwd + bwd
    s = harness.roofline("blend").count(SERVE)
    assert s["ops"] == (4 * 50 + 100) * 17
    assert s["bytes"] == 5 * fwd


def test_warp_counts():
    hw, texels = 512, 5 * 512
    c = harness.roofline("warp").count(SERVE)
    fwd_ops = 4 * hw * 5 * 67 + 5 * hw * 46 + hw * 2
    fwd_bytes = 4 * (12 * hw + 4 * texels + 5 * 19) + 4 * hw * (8 + 9 * 5)
    assert c == {"ops": fwd_ops, "bytes": fwd_bytes}
    t = harness.roofline("warp").count(TRAIN)
    assert t["ops"] == fwd_ops + 4 * hw * 5 * 145
    assert t["bytes"] == fwd_bytes + 4 * (8 * hw + 3 * texels + 80 + 2 * hw
                                          + hw * 16 + 8 * hw)


def test_net_counts():
    net = harness.roofline("net")
    # d = 32, hourglass 38, at 8x8 with 3 views
    h, full, half, quarter = 38, 64, 16, 4
    convs = (h * h * 9 * full + h * 19 * 9 * half + 19 * 9 * 9 * quarter
             + 9 * 19 * 9 * half + 38 * 19 * 9 * half + 19 * h * 9 * full
             + 2 * h * h * 9 * full + 2 * h * h * full + h * 3 * full)
    dense = (7 * 32 + 32 * 32) * 3 * full
    assert net.forward_ops(32, 8, 8, 3) == 2 * (convs + dense)
    work = dict(TRAIN, H=8, W=8)
    assert net.count(work) == {"ops_bf16": 3 * 2 * (convs + dense)}
    assert net.count(dict(work, kind="serve")) == {
        "ops_bf16": 2 * (convs + dense)}


def test_bound_and_ops_time():
    w = {"ops": 67e12, "ops_bf16": 989e12, "bytes": 3.35e12}
    assert peaks.ops_s(w) == pytest.approx(2.0)
    assert peaks.bound_s(w) == pytest.approx(2.0)
    assert peaks.bound_s({"bytes": 6.7e12}) == pytest.approx(2.0)


def _x(name, cat, ts, dur, **args):
    """A trace event; the Python frames carry another thread id than the
    launches, so the frames of every thread stand in."""
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 123 if cat == "python_function" else 7,
            "args": args}


def synthetic_trace():
    """A 1000 us window inside ops/rasterize.py (40-740 us): two launches
    from ops/blend.py through the binding ops/_cuda.py (kernels at 100-300
    and 250-400 us), one from ops/binning.py inside a helper of
    ops/preprocess.py (600-700 us) and one from outside the repo (800-850
    us)."""
    frame = "/x/ibgs_tpu_torch/ops/{}.py(10): f"
    ev = [_x(tr.WINDOW_LABEL, "user_annotation", 0, 1000),
          _x(frame.format("rasterize"), "python_function", 40, 700),
          _x(frame.format("blend"), "python_function", 50, 100),
          _x(frame.format("_cuda"), "python_function", 55, 30),
          _x(frame.format("binning"), "python_function", 500, 100),
          _x(frame.format("preprocess"), "python_function", 540, 20),
          _x("/x/benchmark/drivers/train.py(3): step", "python_function",
             0, 1000),
          _x("cudaLaunchKernel", "cuda_runtime", 60, 5, correlation=1),
          _x("cudaLaunchKernel", "cuda_runtime", 70, 5, correlation=2),
          _x("cudaLaunchKernel", "cuda_runtime", 550, 5, correlation=3),
          _x("cudaLaunchKernel", "cuda_runtime", 790, 5, correlation=4),
          _x("k_blend_a", "kernel", 100, 200, correlation=1),
          _x("k_blend_b", "kernel", 250, 150, correlation=2),
          _x("k_bin", "kernel", 600, 100, correlation=3),
          _x("k_other", "kernel", 800, 50, correlation=4)]
    return ev


def test_reduce_busy_idle_and_attribution():
    r = tr.reduce(synthetic_trace())
    assert r["window_s"] == pytest.approx(1000e-6)
    # the union of the kernels' intervals: 100-400, 600-700, 800-850
    assert r["busy_s"] == pytest.approx(450e-6)
    assert r["launches"] == 4 and r["lost"] == 0
    stacks = {tuple(k): v for k, v in r["stacks"]}
    assert stacks == pytest.approx({
        ("ops/rasterize.py", "ops/blend.py", "ops/_cuda.py"): 350e-6,
        ("ops/rasterize.py", "ops/binning.py", "ops/preprocess.py"): 100e-6,
        (): 50e-6})
    # idle: 0-100 (the driver's frame open at 0), 400-600 and 700-800
    # (rasterize.py the innermost repo frame), 850-1000 (the driver's)
    gaps = dict((k, v) for k, v in r["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(550e-6)
    assert gaps == pytest.approx({
        "/x/benchmark/drivers/train.py(3): step": 250e-6,
        "/x/ibgs_tpu_torch/ops/rasterize.py(10): f": 300e-6})
    ctx = {"plain": r, "stacked": r, "units": 2, "wall_s": 1e-3,
           "work": {"blend": {"bytes": 3.35e12 * 35e-6}}}
    assert harness.metric_reader("idle_share.train").read(ctx) == \
        pytest.approx(55.0)
    assert harness.metric_reader("launches.serve").read(ctx) == 2
    # the binning launch stays with binning, not the preprocess helper
    assert harness.metric_reader("binning_ms.train").read(ctx) == \
        pytest.approx(0.05)
    assert layers.device_s(ctx, "preprocess") is None
    # blend: 175 us per unit, bound 35 us → 20%
    assert layers.roofline_share(ctx, "blend") == pytest.approx(20.0)
    assert harness.metric_reader("warp_roofline.train").read(ctx) is None


def test_lost_launch_is_counted():
    ev = synthetic_trace() + [
        _x("cudaLaunchKernel", "cuda_runtime", 900, 5, correlation=9)]
    assert tr.reduce(ev)["lost"] == 1


def test_mfu_reads_ops_over_wall():
    ctx = {"work": {"net": {"ops_bf16": 989e12 * 1e-3},
                    "blend": {"ops": 67e12 * 1e-3, "bytes": 1.0}},
           "wall_s": 0.1}
    assert harness.metric_reader("mfu.train").read(ctx) == \
        pytest.approx(2.0)
