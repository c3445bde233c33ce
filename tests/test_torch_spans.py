"""The port's layer spans and the rules that read them.

* One CPU train step and one `render_one` of a tiny random scene inside
  the port's own profiler session (`utils/profiling.trace`, Python frames
  on; the exposure correction on, so `exposure` opens inside `net`): the
  span tree is the layer table's (names, nesting, one top span a step or
  view), and every backward node of the fusion net and of the
  loss stack (its forward op launched from `models/aggregation.py` or
  `train/losses.py`, read from the frames) is charged through the
  sequence-number link to `net.bwd` or `objective.bwd`.
* With no session live, `annotate` never calls `record_function`.
* `benchmark/spans.py` on a hand-built trace with known answers (each
  device event charged once, a gap split across two spans, the autograd
  thread's launches followed to their forward spans, syncs counted); the
  port's `parse_trace` gives the same numbers on it; the readers of the
  span metrics read them, and nothing without a span reduction; and
  `benchmark/trace.py`'s `reduce` keeps its keys and agrees on the busy
  and idle time.
"""
import bisect
import json
from collections import defaultdict

import numpy as np
import pytest
import torch

from benchmark import spans as bspans
from benchmark import trace as btrace
from benchmark.metrics import (binning_idle_ms, net_ms, objective_idle_ms,
                               objective_ms, optimizer_ms, syncs)
from ibgs_tpu_torch import bench as tb
from ibgs_tpu_torch.config import OptimizationParams
from ibgs_tpu_torch.eval.render_driver import EvalRenderer
from ibgs_tpu_torch.models import aggregation
from ibgs_tpu_torch.ops.rasterize import RasterConfig
from ibgs_tpu_torch.scripts import parse_trace
from ibgs_tpu_torch.train import trainer
from ibgs_tpu_torch.utils import profiling
from tests.test_torch_slice import one_torch_thread  # noqa: F401

W, H, S = 32, 32, 4
ITERATION = 13000
# parent span of every span of a step or a view
PARENTS = {"render": {"train_step", "source_depths", "render_one"},
           "projection": {"render"}, "binning": {"render"},
           "blend": {"render"}, "epilogue": {"render"},
           "objective": {"train_step"}, "net": {"objective", "render_one"},
           "backward": {"train_step"}, "optimizer": {"train_step"},
           "source_depths": {"render_one"}, "exposure": {"net"}}


def _step_and_view():
    """A train step (geometry, aggregation) and a served view of a tiny
    random scene: (step, its arguments, renderer, its arguments)."""
    torch.manual_seed(0)
    model = tb.random_model(200, 512, "cpu")
    cam, src, gt = tb.make_inputs(np.random.default_rng(0), None, W, H,
                                  "cpu")
    net = aggregation.init_fusion_net(aggregation.ColorFusionResidualNet(8),
                                      torch.Generator().manual_seed(0))
    app = torch.zeros(trainer.APP_CAPACITY, 2)
    state = trainer.TrainState(
        model=model, app_ab=app, app_opt=trainer.SideOptState.init([app]),
        net=net, net_opt=trainer.SideOptState.init(list(net.parameters())),
        spatial_lr_scale=1.0)
    opt = OptimizationParams(enable_mix_precision=False,
                             enable_exposure_correction=True)
    rcfg = RasterConfig(buffer_len=4, staircase_cull=True)
    step = trainer.make_train_step(opt, rcfg, net,
                                   trainer.StepPhase(True, True))
    ev = EvalRenderer(model, net, src.images,
                      cam.view[None].repeat(S, 1, 1),
                      cam.cam_pos[None].repeat(S, 1), [cam] * S, opt, rcfg,
                      device="cpu")
    step_args = (state, cam, 0, gt, src, ITERATION, torch.zeros(3), False,
                 1.0, 1e-3)
    return step, step_args, ev, (cam, list(range(S)))


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    step, step_args, ev, view_args = _step_and_view()
    d = str(tmp_path_factory.mktemp("trace"))
    with profiling.trace(d, with_stack=True):
        step(*step_args)
        ev.render_one(*view_args)
    return parse_trace.load_events(d)


def _span_tree(events):
    """[(name, parent name or None)] of the spans, on one host thread."""
    sp = [e for e in events if e.get("ph") == "X"
          and e.get("cat") == "user_annotation"]
    assert len({(e["pid"], e["tid"]) for e in sp}) == 1
    sp.sort(key=lambda e: (e["ts"], -e["dur"]))
    out, stack = [], []
    for e in sp:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        assert not stack or (e["ts"] + e["dur"]
                             <= stack[-1]["ts"] + stack[-1]["dur"])
        out.append((e["name"], stack[-1]["name"] if stack else None))
        stack.append(e)
    return out


def test_span_tree_of_a_step_and_a_view(traced):
    tree = _span_tree(traced)
    tops = [n for n, up in tree if up is None]
    assert tops == [f"train_step#{ITERATION}", "render_one#1"]
    names = {n.split("#")[0] for n, _ in tree}
    assert names == set(PARENTS) | {"train_step", "render_one"}
    for name, up in tree:
        if up is not None:
            assert up.split("#")[0] in PARENTS[name], (name, up)
    # 1 render a step, S + 1 a view (the source depths and the view)
    assert sum(n == "render" for n, _ in tree) == 1 + S + 1
    assert sum(n == "binning" for n, _ in tree) == 2 * (1 + S + 1)
    assert sum(n == "net" for n, _ in tree) == 2
    assert sum(n == "exposure" for n, _ in tree) == 2


def test_backward_of_net_and_losses_resolves_to_their_spans(traced):
    """Each backward node whose forward op ran in models/aggregation.py or
    train/losses.py (the innermost repo frame at the op) is charged to
    net.bwd or objective.bwd."""
    sp = bspans.Spans(traced)
    frames = defaultdict(list)
    fwd = defaultdict(list)
    for e in traced:
        a = e.get("args", {})
        if e.get("ph") != "X":
            continue
        thread = (e["pid"], e["tid"])
        if e.get("cat") == "python_function":
            frames[thread].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif (e.get("cat") == "cpu_op" and "Sequence number" in a
              and not a.get("Fwd thread id")
              and not e["name"].startswith(bspans.BACKWARD_NODE)):
            fwd[a["Sequence number"]].append((e["ts"], thread))
    nodes = [e for e in traced if e.get("ph") == "X"
             and e.get("cat") == "cpu_op"
             and e["name"].startswith(bspans.BACKWARD_NODE)
             and "Sequence number" in e.get("args", {})]
    points = defaultdict(list)       # forward thread → [(node index, t)]
    for i, e in enumerate(nodes):
        ops = sorted(fwd[e["args"]["Sequence number"]])
        k = bisect.bisect_left(ops, (e["ts"],)) - 1
        assert k >= 0, e["name"]
        points[ops[k][1]].append((i, ops[k][0]))
    files = {}
    for thread, pts in points.items():
        files.update(parse_trace._innermost(
            frames[thread], pts, lambda n: parse_trace.REPO_FRAME in n))
    want = {"models/aggregation.py": "net.bwd",
            "train/losses.py": "objective.bwd"}
    seen = defaultdict(set)
    for i, e in enumerate(nodes):
        file = files.get(i, "").split(parse_trace.REPO_FRAME)[-1]
        file = file.split("(")[0]
        if file in want:
            label, unit = sp.label((e["pid"], e["tid"]), e["ts"])
            assert label == want[file], (e["name"], file)
            assert unit == f"train_step#{ITERATION}"
            seen[file].add(e["name"][len(bspans.BACKWARD_NODE):])
    assert {"ConvolutionBackward0", "ReluBackward0",
            "AddmmBackward0"} <= seen["models/aggregation.py"]
    assert {"ConstantPadNdBackward0", "MulBackward0",
            "AbsBackward0"} <= seen["train/losses.py"]


def test_annotate_off_never_calls_record_function(monkeypatch):
    step, step_args, ev, view_args = _step_and_view()

    def refuse(*a, **kw):
        raise AssertionError("record_function called with no session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.annotate("x") is profiling.annotate("y", 1)
    step(*step_args)
    ev.render_one(*view_args)
    assert ev.served == 1


def test_annotate_on_names_the_span(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("layer"):
            with profiling.annotate("unit", 7):
                torch.ones(4).sum()
    names = {e["name"] for e in parse_trace.load_events(str(tmp_path))
             if e.get("cat") == "user_annotation"}
    assert names == {"layer", "unit#7"}


# ------------------------------------------------------ the hand-built trace

def _x(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _hand_trace():
    """The main thread (tid 1) runs one step inside the benchmark's window
    label, inside the profiler's own step label (no unit: the window
    label's work stays outside the step); the autograd engine's thread
    (tid 2) runs two backward nodes
    linked to forward ops in `net` and `objective`, and an AccumulateGrad
    (no sequence number) that falls to `backward`; device events on
    stream 7.  The answers are in `WANT` (µs)."""
    node = bspans.BACKWARD_NODE
    launch = "cudaLaunchKernel"
    return [
        _x("user_annotation", "ProfilerStep#1", 0, 1200),
        _x("user_annotation", btrace.WINDOW_LABEL, 0, 1200),
        _x("user_annotation", "train_step#7", 10, 990),
        _x("user_annotation", "objective", 100, 300),
        _x("user_annotation", "net", 150, 100),
        _x("cpu_op", "aten::mm", 160, 20, **{"Sequence number": 10,
                                             "Fwd thread id": 0}),
        _x("cuda_runtime", launch, 170, 5, correlation=1),
        _x("cpu_op", "aten::mul", 300, 10, **{"Sequence number": 11,
                                              "Fwd thread id": 0}),
        _x("cuda_runtime", launch, 310, 5, correlation=2),
        _x("cuda_runtime", "cudaStreamSynchronize", 320, 5),
        _x("user_annotation", "backward", 500, 400),
        _x("cpu_op", node + "MulBackward0", 520, 40, tid=2,
           **{"Sequence number": 11, "Fwd thread id": 1}),
        _x("cuda_runtime", launch, 530, 5, tid=2, correlation=3),
        _x("cpu_op", node + "MmBackward0", 600, 50, tid=2,
           **{"Sequence number": 10, "Fwd thread id": 1}),
        _x("cuda_runtime", launch, 610, 5, tid=2, correlation=4),
        _x("cpu_op", node + "torch::autograd::AccumulateGrad", 700, 30,
           tid=2),
        _x("cuda_runtime", launch, 710, 5, tid=2, correlation=5),
        _x("user_annotation", "optimizer", 920, 70),
        _x("cuda_runtime", launch, 930, 5, correlation=7),
        _x("cuda_runtime", "cudaDeviceSynchronize", 995, 3),
        _x("cuda_runtime", "cudaMemcpyAsync", 1100, 5, correlation=6),
        _x("kernel", "gemm", 180, 50, pid=0, tid=7, correlation=1),
        _x("kernel", "mul", 330, 50, pid=0, tid=7, correlation=2),
        _x("kernel", "mul_bwd", 540, 40, pid=0, tid=7, correlation=3),
        _x("kernel", "gemm_bwd", 620, 80, pid=0, tid=7, correlation=4),
        _x("gpu_memset", "Memset", 720, 40, pid=0, tid=7, correlation=5),
        _x("kernel", "adam", 940, 20, pid=0, tid=7, correlation=7),
        _x("gpu_memcpy", "Memcpy DtoH", 1110, 10, pid=0, tid=7,
           correlation=6),
        {"ph": "M", "name": "process_name", "pid": 1, "args": {}},
    ]


# label: [device µs, idle µs, syncs, launches].  The gap [230, 330) splits
# at the end of `net`; [380, 540), ended by the autograd thread's launch,
# goes to `objective` and `train_step` (that thread idle, the main
# thread's spans), `backward`, then the linked `objective.bwd`.
WANT = {"net": [50, 30 + 20, 0, 1], "objective": [50, 50 + 80 + 20, 1, 1],
        "objective.bwd": [40, 20, 0, 1], "net.bwd": [80, 20, 0, 1],
        "backward": [40, 20 + 20 + 20 + 140, 0, 1],
        "optimizer": [20, 20 + 30, 0, 1],
        "train_step": [0, 90 + 100 + 20 + 10, 1, 0],
        btrace.WINDOW_LABEL: [10, 10 + 110 + 80, 0, 1]}


def _scaled(rows: dict) -> dict:
    return {k: [v[0] / 1e6, v[1] / 1e6, v[2], v[3]] for k, v in rows.items()}


def test_span_reduce_hand_built():
    events = _hand_trace()
    red = bspans.reduce(events, 0, 1200)
    assert red["units"] == 1
    assert set(red["spans"]) == set(WANT)
    for k, v in _scaled(WANT).items():
        assert red["spans"][k] == pytest.approx(v, abs=1e-12), k
    # every device event charged once; the gaps fill the window
    assert red["device_s"] == pytest.approx(290e-6, abs=1e-12)
    assert sum(v[0] for v in red["spans"].values()) == pytest.approx(
        red["device_s"], abs=1e-12)
    assert sum(v[3] for v in red["spans"].values()) == 7
    assert sum(v[1] for v in red["spans"].values()) == pytest.approx(
        910e-6, abs=1e-12)
    # inside the step: all but the window label's own
    assert red["in_units"] == pytest.approx([280e-6, 710e-6, 2, 6],
                                            abs=1e-12)
    # a window that leaves out the last copy: it is no longer charged
    cut = bspans.reduce(events, 0, 1050)
    assert cut["spans"][btrace.WINDOW_LABEL][0] == 0.0
    assert cut["device_s"] == pytest.approx(280e-6, abs=1e-12)


def test_parse_trace_spans_match_the_benchmark():
    events = _hand_trace()
    s = parse_trace.summarize(events, steps=1.0)
    red = bspans.reduce(events, 0, 1200)
    assert s["units"] == red["units"] == 1
    assert s["span_device_ms"] == pytest.approx(1e3 * red["device_s"])
    got = {r[0]: r[1:5] for r in s["spans"]}
    assert set(got) == set(red["spans"])
    for k, (d, i, n_sync, n_launch) in red["spans"].items():
        assert got[k] == pytest.approx([1e3 * d, 1e3 * i, n_sync, n_launch],
                                       abs=1e-12), k
    assert "objective.bwd" in parse_trace.report(s)


def test_span_readers():
    events = _hand_trace()
    red = bspans.reduce(events, 0, 1200)
    ctx = {"plain": {"spans": red}, "units": 2}
    assert net_ms.read(ctx) == pytest.approx((50 + 80) / 1e3 / 2)
    assert objective_ms.read(ctx) == pytest.approx((50 + 40) / 1e3 / 2)
    assert optimizer_ms.read(ctx) == pytest.approx(20 / 1e3 / 2)
    assert objective_idle_ms.read(ctx) == pytest.approx(170 / 1e3 / 2)
    assert syncs.read(ctx) == 1.0
    assert binning_idle_ms.read(ctx) is None          # no such span
    # a window without span reduction (the parent commit's): no reading
    bare = {"plain": {}, "units": 2}
    for m in (net_ms, objective_ms, optimizer_ms, objective_idle_ms,
              binning_idle_ms, syncs):
        assert m.read(bare) is None


def test_trace_reduce_keeps_its_keys_and_agrees():
    events = _hand_trace()
    before = json.dumps(events, sort_keys=True)
    out = btrace.reduce(events)
    red = bspans.reduce(events, 0, 1200)
    assert json.dumps(events, sort_keys=True) == before
    assert set(out) == {"busy_s", "window_s", "launches", "lost",
                        "by_kernel", "stacks", "idle_gaps"}
    assert out["launches"] == 7 and out["lost"] == 0
    assert out["busy_s"] == pytest.approx(red["device_s"], abs=1e-12)
    assert out["window_s"] - out["busy_s"] == pytest.approx(
        sum(v[1] for v in red["spans"].values()), abs=1e-12)
