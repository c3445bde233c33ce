"""Trace capture and its reduction, the benchmark's own copies of the
port's `utils/profiling` (the guarded profiler session, `device_events`)
and `scripts/parse_trace` (device time charged to the innermost
`ibgs_tpu_torch/` frame open on the host when the launch was issued).

`capture(fn, with_stack)` runs fn inside a guarded session and returns
the Chrome trace's events; `reduce(events)` gives the device's busy time,
its launches, the traced window, device time by kernel and by the stack
of repo files open at each launch, and the idle gaps by the host frame
that was open across them.  A layer's time is read from the stacks
(benchmark/layers.py): the hand kernels launch from `ops/_cuda.py`, the
binding module, inside the layer's frames, so the innermost repo frame
alone would charge them to the binding.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_WORK_CALL = re.compile(r"cu(da)?(Launch(Cooperative)?Kernel|Memcpy|Memset)")
REPO_FRAME = "ibgs_tpu_torch/"
# a session opens with a warm-up step whose events it drops and idles
# CLOCK_GUARD_S after it and before it closes: without both, sessions on an
# H100 lost device events (the bring-up measurements in PERF.md)
WARM_UP_LAUNCHES = 256
CLOCK_GUARD_S = 0.1
WINDOW_LABEL = "benchmark_window"


@contextlib.contextmanager
def _session(with_stack: bool):
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=with_stack,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        x = torch.zeros(1, device="cuda")
        for _ in range(WARM_UP_LAUNCHES):
            x.add_(1)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(CLOCK_GUARD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(CLOCK_GUARD_S)


def capture(fn, with_stack: bool = False) -> list:
    """The trace events of fn(), run inside a record_function label
    (WINDOW_LABEL) that marks the traced window.  The trace file goes to a
    temporary directory (under TMPDIR) and is deleted."""
    import torch

    with _session(with_stack) as prof:
        with torch.profiler.record_function(WINDOW_LABEL):
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def device_events(events: list):
    """The device events of a trace, and the correlation ids of host calls
    that enqueued device work but have no device event (lost work)."""
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    have = {e.get("args", {}).get("correlation") for e in dev}
    lost = [e["args"]["correlation"] for e in events
            if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
            and _WORK_CALL.match(e.get("name", ""))
            and "correlation" in e.get("args", {})
            and e["args"]["correlation"] not in have]
    return dev, lost


def _innermost(intervals: list, points: list, pick) -> dict:
    """For each (key, t) of `points`, the innermost of the properly nested
    `intervals` (ts, end, name) of one host thread open at t whose name
    satisfies `pick`."""
    found = {}
    order = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    starts = [iv[0] for iv in order]
    stack, i = [], 0
    for key, t in sorted(points, key=lambda p: p[1]):
        j = bisect.bisect_right(starts, t)
        while i < j:
            iv = order[i]
            while stack and stack[-1][1] <= iv[0]:
                stack.pop()
            stack.append(iv)
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        name = next((iv[2] for iv in reversed(stack)
                     if t < iv[1] and pick(iv[2])), None)
        if name is not None:
            found[key] = name
    return found


def _open_files(intervals: list, points: list) -> dict:
    """For each (key, t) of `points`, the repo files of the frames
    (ts, end, name) open at t, outermost first, each once."""
    found, active, i = {}, [], 0
    order = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    for key, t in sorted(points, key=lambda p: p[1]):
        while i < len(order) and order[i][0] <= t:
            active.append(order[i])
            i += 1
        active = [iv for iv in active if iv[1] > t]
        files = []
        for iv in active:
            f = repo_file(iv[2])
            if f not in files:
                files.append(f)
        found[key] = tuple(files)
    return found


def repo_file(frame: str) -> str:
    """'…/ibgs_tpu_torch/ops/blend.py(215): fn' → 'ops/blend.py'."""
    rest = frame[frame.rindex(REPO_FRAME) + len(REPO_FRAME):]
    return rest.split("(")[0]


def _merged(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: list, top: int = 10) -> dict:
    """busy_s (the time in which some device event ran: the union of
    their intervals), window_s (the WINDOW_LABEL range), launches (device
    events), lost (host launches with no device event), by_kernel [[name,
    s]], stacks [[repo files, device s]]: the device time of the launches
    made while those files' frames were open on the launching thread,
    outermost first (only where frames were recorded), and idle_gaps
    [[host frame, s]]: the idle time between merged device intervals
    inside the window, charged to the innermost Python frame (a repo frame
    where one is open) of the thread with the most frames at the gap's
    start."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_LABEL
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("trace: no window label")
    w0 = min(e["ts"] for e in win)
    w1 = max(e["ts"] + e.get("dur", 0.0) for e in win)
    dev, lost = device_events(events)
    dev = [e for e in dev if w0 <= e["ts"] <= w1]
    merged = _merged([(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in dev])
    busy = sum(e - s for s, e in merged)
    by_kernel = defaultdict(float)
    for e in dev:
        by_kernel[e["name"]] += e.get("dur", 0.0)

    launches, frames = {}, defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, thread = e.get("cat"), (e.get("pid"), e.get("tid"))
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (thread, e["ts"])
        elif cat == "python_function":
            frames[thread].append((e["ts"], e["ts"] + e.get("dur", 0.0),
                                   e["name"]))
    stacks = defaultdict(float)
    if frames:
        points = defaultdict(list)
        for i, e in enumerate(dev):
            hit = launches.get(e.get("args", {}).get("correlation"))
            if hit is not None:
                points[hit[0]].append((i, hit[1]))
        pooled = [iv for ivs in frames.values() for iv in ivs]
        for thread, pts in points.items():
            # a launching thread without recorded frames: every thread's
            repo = [iv for iv in frames.get(thread) or pooled
                    if REPO_FRAME in iv[2]]
            for i, files in _open_files(repo, pts).items():
                stacks[files] += dev[i].get("dur", 0.0)

    gaps = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    main = max(frames, key=lambda t: len(frames[t])) if frames else None
    spans = []
    for k in range(0, len(edges), 2):
        s, e = edges[k], edges[k + 1]
        if e > s:
            spans.append((k, s, e))
    names = {}
    if main is not None:
        names = _innermost(frames[main], [(k, s) for k, s, _ in spans],
                           lambda n: REPO_FRAME in n)
        rest = [(k, s) for k, s, _ in spans if k not in names]
        names.update(_innermost(frames[main], rest, lambda n: True))
    for k, s, e in spans:
        gaps[names.get(k, "no Python frame recorded")] += e - s

    def top_s(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
            "launches": len(dev), "lost": len(lost),
            "by_kernel": top_s(by_kernel),
            "stacks": [[list(k), v / 1e6] for k, v in stacks.items()],
            "idle_gaps": top_s(gaps)}
