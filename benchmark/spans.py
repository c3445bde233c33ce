"""Device time, idle time, host syncs and launches by the port's layer
spans: the benchmark's copy of the rules of the port's
`scripts/parse_trace.py` (the span tables), as `trace.py` copies its
session and frame rules.

A span is a `record_function` range (`user_annotation` in the Chrome
trace) that the port opens at a layer boundary (`utils/profiling.annotate`):
`render`, `projection`, `binning`, `blend`, `epilogue`, `net`,
`objective`, `backward`, `optimizer`, `source_depths`, inside the top span
of one unit, `train_step#<iteration>` or `render_one#<n>`.  The rules:

* a device event is charged once, to the innermost span open on the host
  thread that launched it, when the launch was issued (matched by the
  trace's correlation ids).  A launch inside an
  `autograd::engine::evaluate_function` event is first followed to the
  forward op with the same `Sequence number` (the latest one before the
  backward node ran) and charged to the span open around that op, under
  its `.bwd` half.  A launch that neither finds (the engine's own work on
  its thread) goes to the innermost span open at that time on the thread
  that holds the most spans (`backward`, around `torch.autograd.grad`);
  one with no span at all to NO_SPAN;
* an idle gap (between merged device intervals inside the window) is
  split in time across the labels the same rules give, on the thread that
  launched the device event that ends the gap (the thread with the most
  spans for the window's last gap): what the host was doing while the
  card waited;
* a blocking host call (SYNC_CALLS) is charged like a launch.

`reduce(events, w0, w1)` gives, over the window [w0, w1] (µs, the trace's
clock): `device_s` (the summed device-event time), `units` (the top spans
seen), `spans` {label: [device s, idle s, syncs, launches]} (totals, the
labels' device seconds adding up to `device_s`) and `in_units` (the same
four numbers for what was charged inside a top span).  The benchmark's
window label is a span too: it holds the work done between units (the
failure count).  `per_unit` is what the span metrics' readers in
`metrics/` read from a traced run's record; `trace.reduce` does not call
`reduce` yet (PERF.md §7), so at present they find nothing and read
None.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"
BACKWARD_NODE = "autograd::engine::evaluate_function: "
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
BWD = ".bwd"
NO_SPAN = "(no span)"
# the profiler's own step label, `ProfilerStep#<n>`, is no unit of work
PROFILER_STEP = "ProfilerStep#"


def _is_unit(name: str) -> bool:
    """A top span: `name#id`, not the profiler's own step label."""
    return "#" in name and not name.startswith(PROFILER_STEP)


class _Thread:
    """The spans and backward nodes of one host thread as nested
    intervals: `innermost(t)` is the index of the innermost one open at t
    (-1 for none), `parent[i]` the one around interval i."""

    def __init__(self, intervals: list):
        # (ts, end, kind, name or sequence number)
        self.ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
        self.parent, self.unit = [], []
        times, tops, stack = [], [], []

        def close_until(t):
            while stack and self.ivs[stack[-1]][1] <= t:
                j = stack.pop()
                times.append(self.ivs[j][1])
                tops.append(stack[-1] if stack else -1)

        for i, (s, _e, kind, name) in enumerate(self.ivs):
            close_until(s)
            up = stack[-1] if stack else -1
            self.parent.append(up)
            outer = self.unit[up] if up >= 0 else None
            self.unit.append(outer or (name if kind == "span"
                                       and _is_unit(name) else None))
            stack.append(i)
            times.append(s)
            tops.append(i)
        close_until(float("inf"))
        self.times, self.tops = times, tops

    def innermost(self, t: float) -> int:
        k = bisect.bisect_right(self.times, t) - 1
        return self.tops[k] if k >= 0 else -1

    def cuts(self, s: float, e: float) -> list:
        """The times in (s, e) at which the innermost interval changes."""
        return self.times[bisect.bisect_right(self.times, s):
                          bisect.bisect_left(self.times, e)]


class Spans:
    """The spans of a trace's host threads and the forward ops of its
    autograd graph, by sequence number; `label(thread, t)` is the
    (label, top span) a host call on `thread` at t is charged to, or
    None."""

    def __init__(self, events: list):
        ivs, fwd = defaultdict(list), defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            thread, a = (e.get("pid"), e.get("tid")), e.get("args", {})
            end = e["ts"] + e.get("dur", 0.0)
            name, seq = e.get("name", ""), a.get("Sequence number")
            if e.get("cat") == SPAN_CAT:
                ivs[thread].append((e["ts"], end, "span", name))
            elif e.get("cat") != "cpu_op" or seq is None:
                continue
            elif name.startswith(BACKWARD_NODE):
                ivs[thread].append((e["ts"], end, "bwd", seq))
            elif not a.get("Fwd thread id"):
                fwd[seq].append((e["ts"], thread))
        self.threads = {t: _Thread(v) for t, v in ivs.items()}
        counts = {t: sum(iv[2] == "span" for iv in th.ivs)
                  for t, th in self.threads.items()}
        self.main = max(counts, key=counts.get) if any(
            counts.values()) else None
        # sequence numbers count per thread: a forward op is looked for on
        # the threads that open spans (not the autograd engine's)
        self.fwd = {k: sorted(op for op in v if counts.get(op[1]))
                    for k, v in fwd.items()}

    def _forward(self, seq, before: float):
        """(ts, thread) of the latest forward op with sequence number
        `seq` that started before `before`, or None."""
        ops = self.fwd.get(seq)
        if not ops:
            return None
        k = bisect.bisect_left(ops, (before,)) - 1
        return ops[k] if k >= 0 else None

    def label(self, thread, t: float):
        th = self.threads.get(thread)
        i = th.innermost(t) if th is not None else -1
        while i >= 0:
            s, _e, kind, name = th.ivs[i]
            if kind == "span":
                return name.split("#")[0], th.unit[i]
            op = self._forward(name, s)
            if op is not None:
                lab = self.label(op[1], op[0])
                if lab is not None:
                    # a graph run inside a backward (the CPU projection's
                    # autograd) stays in that span's .bwd half
                    return lab[0].removesuffix(BWD) + BWD, lab[1]
            i = th.parent[i]
        if thread != self.main and self.main is not None:
            return self.label(self.main, t)
        return None

    def cuts(self, thread, s: float, e: float) -> list:
        out = []
        for t in {thread, self.main}:
            if t in self.threads:
                out += self.threads[t].cuts(s, e)
        return sorted(set(out))


def _merged(dev: list) -> list:
    """[start, end, first device event] of the merged device intervals."""
    out = []
    for e in sorted(dev, key=lambda e: e["ts"]):
        s, end = e["ts"], e["ts"] + e.get("dur", 0.0)
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([s, end, e])
    return out


def reduce(events: list, w0: float, w1: float) -> dict:
    """The window's device time, idle time, syncs and launches by span
    label (module docstring)."""
    sp = Spans(events)
    launches, syncs = {}, []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in LAUNCH_CATS:
            continue
        thread = (e.get("pid"), e.get("tid"))
        if "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (thread, e["ts"])
        if e.get("name") in SYNC_CALLS and w0 <= e["ts"] <= w1:
            syncs.append((thread, e["ts"]))
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and w0 <= e["ts"] <= w1]

    acc = defaultdict(lambda: [0.0, 0.0, 0, 0])
    in_units = [0.0, 0.0, 0, 0]

    def charge(lab, col, v):
        name, unit = lab if lab is not None else (NO_SPAN, None)
        acc[name][col] += v
        if unit is not None:
            in_units[col] += v

    for e in dev:
        hit = launches.get(e.get("args", {}).get("correlation"))
        lab = sp.label(*hit) if hit is not None else None
        charge(lab, 0, e.get("dur", 0.0) / 1e6)
        charge(lab, 3, 1)
    for thread, t in syncs:
        charge(sp.label(thread, t), 2, 1)

    merged = _merged(dev)
    edges = [(w0, None)] + [x for s, end, first in merged
                            for x in ((s, first), (end, None))] + [(w1, None)]
    for k in range(0, len(edges), 2):
        (s, _), (e, first) = edges[k], edges[k + 1]
        if e <= s:
            continue
        hit = (launches.get(first.get("args", {}).get("correlation"))
               if first is not None else None)
        thread = hit[0] if hit is not None else sp.main
        pts = [s] + sp.cuts(thread, s, e) + [e]
        for a, b in zip(pts, pts[1:]):
            charge(sp.label(thread, 0.5 * (a + b)), 1, (b - a) / 1e6)

    units = {iv[3] for t in sp.threads.values() for iv in t.ivs
             if iv[2] == "span" and _is_unit(iv[3]) and w0 <= iv[0] <= w1}
    return {"device_s": sum(e.get("dur", 0.0) for e in dev) / 1e6,
            "units": len(units), "spans": dict(acc), "in_units": in_units}


def per_unit(ctx: dict, labels: tuple, col: int, scale: float = 1.0):
    """Column `col` (0 device s, 1 idle s, 2 syncs, 3 launches) of
    `labels`' totals in the traced window without Python stacks, per step
    or view, times `scale`; None where that window has no span reduction
    or none of the labels."""
    red = ctx["plain"].get("spans")
    rows = [red["spans"][k] for k in labels if k in red["spans"]] \
        if red else []
    if not rows:
        return None
    return scale * sum(r[col] for r in rows) / ctx["units"]
