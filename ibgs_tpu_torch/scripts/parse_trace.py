"""Tabulate a torch.profiler Chrome trace (counterpart of
scripts/parse_trace.py, which reads an xplane.pb).

    python -m ibgs_tpu_torch.scripts.parse_trace TRACE [top_n] [steps]

TRACE is a trace.json that `utils/profiling.trace` (the training loop's
`--profile_from_iter` window, `bench --profile`, `gsp_tax --profile`)
wrote, or a directory holding some (the newest is read).  It prints the
card's total self time (kernels, copies and sets), that time by category,
the top_n (default 40) kernels with their counts, the top_n spans, and
the top_n Python functions of the repo that launched the device work.
Host launches are matched to device events by the trace's correlation
ids.

Spans (`utils/profiling.annotate`: `train_step#<iteration>`,
`render_one#<n>`, and the layers inside them) are read by the rules of
`span_reduce`: a device event is charged once, to the innermost span open
on its launching thread; a launch made by the autograd backward
(inside an `autograd::engine::evaluate_function` event) goes to the span
that ran the forward op with the same `Sequence number`, under its
`.bwd` half; what neither finds goes to the innermost span then open on
the thread with the most spans (`backward`).  The card's idle gaps are
split in time across the same labels on the thread that launched the
device event ending each gap, and blocking host calls (`SYNC_CALLS`) are
counted where they were made.  The frames are charged to the innermost
repo frame open at the launch; they exist only in a trace taken
`with_stack=True`.  Every time is divided by `steps` (e.g. the chain
length of a bench trace); counts are not.  Host launches whose device
event the profiler lost are counted and flagged: such a trace
undercounts.  `benchmark/spans.py` keeps the benchmark's copy of the span
rules.
"""
from __future__ import annotations

import bisect
import json
import os
import sys
from collections import defaultdict

from ibgs_tpu_torch.utils.profiling import (DEVICE_CATS, LAUNCH_CATS,
                                            device_events, trace_files)

CATEGORIES = dict(zip(DEVICE_CATS, ("kernel", "memcpy", "memset")))
REPO_FRAME = "ibgs_tpu_torch/"
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


def _merged_groups(dev: list) -> list:
    """[start, end, first device event] of the merged device intervals."""
    out = []
    for e in sorted(dev, key=lambda e: e["ts"]):
        s, end = e["ts"], e["ts"] + e.get("dur", 0.0)
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([s, end, e])
    return out


def span_reduce(events: list, w0: float, w1: float) -> dict:
    """The window's device time, idle time, syncs and launches by span
    label (module docstring): `device_s`, `units` (the top spans seen),
    `spans` {label: [device s, idle s, syncs, launches]} and `in_units`
    (the same four for what was charged inside a top span)."""
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

    merged = _merged_groups(dev)
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


def load_events(path: str) -> list:
    """The trace events of a trace.json, or of the newest one under a
    directory."""
    if os.path.isdir(path):
        files = trace_files(path)
        if not files:
            raise FileNotFoundError(f"no trace .json under {path}")
        path = max(files, key=os.path.getmtime)
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def _innermost(intervals: list, points: list, pick) -> dict:
    """For each (key, t) of `points`, the innermost of the properly
    nested `intervals` (ts, end, name) of one host thread that is open at
    t and satisfies `pick(name)`."""
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


def span_window(events: list, dev: list):
    """The extent of the trace's spans and device events, or None."""
    ivs = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
           if e.get("ph") == "X" and e.get("cat") == SPAN_CAT] + \
        [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in dev]
    if not ivs:
        return None
    return min(a for a, _ in ivs), max(b for _, b in ivs)


def summarize(events: list, steps: float = 1.0, top_n: int = 40) -> dict:
    """The trace's device time (ms, divided by `steps`) in total, by
    category, by kernel and by repo frame, `lost_launches` (the host
    launches with no device event: a trace that has any undercounts), and
    `spans`: for the top_n span labels [label, device ms, idle ms, syncs,
    launches, host ms, times opened] over `span_window` (`span_reduce`;
    a `.bwd` half has no host time of its own), with `units` (the top
    spans, `name#id`, seen) and `span_device_ms` (what the labels' device
    ms add up to)."""
    dev, lost = device_events(events)
    total = sum(e.get("dur", 0.0) for e in dev)
    by_cat, kernels = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_cat[CATEGORIES[e["cat"]]] += e.get("dur", 0.0)
        if e["cat"] == "kernel":
            kernels[e["name"]][0] += e.get("dur", 0.0)
            kernels[e["name"]][1] += 1

    launches, frames = {}, defaultdict(list)
    span_host = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, thread = e.get("cat"), (e.get("pid"), e.get("tid"))
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (thread, e["ts"])
        elif cat == "python_function":
            frames[thread].append((e["ts"], e["ts"] + e.get("dur", 0.0),
                                   e["name"]))
        elif cat == SPAN_CAT:
            h = span_host[e["name"].split("#")[0]]
            h[0] += e.get("dur", 0.0)
            h[1] += 1

    points = defaultdict(list)         # thread → [(device event index, t)]
    for i, e in enumerate(dev):
        hit = launches.get(e.get("args", {}).get("correlation"))
        if hit is not None:
            points[hit[0]].append((i, hit[1]))
    src = {}
    for thread, pts in points.items():
        src.update(_innermost(frames.get(thread, []), pts,
                              lambda n: REPO_FRAME in n))
    by_frame = defaultdict(lambda: [0.0, 0])
    for i, e in enumerate(dev):        # "?": no launch or no repo frame
        f = by_frame[src.get(i, "?")]
        f[0] += e.get("dur", 0.0)
        f[1] += 1

    window = span_window(events, dev)
    red = (span_reduce(events, *window) if window is not None
           else {"device_s": 0.0, "units": 0, "spans": {}})

    def ms(us):
        return us / 1e3 / steps

    def top(items, key):
        return sorted(items, key=key, reverse=True)[:top_n]

    return {
        "steps": steps, "device_ms": ms(total), "device_events": len(dev),
        "lost_launches": len(lost),
        "by_category": {k: ms(v) for k, v in by_cat.items()},
        "kernels": [[k, ms(v[0]), v[1]] for k, v in
                    top(kernels.items(), lambda kv: kv[1][0])],
        "units": red["units"], "span_device_ms": ms(1e6 * red["device_s"]),
        "spans": [[k, ms(1e6 * d), ms(1e6 * i), n_sync, n_launch,
                   ms(span_host[k][0]), span_host[k][1]]
                  for k, (d, i, n_sync, n_launch) in
                  top(red["spans"].items(),
                      lambda kv: kv[1][0] + kv[1][1])],
        "sources": [[k, ms(v[0]), v[1]] for k, v in
                    top(by_frame.items(), lambda kv: kv[1][0])],
    }


def report(s: dict) -> str:
    total = s["device_ms"] or 1.0
    steps = s["steps"]
    out = [f"total device self time: {s['device_ms']:.3f} ms "
           f"({s['device_events']} device events)"
           + (f"  [per step: /{steps:g}]" if steps != 1 else "")]
    if s["lost_launches"]:
        out.append(f"INCOMPLETE: {s['lost_launches']} host launches have no "
                   f"device event in the trace")
    out.append("--- by category ---")
    for k, v in sorted(s["by_category"].items(), key=lambda kv: -kv[1]):
        out.append(f"{v:9.3f} ms  {100 * v / total:5.1f}%  {k}")
    out.append(f"--- top {len(s['kernels'])} kernels by device time ---")
    for k, v, n in s["kernels"]:
        out.append(f"{v:9.3f} ms  {100 * v / total:5.1f}%  x{n:<5d} {k[:110]}")
    out.append(f"--- spans ({s['units']} steps or views): device ms, idle "
               f"ms, syncs, launches, host ms, times opened ---")
    for k, d, i, n_sync, n_launch, h, n in s["spans"]:
        out.append(f"{d:9.3f} ms  {i:9.3f} ms idle  {n_sync:>5d} syncs  "
                   f"{n_launch:>6d} launches  {h:9.3f} ms host  x{n:<5d} "
                   f"{k[:60]}")
    out.append("--- repo frames by device time launched inside ---")
    for k, v, n in s["sources"]:
        out.append(f"{v:9.3f} ms  {100 * v / total:5.1f}%  "
                   f"[{n:>5d} events] {k[:100]}")
    return "\n".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    top_n = int(argv[1]) if len(argv) > 1 else 40
    steps = float(argv[2]) if len(argv) > 2 else 1.0
    print(report(summarize(load_events(argv[0]), steps, top_n)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
