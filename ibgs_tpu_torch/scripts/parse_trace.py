"""Tabulate a torch.profiler Chrome trace (counterpart of
scripts/parse_trace.py, which reads an xplane.pb).

    python -m ibgs_tpu_torch.scripts.parse_trace TRACE [top_n] [steps]

TRACE is a trace.json that `utils/profiling.trace` (the training loop's
`--profile_from_iter` window, `bench --profile`, `gsp_tax --profile`)
wrote, or a directory holding some (the newest is read).  It prints the
card's total self time (kernels, copies and sets), that time by category,
the top_n (default 40) kernels with their counts, the top_n
`record_function` labels (device time launched inside each, and the
label's own host time), and the top_n Python functions of the repo that
launched the device work.  A device event is charged to the innermost
label and the innermost repo frame open on the host thread when its
launch was issued (matched by the trace's correlation ids); the Python
frames exist only in a trace taken `with_stack=True`.  Every time is
divided by `steps` (e.g. the chain length of a bench trace); counts are
not.  Host launches whose device event the profiler lost are counted and
flagged: such a trace undercounts.
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


def summarize(events: list, steps: float = 1.0, top_n: int = 40) -> dict:
    """The trace's device time (ms, divided by `steps`) in total, by
    category, by kernel, by record_function label and by repo frame, and
    `lost_launches`, the host launches with no device event (a trace that
    has any undercounts)."""
    dev, lost = device_events(events)
    total = sum(e.get("dur", 0.0) for e in dev)
    by_cat, kernels = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_cat[CATEGORIES[e["cat"]]] += e.get("dur", 0.0)
        if e["cat"] == "kernel":
            kernels[e["name"]][0] += e.get("dur", 0.0)
            kernels[e["name"]][1] += 1

    launches = {}
    labels, frames = defaultdict(list), defaultdict(list)
    label_host = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, thread = e.get("cat"), (e.get("pid"), e.get("tid"))
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (thread, e["ts"])
        elif cat in ("user_annotation", "python_function"):
            iv = (e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
            if cat == "python_function":
                frames[thread].append(iv)
                continue
            labels[thread].append(iv)
            label_host[e["name"]][0] += e.get("dur", 0.0)
            label_host[e["name"]][1] += 1

    points = defaultdict(list)         # thread → [(device event index, t)]
    for i, e in enumerate(dev):
        hit = launches.get(e.get("args", {}).get("correlation"))
        if hit is not None:
            points[hit[0]].append((i, hit[1]))
    lab, src = {}, {}
    for thread, pts in points.items():
        lab.update(_innermost(labels.get(thread, []), pts, lambda n: True))
        src.update(_innermost(frames.get(thread, []), pts,
                              lambda n: REPO_FRAME in n))
    by_label, by_frame = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for i, e in enumerate(dev):        # "?": no launch or no repo frame
        d = e.get("dur", 0.0)
        if i in lab:
            by_label[lab[i]] += d
        f = by_frame[src.get(i, "?")]
        f[0] += d
        f[1] += 1

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
        "labels": [[k, ms(by_label.get(k, 0.0)), ms(v[0]), v[1]] for k, v in
                   top(label_host.items(),
                       lambda kv: (by_label.get(kv[0], 0.0), kv[1][0]))],
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
    out.append("--- record_function labels: device ms launched inside, "
               "host ms ---")
    for k, v, h, n in s["labels"]:
        out.append(f"{v:9.3f} ms  {h:9.3f} ms host  x{n:<5d} {k[:100]}")
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
