"""Tracing (counterpart of ibgs_tpu/utils/profiling.py).

`trace(logdir)` captures a `torch.profiler` trace (host ops and, on a
card, its kernels) of the code it wraps and writes it as a Chrome trace
(viewable in Perfetto or chrome://tracing; `scripts/parse_trace.py`
tabulates it).  The training loop opens it over the `--profile_from_iter`
/ `--profile_num_steps` window.  `trace_files` lists the captures under a
directory.

A span (`annotate(name)`) marks one layer of the step or the view in such
a trace: a `record_function` range named `name`, or `name#ident` for the
top span of one step or view (`train_step#<iteration>`,
`render_one#<n>`), whose identifier every span nested in it shares.  The
port opens them at its layer boundaries: `render`, `projection`,
`binning`, `blend`, `epilogue`, `net`, `objective`, `backward`,
`optimizer`, `source_depths`.  Spans are live only while a profiler
session records (this module's `trace`, the benchmark's traced windows,
any `torch.profiler.profile`): with none, a span is one read of the
profiler's flag and a shared null context, under a microsecond; with one,
it is a `record_function` enter and exit, 10-14 us of host time.
No option turns them on.  A span's work done by the autograd backward
runs on another thread with no span open: `parse_trace` charges it to the
span that ran its forward op (the trace's sequence numbers link the two).

The measurement drivers (`bench.py`, `scripts/kernel_probe.py`,
`perf_probe.py`, `gsp_tax.py`) time with `wall_ms` (CUDA events on a
card, the host clock on the CPU) and read the card's own share of that
time with `device_time`.
"""
from __future__ import annotations

import contextlib
import glob
import os
import re
import time

import torch


@contextlib.contextmanager
def trace(logdir, with_stack: bool = False):
    """Capture a torch.profiler trace into `logdir`/trace.json (no-op if
    falsy).  `with_stack` also records the Python frames around every op
    (the `python_function` events that parse_trace attributes device time
    to); it slows the host."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    if torch.cuda.is_available():
        with _card_session(with_stack) as prof:
            yield
    else:
        with profile(activities=[ProfilerActivity.CPU],
                     with_stack=with_stack) as prof:
            yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# Two ways a torch.profiler session on an H100 lost device events of
# its host launches (`device_events` finds them): late in a long process
# each session dropped 15-22 records, which a warm-up step in the session
# absorbed; and, at any age, a session could lose a prefix of its
# launches, while kernels it kept could seem to start before their
# launch: the profiler's map of the card's clock onto the host's drifts,
# so kernels run just after the session opened seemed to run before it.
# A session therefore opens with a warm-up step, whose events it drops,
# and idles CLOCK_GUARD_S after the step and before it closes.
WARM_UP_LAUNCHES = 256
CLOCK_GUARD_S = 0.1


@contextlib.contextmanager
def _card_session(with_stack: bool = False):
    """A profiler session (CPU and CUDA activity) that records only the
    code it wraps, guarded as above; yields the profiler."""
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


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def wall_ms(fn, iters: int = 1, warmup: int = 0, device="cuda") -> float:
    """Mean wall time of `iters` back-to-back calls of fn after `warmup`
    calls: CUDA events around the calls and one synchronise at the end on
    a card (the host's enqueueing counts whenever the card waits for it),
    the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if not _is_cuda(device):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the runtime / driver calls that enqueue a kernel, a copy or a set
_WORK_CALL = re.compile(r"cu(da)?(Launch(Cooperative)?Kernel|Memcpy|Memset)")


def device_events(events: list):
    """The device events (kernels, copies, sets) of a Chrome trace's
    events, and the correlation ids of the host calls that enqueued device
    work (`LAUNCH_CATS` events named by `_WORK_CALL`) but have no device
    event in the trace: the work the profiler lost."""
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    have = {e.get("args", {}).get("correlation") for e in dev}
    lost = [e["args"]["correlation"] for e in events
            if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
            and _WORK_CALL.match(e.get("name", ""))
            and "correlation" in e.get("args", {})
            and e["args"]["correlation"] not in have]
    return dev, lost


def _profiled_events(fn) -> list:
    """The trace events of one call of fn (`_card_session`)."""
    import json
    import tempfile

    with _card_session() as prof:
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def device_time(fn, device="cuda", top: int = 0) -> dict:
    """The card's own time in one call of fn (torch.profiler, CUPTI):
    `device_busy_ms`, the summed durations of the trace's device events
    (kernels, copies, sets: a host op's entry repeats its kernels' time
    and a `record_function` label's device range spans them, so neither
    is counted; parse_trace sums the same events), `device_launches`
    (their number) and, with `top`, the `top` longest kernels as [name,
    ms, count].  On the CPU, when the profiler cannot trace the card, or
    when a host launch has no device event in the trace, {"error": why}:
    a host time or a partial count is never reported as the card's."""
    if not _is_cuda(device):
        return {"error": "not measured: no CUDA device"}
    torch.cuda.synchronize(device)
    try:
        events = _profiled_events(fn)
    except RuntimeError as e:          # CUPTI unavailable: not measured
        return {"error": str(e)[:200]}
    dev, lost = device_events(events)
    if not dev:
        return {"error": "the profiler recorded no device time"}
    if lost:
        return {"error": f"the profiler lost {len(lost)} of "
                         f"{len(dev) + len(lost)} device events"}
    out = {"device_busy_ms": sum(e.get("dur", 0.0) for e in dev) / 1e3,
           "device_launches": len(dev)}
    if top:
        by_name = {}
        for e in dev:
            t = by_name.setdefault(e["name"][:60], [0.0, 0])
            t[0] += e.get("dur", 0.0) / 1e3
            t[1] += 1
        out["top"] = sorted(([k, *v] for k, v in by_name.items()),
                            key=lambda r: -r[1])[:top]
    return out


def idle_share(prof: dict, wall_ms: float) -> dict:
    """`prof` (a `device_time` result) with `idle_share`, the unclamped
    share of `wall_ms` (the same call timed without the profiler) that the
    card is idle.  Busy time above the wall time is a wrong count, not an
    idle card: the share is kept as read (negative) and `error` names it."""
    out = dict(prof, idle_share=None)
    if "device_busy_ms" in prof:
        out["idle_share"] = 1.0 - prof["device_busy_ms"] / wall_ms
        if out["idle_share"] < 0:
            out["error"] = (f"device busy {prof['device_busy_ms']} ms "
                            f"exceeds the wall time {wall_ms} ms")
    return out


# whether a profiler session records: the C flag behind
# torch.autograd.profiler._is_profiler_enabled, also set by sessions that
# do not go through torch.profiler (emit_nvtx, emit_itt)
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def annotate(name: str, ident=None):
    """A span named `name` (`name#ident` with an identifier): a
    record_function range while a profiler session records, else a shared
    null context (one flag read; record_function itself is never
    called)."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(
        name if ident is None else f"{name}#{ident}")


def trace_files(logdir: str):
    """The Chrome trace files `trace` wrote under `logdir`."""
    return sorted(glob.glob(os.path.join(logdir, "**", "*.json"),
                            recursive=True))
