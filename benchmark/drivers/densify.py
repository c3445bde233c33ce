"""Training with density control: train_options' closed-loop steps (the
step phase the traffic gives) with the port's own maintenance cadence,
`ibgs_tpu_torch.train.maintenance.maintain`, after every step, in set-up,
the window and the traced run alike, so the window's time holds every
densify event, prune and capacity growth it reaches.  The traffic's
`options` (fields of `OptimizationParams`: the densify thresholds and
intervals) are set alike on both sides, over the configuration's.  The
densify noise comes from a generator on the card seeded with the run's
seed.

The maintenance after a step runs as the next step begins (the loop's
order), so set-up reads the compared steps (as train_options does) before
the event that follows the last of them.  Set-up then steps on through
one cycle of views; at the first event it keeps the port's state before
it with its noise generator's state, and the state after it (both on the
host).  The window and the traced run step on from there.  The window's
event records and the maintenance counters go into the result's
detail.

The check is train_options' over the compared steps, and the first
event: the reference's `densify.event` from the kept state, with the
same noise draws, against the port's state after it.
`densify_alive_gap`: the slots whose alive bit differs, over the
reference's alive count; `densify_param_gap`: the worst over the eight
fields of the parameters and both Adam moments of Σ|p − r| / Σ|r| over
the rows alive on both sides (inf where the capacities differ).

The traced run makes the train driver's three runs of `traced_steps`
steps (untimed, then without and with Python stacks), each after enough
untraced steps that its third step ends with a densify event: every run
holds exactly one.  Beside the captures' reductions it records `events`
(the events in the stacked run) and `maintenance_idle_s`: the idle time
of the card, inside the stacked window, while a frame of
`train/maintenance.py` was open on the host's main thread.
"""
from __future__ import annotations

import dataclasses
import time
import types

import torch

from benchmark import compare, harness
from benchmark import trace as tr

train_options = harness.driver("train_options")
MAINTENANCE_FILE = "ibgs_tpu_torch/train/maintenance.py"


def _model_arrays(model) -> dict:
    """A port model's tensors as the reference's state dict, on the
    host."""
    from benchmark.reference import densify as rd

    out = {t: {k: getattr(getattr(model, t), k).detach().cpu()
               for k in rd.FIELDS} for t in rd.TREES}
    out["alive"] = model.alive.cpu()
    for k in rd.STATS:
        out[k] = getattr(model, k).cpu()
    return out


class Run(train_options.Run):
    def _side(self, modules):
        side = super()._side(modules)
        side.opt = dataclasses.replace(side.opt,
                                       **self.tr.get("options", {}))
        return side

    # ---- program -------------------------------------------------------
    def setup(self):
        from ibgs_tpu_torch.train import maintenance

        self.maint = maintenance
        self.gen = torch.Generator(device=self.ctx["device"]).manual_seed(
            self.ctx["seed"])
        self.events, self.first = [], None
        build = self.ctx["config_module"].build

        def built(*args):
            scene = build(*args)
            # the scene's KNN can leave the allocator holding nearly the
            # whole card (on an H100 80GB, 84 of 85 GB reserved at 6.3 GB
            # allocated, seed 2147490012), and the cuSOLVER handle that
            # set-up's first 4x4 inverse creates then finds no memory:
            # hand the cache back
            torch.cuda.empty_cache()
            return scene

        self.ctx = dict(self.ctx, config_module=types.SimpleNamespace(
            build=built))
        super().setup()
        if self.first is None:
            raise RuntimeError("densify: set-up reached no densify event")
        self.events = []

    def _iteration(self) -> int:
        """The iteration of the next step."""
        return int(self.tr["iteration"]) + self.k

    def _step(self):
        """The maintenance after the previous step, then the step: the
        loop's order, with the compared steps' reading (taken after the
        last of them) before the event that follows them."""
        if self.k:
            self._maintain(self._iteration() - 1)
        return super()._step()

    def _maintain(self, it: int):
        """The port's maintenance after the step of iteration `it`; the
        first event's states kept for the check."""
        opt = self.port.opt
        keep = self.first is None and self.maint.densify_due(opt, it)
        if keep:
            before = (_model_arrays(self.state.model), self.gen.get_state())
        self.state, rec = self.maint.maintain(
            self.state, it, opt, self.gen, float(self.scene.extent))
        if rec is not None:
            self.events.append(rec)
        if keep:
            self.first = {"before": before[0], "gen": before[1],
                          "after": _model_arrays(self.state.model),
                          "iter": it, "record": rec}

    def window(self, seconds: float) -> dict:
        n0 = dict(self.maint.COUNTERS)
        out = super().window(seconds)
        self.window_events = list(self.events)
        self.counters = {k: v - n0[k] for k, v in
                         self.maint.COUNTERS.items()}
        return out

    def traced(self) -> dict:
        K = int(self.tr["traced_steps"])
        opt = self.port.opt
        n = [0]

        def aligned():
            """Step on until the event after the third of the next K steps
            (run as the fourth begins)."""
            while not self.maint.densify_due(opt, self._iteration() + 2):
                self._counted_step()
                n[0] += 1

        def steps():
            for _ in range(K):
                self._counted_step()

        aligned()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / K
        aligned()
        plain = tr.reduce(tr.capture(steps, with_stack=False))
        aligned()
        e0 = self.maint.COUNTERS["events"]
        events = tr.capture(steps, with_stack=True)
        n_events = self.maint.COUNTERS["events"] - e0
        stacked = tr.reduce(events)
        self.window_events = list(self.events)
        self.counters = None
        return {"attempted": 3 * K + n[0], "failed": int(self.bad),
                "kind": "train", "units": K, "wall_s": wall,
                "plain": plain, "stacked": stacked, "events": n_events,
                "maintenance_idle_s": maintenance_idle_s(events)}

    def release(self):
        super().release()
        self.gen = None

    # ---- check ---------------------------------------------------------
    def check(self, limits: dict, lowered=None):
        checks, detail, work = super().check(limits, lowered)
        alive_gap, param_gap, at, ref = self.event_gaps(lowered)
        checks += [("densify_alive_gap", alive_gap,
                    limits.get("densify_alive_gap")),
                   ("densify_param_gap", param_gap,
                    limits.get("densify_param_gap"))]
        first = {k: v for k, v in self.first["record"].items()
                 if k != "ms"}
        detail.update(densify_param_gap_at=at, first_event=first,
                      first_event_reference=ref,
                      events=[{k: (round(v, 3) if k == "ms" else v)
                               for k, v in r.items()}
                              for r in self.window_events],
                      counters=self.counters)
        return checks, detail, work

    def event_gaps(self, lowered=None):
        """The reference's first event from the kept state, against the
        port's state after it: (alive gap, param gap, the worst leaf, the
        reference's record)."""
        import contextlib

        from benchmark import sides
        from benchmark.reference import densify as rd
        from benchmark.reference import precision

        dev = self.ctx["device"]
        first = self.first

        def on_dev(state):
            out = {t: {k: v.to(dev) for k, v in state[t].items()}
                   for t in rd.TREES}
            for k in ("alive",) + rd.STATS:
                out[k] = state[k].to(dev)
            return out

        gen = torch.Generator(device=dev)

        def draw(P):
            gen.set_state(first["gen"])
            return torch.randn((3, P, 3), generator=gen, dtype=torch.float32,
                               device=dev)

        opt = self._side(sides.reference_modules()).opt
        low = (precision.lowered(lowered) if lowered is not None
               else contextlib.nullcontext())
        with low:
            ref, rec = rd.event(on_dev(first["before"]), first["iter"], opt,
                                float(self.scene.extent), draw)
        return (*gaps(on_dev(first["after"]), ref), rec)


def gaps(prog: dict, ref: dict):
    """(densify_alive_gap, densify_param_gap, its worst leaf) of the
    program's state after an event against the reference's (the state
    dicts of `reference/densify.py`)."""
    from benchmark.reference import densify as rd

    if prog["alive"].shape != ref["alive"].shape:
        return float("inf"), float("inf"), "capacity"
    n_ref = max(int(ref["alive"].sum()), 1)
    alive_gap = float((prog["alive"] != ref["alive"]).sum()) / n_ref
    both = prog["alive"] & ref["alive"]
    worst, at = 0.0, None
    for t in rd.TREES:
        for k in rd.FIELDS:
            gap = compare.rel_l1(prog[t][k][both], ref[t][k][both])
            if at is None or gap > worst:
                worst, at = gap, f"{t}.{k}"
    return alive_gap, worst, at


def maintenance_idle_s(events: list) -> float:
    """The card's idle seconds inside the traced window while a frame of
    train/maintenance.py was open on the thread with the most Python
    frames (the host's main thread)."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == tr.WINDOW_LABEL
           and e.get("cat") == "user_annotation"]
    w0 = min(e["ts"] for e in win)
    w1 = max(e["ts"] + e.get("dur", 0.0) for e in win)
    frames = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "python_function":
            frames.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    if not frames:
        return 0.0
    main = max(frames, key=lambda t: len(frames[t]))
    open_ = _union([(e["ts"], e["ts"] + e.get("dur", 0.0))
                    for e in frames[main]
                    if MAINTENANCE_FILE in e.get("name", "")])
    dev, _ = tr.device_events(events)
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0.0), w1))
                   for e in dev if e["ts"] < w1
                   and e["ts"] + e.get("dur", 0.0) > w0])
    idle = _idle(busy, w0, w1)
    return _overlap(idle, open_) / 1e6


def _union(ivs: list) -> list:
    out = []
    for s, e in sorted(ivs):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _idle(busy: list, w0: float, w1: float) -> list:
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    return [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]


def _overlap(a: list, b: list) -> float:
    """The summed length of the intersection of two sorted lists of
    disjoint intervals."""
    i = j = 0
    s = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            s += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return s
