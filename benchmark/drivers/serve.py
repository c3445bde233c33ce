"""Closed-loop serving with one client: each request is one
`EvalRenderer.render_one` (a depth-only re-render of each source, the
geometry render with the warp, the fusion net) of a camera drawn by the
seed: one of the configuration's serve cameras, turned about its centre
by up to `max_rotation_deg` and moved by up to
`max_translation_of_extent` of the scene's extent (a pool of POOL such
requests, sent in turn and again from the start).  Each request is timed
from its call to the card's synchronise after it; the next is sent then.

The compared views are drawn by the seed among the window's first
`compared_from_first` requests; their outputs, and the source depths the
renderer drew (read through a wrapper of `render_depth_view` in the
render driver), are kept until the window closes.  The check renders the
same requests with the reference."""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from benchmark import compare, sides
from benchmark import scene as sc
from benchmark import trace as tr
from benchmark.sides import geometry, work_record

OUTPUTS = ("render", "depth", "warped", "aggregate")
POOL = 512          # distinct requests, sent in turn


class Run:
    def __init__(self, ctx: dict):
        self.ctx = ctx
        self.tr = ctx["traffic"]

    def setup(self):
        c, t = self.ctx, self.tr
        self.scene = s = c["config_module"].build(
            c["config"], t, c["seed"], c["device"])
        self.port = P = sides.Side(sides.port_modules(), s, c["device"])
        self.geom = geometry(P)
        rd = P.m.render_driver
        model = P.model()
        self.ev = rd.EvalRenderer(model, P.net(), s.images, P.w2v,
                                  P.centers, P.cams, P.opt, P.rcfg,
                                  device=c["device"])
        # a pool of POOL requests drawn from the seed, sent in turn and
        # again from the start when the window outlasts it
        rng = np.random.default_rng(c["seed"])
        base = rng.integers(len(s.serve_views), size=POOL)
        self.requests = []
        for b in base:
            view = sc.offset_views(
                s.serve_views[b], rng, 1, float(t["max_rotation_deg"]),
                float(t["max_translation_of_extent"]) * s.extent)[0]
            self.requests.append((view, s.serve_nearest[b]))
        self.cams = [P.camera(v) for v, _ in self.requests]
        k = int(t["compared_views"])
        first = (3 * int(t["traced_views"]) if c["trace"]
                 else int(t["compared_from_first"]))
        self.sample = sorted(int(i) for i in rng.choice(
            first, size=min(k, first), replace=False))
        # keep the source depths render_one draws for compared requests
        self.captured, self._keep = [], False
        self._orig = orig = rd.render_depth_view

        def capturing(*a, **kw):
            d = orig(*a, **kw)
            if self._keep:
                self.captured.append(d)
            return d

        rd.render_depth_view = capturing
        self.next = 0
        for _ in range(int(t["warmup_views"])):
            self._serve()
        torch.cuda.synchronize()
        self.start = self.next
        self.kept = {}
        self.bad = torch.zeros((), dtype=torch.int64, device=c["device"])

    def _serve(self):
        j = self.next
        self.next += 1
        return j, self.ev.render_one(self.cams[j % POOL],
                                     self.requests[j % POOL][1])

    def _counted_view(self):
        w = self.next - self.start
        self._keep = w in self.sample
        self.captured = []
        j, out = self._serve()
        self._keep = False
        self.bad += (~torch.isfinite(out["aggregate"]).all()).to(torch.int64)
        if w in self.sample:
            self.kept[j] = ({k: out[k].detach().clone() for k in OUTPUTS},
                            [d.detach().clone() for d in self.captured])

    def window(self, seconds: float) -> dict:
        lat = []
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            self._counted_view()
            torch.cuda.synchronize()
            b = time.perf_counter()
            lat.append(b - a)
            if b - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] \
            if len(lat) > 1 else lat[0]
        return {"attempted": len(lat), "failed": int(self.bad),
                "metrics": {"views_s": len(lat) / dt,
                            "view_ms_p95": 1e3 * p95},
                "window_s": dt, "latencies": lat}

    def traced(self) -> dict:
        K = int(self.tr["traced_views"])

        def views():
            for _ in range(K):
                self._counted_view()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        views()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / K
        plain = tr.reduce(tr.capture(views, with_stack=False))
        stacked = tr.reduce(tr.capture(views, with_stack=True))
        return {"attempted": 3 * K, "failed": int(self.bad),
                "kind": "serve", "units": K, "wall_s": wall,
                "plain": plain, "stacked": stacked}

    def release(self):
        self.port.m.render_driver.render_depth_view = self._orig
        self.ev = self.port = self.cams = None
        torch.cuda.empty_cache()

    # ---- check ---------------------------------------------------------
    def reference(self, js, lowered=None) -> dict:
        import contextlib

        from benchmark.reference import blend as rblend
        from benchmark.reference import precision

        c, s = self.ctx, self.scene
        R = sides.Side(sides.reference_modules(), s, c["device"])
        low = (precision.lowered(lowered) if lowered is not None
               else contextlib.nullcontext())
        outs, rec = {}, []
        with low:
            model, net = R.model(), R.net().eval()
            for n, j in enumerate(js):
                view, nearest = self.requests[j % POOL]
                rblend.RECORD = rec if n == 0 else None
                try:
                    outs[j] = R.m.serve.render_one(
                        model, net, R.stacks(), R.cams, R.opt, R.rcfg,
                        R.camera(view), nearest)
                finally:
                    rblend.RECORD = None
        return {"outs": outs, "blends": rec}

    def check(self, limits: dict, lowered=None):
        js = sorted(self.kept)
        if not js:
            raise RuntimeError("serve: no compared view was served")
        ref = self.reference(js, lowered)
        gaps = {k: 0.0 for k in OUTPUTS + ("source_depths",)}
        for j in js:
            prog, depths = self.kept[j]
            r = ref["outs"][j]
            for k in OUTPUTS:
                gaps[k] = max(gaps[k], compare.rel_l1(prog[k], r[k]))
            if len(depths) != len(r["source_depths"]):
                gaps["source_depths"] = float("inf")
                continue
            for p, q in zip(depths, r["source_depths"]):
                gaps["source_depths"] = max(gaps["source_depths"],
                                            compare.rel_l1(p, q))
        names = {"render": "render_gap", "depth": "median_depth_gap",
                 "warped": "warped_gap", "aggregate": "fused_gap",
                 "source_depths": "source_depth_gap"}
        checks = [(names[k], gaps[k], limits.get(names[k]))
                  for k in ("source_depths", "render", "depth", "warped",
                            "aggregate")]
        detail = {"compared_views": len(js)}
        return checks, detail, work_record("serve", self.scene, self.geom,
                                           ref["blends"])
