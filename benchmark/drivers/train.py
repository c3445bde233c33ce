"""Closed-loop training: back-to-back `trainer.make_train_step` steps
(geometry render and aggregation on) over the configuration's train views
in a seeded order, cycled, each with its nearest sources and the source
depths of a depth cache rendered at set-up (as `train/loop.py` keeps one).

Set-up builds the one train state, runs its first `compared_steps` steps
through the window's own call and feed (read back for the check), then
the rest of one cycle of views, so every view's shapes have run once.
The window steps on from there.  The check runs the reference's step
from the scene's inputs over the same first steps."""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, sides
from benchmark.sides import geometry, work_record
from benchmark import trace as tr


class Run:
    def __init__(self, ctx: dict):
        self.ctx = ctx
        self.tr = ctx["traffic"]
        self.scene = None

    # ---- program -------------------------------------------------------
    def setup(self):
        c, t = self.ctx, self.tr
        self.scene = s = c["config_module"].build(
            c["config"], t, c["seed"], c["device"])
        self.port = P = sides.Side(sides.port_modules(), s, c["device"])
        rng = np.random.default_rng(c["seed"])
        self.order = [int(i) for i in rng.permutation(s.train_ids)]
        state = P.train_state()
        views = self._used_views(self.order)
        with torch.no_grad():
            cache = {j: P.depth(state.model, j) for j in views}
        self.srcs = {i: P.sources(i, cache, P.cams[i]) for i in self.order}
        self.phase = P.m.trainer.StepPhase(render_geo=True,
                                           use_aggregation=True)
        self.step_fn = P.m.trainer.make_train_step(P.opt, P.rcfg, state.net,
                                                   self.phase)
        self.state, self.k = state, 0
        self.geom = geometry(P)
        n_cmp = int(t["compared_steps"])
        self.prog_losses = []
        for k in range(n_cmp):
            aux = self._step()
            self.prog_losses.append({n: aux[n] for n in compare.LOSS_TERMS})
            if k == 0:
                self.prog_grads = compare.grad_norms(self.state)
        self.prog_change = compare.leaf_norms(
            self.state, base=compare.base_leaves(s))
        while self.k < max(n_cmp, len(self.order)):
            self._step()
        torch.cuda.synchronize()
        self.bad = torch.zeros((), dtype=torch.int64, device=c["device"])

    def _used_views(self, order):
        out = set()
        for i in order:
            out.update(self.scene.nearest[i][:4])
        return sorted(out)

    def _step(self):
        t, P = self.tr, self.port
        i = self.order[self.k % len(self.order)]
        self.state, aux = self.step_fn(
            self.state, P.cams[i], i, self.scene.images[i], self.srcs[i],
            int(t["iteration"]) + self.k, P.bg, bool(t["use_app"]),
            float(t["burned_in"]), float(t["net_lr"]))
        self.k += 1
        return aux

    def _counted_step(self):
        aux = self._step()
        self.bad += ((aux["nonfinite_grads"] > 0)
                     | ~torch.isfinite(aux["loss"])).to(torch.int64)

    def window(self, seconds: float) -> dict:
        W, H = self.scene.width, self.scene.height
        n = 0
        t0 = time.perf_counter()
        while True:
            self._counted_step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return {"attempted": n, "failed": int(self.bad),
                "metrics": {"train_mpix_s": W * H * n / dt / 1e6},
                "window_s": dt}

    def traced(self) -> dict:
        K = int(self.tr["traced_steps"])

        def steps():
            for _ in range(K):
                self._counted_step()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / K
        plain = tr.reduce(tr.capture(steps, with_stack=False))
        stacked = tr.reduce(tr.capture(steps, with_stack=True))
        return {"attempted": 3 * K, "failed": int(self.bad),
                "kind": "train", "units": K, "wall_s": wall,
                "plain": plain, "stacked": stacked}

    def release(self):
        self.state = self.step_fn = self.srcs = self.port = None
        torch.cuda.empty_cache()

    # ---- check ---------------------------------------------------------
    def reference(self, lowered=None) -> dict:
        """The reference's compared steps from the scene's inputs: loss
        terms, first gradient norms, change norms, and the blend's pair
        counts of the first step.  `lowered` (a dtype) runs the control."""
        import contextlib

        from benchmark.reference import blend as rblend
        from benchmark.reference import precision

        c, t, s = self.ctx, self.tr, self.scene
        n_cmp = int(t["compared_steps"])
        order = [self.order[k % len(self.order)] for k in range(n_cmp)]
        R = sides.Side(sides.reference_modules(), s, c["device"])
        low = (precision.lowered(lowered) if lowered is not None
               else contextlib.nullcontext())
        with low:
            state = R.train_state()
            cache = {j: R.depth(state.model, j)
                     for j in self._used_views(order)}
            step = R.m.trainer.make_train_step(
                R.opt, R.rcfg, state.net,
                R.m.trainer.StepPhase(render_geo=True, use_aggregation=True))
            losses, grads, rec = [], None, []
            for k, i in enumerate(order):
                rblend.RECORD = rec if k == 0 else None
                try:
                    state, aux = step(
                        state, R.cams[i], i, s.images[i],
                        R.sources(i, cache, R.cams[i]),
                        int(t["iteration"]) + k, R.bg, bool(t["use_app"]),
                        float(t["burned_in"]), float(t["net_lr"]))
                finally:
                    rblend.RECORD = None
                losses.append({n: float(aux[n]) for n in compare.LOSS_TERMS})
                if k == 0:
                    grads = compare.floats(compare.grad_norms(state))
            change = compare.floats(compare.leaf_norms(
                state, base=compare.base_leaves(s)))
        return {"losses": losses, "grads": grads, "change": change,
                "blends": rec}

    def check(self, limits: dict, lowered=None):
        ref = self.reference(lowered)
        prog_losses = [{k: float(v) for k, v in d.items()}
                       for d in self.prog_losses]
        pg = compare.floats(self.prog_grads)
        pc = compare.floats(self.prog_change)
        leaves = compare.moved_leaves(ref["grads"])
        lg, lg_at = compare.loss_gap(prog_losses, ref["losses"])
        gg, gg_at = compare.norm_gap(pg, ref["grads"], leaves)
        sg, sg_at = compare.norm_gap(pc, ref["change"], leaves)
        checks = [("loss_gap", lg, limits.get("loss_gap")),
                  ("grad_gap", gg, limits.get("grad_gap")),
                  ("step_gap", sg, limits.get("step_gap"))]
        detail = {"loss_gap_at": lg_at, "grad_gap_at": gg_at,
                  "step_gap_at": sg_at,
                  "left_out": sorted(set(ref["grads"]) - set(leaves))}
        return checks, detail, self.work(ref["blends"])

    def work(self, blends) -> dict:
        return work_record("train", self.scene, self.geom, blends)
