"""Closed-loop training as drivers/train.py runs it, with two settings
taken from data: the configuration's `options` (fields of
`OptimizationParams`, set alike on the port's and the reference's side;
none when the configuration has no such key) and the traffic's step
phase (`render_geo`, `use_aggregation`, each true when the traffic does
not give it), for the timed step and the reference's step alike.  The
window, the failure count, the traced runs and the check are train.py's;
`setup` and `reference` are its own with those two settings in place
(train.py builds its sides and its phase inline).

A step without aggregation runs no net: the net's leaves, whose
gradients are zeros, are left out of the compared norms on both sides
(compare.py's median over the leaves would otherwise be one of those
zeros).  The work record of a step that renders no geometry counts no
sources (S = 0, none visible): such a step warps none and runs no net,
which the layer counts in rooflines/ then leave out."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from benchmark import compare, harness, sides
from benchmark.sides import geometry, work_record

train = harness.driver("train")


class Run(train.Run):
    def _side(self, modules) -> sides.Side:
        side = sides.Side(modules, self.scene, self.ctx["device"])
        side.opt = dataclasses.replace(
            side.opt, **self.ctx["config"].get("options", {}))
        return side

    def _phase(self, trainer):
        t = self.tr
        return trainer.StepPhase(
            render_geo=bool(t.get("render_geo", True)),
            use_aggregation=bool(t.get("use_aggregation", True)))

    def _leaves(self, norms: dict) -> dict:
        """The norms of the leaves the step trains."""
        if self.tr.get("use_aggregation", True):
            return norms
        return {k: v for k, v in norms.items() if not k.startswith("net.")}

    # ---- program -------------------------------------------------------
    def setup(self):
        c, t = self.ctx, self.tr
        self.scene = s = c["config_module"].build(
            c["config"], t, c["seed"], c["device"])
        self.port = P = self._side(sides.port_modules())
        rng = np.random.default_rng(c["seed"])
        self.order = [int(i) for i in rng.permutation(s.train_ids)]
        state = P.train_state()
        with torch.no_grad():
            cache = {j: P.depth(state.model, j)
                     for j in self._used_views(self.order)}
        self.srcs = {i: P.sources(i, cache, P.cams[i]) for i in self.order}
        self.phase = self._phase(P.m.trainer)
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
                self.prog_grads = self._leaves(
                    compare.grad_norms(self.state))
        self.prog_change = self._leaves(compare.leaf_norms(
            self.state, base=compare.base_leaves(s)))
        while self.k < max(n_cmp, len(self.order)):
            self._step()
        torch.cuda.synchronize()
        self.bad = torch.zeros((), dtype=torch.int64, device=c["device"])

    # ---- check ---------------------------------------------------------
    def reference(self, lowered=None) -> dict:
        from benchmark.reference import blend as rblend
        from benchmark.reference import precision

        t, s = self.tr, self.scene
        n_cmp = int(t["compared_steps"])
        order = [self.order[k % len(self.order)] for k in range(n_cmp)]
        R = self._side(sides.reference_modules())
        low = (precision.lowered(lowered) if lowered is not None
               else contextlib.nullcontext())
        with low:
            state = R.train_state()
            cache = {j: R.depth(state.model, j)
                     for j in self._used_views(order)}
            step = R.m.trainer.make_train_step(R.opt, R.rcfg, state.net,
                                               self._phase(R.m.trainer))
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
                    grads = compare.floats(self._leaves(
                        compare.grad_norms(state)))
            change = compare.floats(self._leaves(compare.leaf_norms(
                state, base=compare.base_leaves(s))))
        return {"losses": losses, "grads": grads, "change": change,
                "blends": rec}

    def check(self, limits: dict, lowered=None):
        checks, detail, work = super().check(limits, lowered)
        # the first step's exposure-table gradient: nonzero only where the
        # step took the exposed L1 (use_app on, SSIM loss under 0.5)
        detail["app_ab_grad"] = float(self.prog_grads["app_ab"])
        return checks, detail, work

    def work(self, blends) -> dict:
        geom = self.geom
        if not self.phase.render_geo:
            geom = dict(geom, S=0, visible=0)
        return work_record("train", self.scene, geom, blends)
