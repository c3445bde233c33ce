"""The two sides a run builds from one Scene: the port (`ibgs_tpu_torch`,
the system under test) and the reference (`benchmark.reference`).  Their
modules have the same names and calls, so one builder serves both; each
side gets its own copies of the scene's tensors.
"""
from __future__ import annotations

import types

import torch

from benchmark import scene as sc


def port_modules():
    from ibgs_tpu_torch import config, renderer
    from ibgs_tpu_torch.core import camera
    from ibgs_tpu_torch.eval import render_driver
    from ibgs_tpu_torch.models import aggregation, gaussians
    from ibgs_tpu_torch.ops import rasterize
    from ibgs_tpu_torch.train import trainer
    return types.SimpleNamespace(
        name="port", config=config, renderer=renderer, camera=camera,
        aggregation=aggregation, gaussians=gaussians, rasterize=rasterize,
        trainer=trainer, render_driver=render_driver)


def reference_modules():
    from benchmark.reference import (aggregation, camera, config, gaussians,
                                     rasterize, renderer, serve, trainer)
    return types.SimpleNamespace(
        name="reference", config=config, renderer=renderer, camera=camera,
        aggregation=aggregation, gaussians=gaussians, rasterize=rasterize,
        trainer=trainer, serve=serve)


class Side:
    """One side's options, cameras, model, net and source packs."""

    def __init__(self, m, scene: sc.Scene, device):
        self.m, self.scene, self.device = m, scene, device
        self.opt = m.config.OptimizationParams()
        self.rcfg = m.rasterize.RasterConfig(
            buffer_len=self.opt.buffer_length,
            depth_error_threshold=self.opt.depth_error_threshold,
            staircase_cull=True)
        self.cams = [self.camera(v) for v in scene.views]
        self.w2v = torch.stack([c.view for c in self.cams])
        self.centers = torch.stack([c.cam_pos for c in self.cams])
        self.bg = torch.zeros(3, device=device)

    def camera(self, view):
        s = self.scene
        return self.m.camera.camera_from_view(view, s.fovx, s.fovy, s.width,
                                              s.height, self.device)

    def model(self):
        g = self.m.gaussians
        s = self.scene
        params = g.GaussianParams(**{k: v.clone() for k, v in
                                     s.params.items()})
        model = g.GaussianModel(params=params, alive=s.alive.clone(),
                                active_sh_degree=s.sh_degree,
                                max_sh_degree=s.sh_degree)
        return g.with_train_state(model)

    def net(self):
        s = self.scene
        net = self.m.aggregation.ColorFusionResidualNet(
            s.net_width, self.opt.feat_aggregate_mode).to(self.device)
        net.load_state_dict({k: v.clone() for k, v in s.net.items()})
        return net

    def train_state(self):
        t = self.m.trainer
        net = self.net()
        app = self.scene.app_ab.clone()
        return t.TrainState(
            model=self.model(), app_ab=app, app_opt=t.SideOptState.init([app]),
            net=net, net_opt=t.SideOptState.init(list(net.parameters())),
            spatial_lr_scale=float(self.scene.extent))

    def depth(self, model, i: int):
        with torch.no_grad():
            return self.m.renderer.render_depth_view(
                model, self.cams[i], self.rcfg, self.opt.learnt_normal)

    def sources(self, i: int, depths: dict, cam):
        """The source pack of view i: its nearest views' images, the
        cached depths `depths[j]`, transforms and centres, padded to
        rcfg.max_src with view 0 and zero depths."""
        nbrs = self.scene.nearest[i][: self.opt.number_src_frames]
        S = self.rcfg.max_src
        idx = torch.zeros(S, dtype=torch.long)
        idx[: len(nbrs)] = torch.as_tensor(nbrs, dtype=torch.long)
        idx = idx.to(self.device)
        dstack = torch.stack([depths[j] for j in nbrs]
                             + [torch.zeros_like(depths[nbrs[0]])]
                             * (S - len(nbrs)))
        return self.m.renderer.source_views_from_stacks(
            self.scene.images[idx], dstack, self.w2v[idx],
            self.centers[idx], torch.arange(S, device=self.device),
            len(nbrs), cam)

    def stacks(self):
        return dict(images=self.scene.images, w2v=self.w2v,
                    centers=self.centers)


def geometry(side: Side) -> dict:
    """The sizes the layer counts read from one side's options."""
    return {"B": side.rcfg.buffer_len, "S": side.rcfg.max_src,
            "th": side.rcfg.tile_h, "tw": side.rcfg.tile_w,
            "visible": side.opt.nb_visible_src_frames}


def work_record(kind: str, scene: sc.Scene, geom: dict, blends: list
                ) -> dict:
    """The record rooflines/*.py count from: the shapes of one step or
    view and the reference's blends of it (pair counts)."""
    th, tw = geom["th"], geom["tw"]
    tiles = (-(-scene.width // tw)) * (-(-scene.height // th))
    return {"kind": kind, "P": scene.capacity,
            "K": (scene.sh_degree + 1) ** 2, "W": scene.width,
            "H": scene.height, "Hs": scene.height, "Ws": scene.width,
            "B": geom["B"], "S": geom["S"], "visible": geom["visible"],
            "tiles": tiles, "net_width": scene.net_width, "blends": blends}
