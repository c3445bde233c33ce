"""The port's training driver on a 1 x 2 Gaussian-sharded mesh (two gloo
processes on the CPU, tests/torch_parallel_ranks.loop2) and the train
CLI's mesh flags.

Scene: the synthetic scene, 6 views at 32x64, 400 ground-truth and 150
seed splats.  Schedule: 24 iterations, one densify event at 8, geometry
rendering from 9.  Checked:

* the first 8 iterations' image losses (before the densify event, which
  draws other noise per shard) within rtol 1e-3 of the single-process
  loop's on the same camera sequence (test_torch_loop.py's bound);
* every logged loss finite, no non-finite gradient, the mean image loss
  of the last 5 iterations below the first 5's;
* the densify event ran shard-local (`gsp_shards` 2) and changed the
  alive count; both ranks hold the same gathered model;
* the checkpoint at 24 equals the gathered model exactly, and a resume
  from it runs 2 more steps;
* `python -m ibgs_tpu_torch.train --gsp_shards 1 --device cpu` trains on
  a 1 x 1 mesh and prints the mesh line.
"""
import json
import os

import numpy as np
import torch

from ibgs_tpu_torch.config import (ModelParams, OptimizationParams,
                                   PipelineParams)
from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
from ibgs_tpu_torch.models import gaussians as tg
from ibgs_tpu_torch.parallel import _spawn
from ibgs_tpu_torch.train import __main__ as train_cli
from ibgs_tpu_torch.train.loop import train
from tests.test_torch_slice import one_torch_thread  # noqa: F401

OPT = dict(iterations=24, densify_from_iter=4, densification_interval=8,
           densify_until_iter=10, opacity_reset_interval=10_000,
           single_view_weight_from_iter=18, multi_view_weight_from_iter=18,
           use_color_aggregation=False, number_src_frames=2,
           nb_visible_src_frames=2, position_lr_max_steps=24)
SCENE = dict(n_views=6, width=32, height=64, n_gt=400, n_seed=150)


def _log(path, name="train_log.jsonl"):
    with open(os.path.join(path, name)) as f:
        return [json.loads(line) for line in f]


def test_loop_trains_on_a_two_rank_mesh(tmp_path):
    path = str(tmp_path / "run")
    r0, r1 = _spawn.run("tests.torch_parallel_ranks:loop2", 2,
                        str(tmp_path / "spawn"),
                        dict(opt=OPT, scene=SCENE, model_path=path))
    log = _log(path)
    assert [r["iter"] for r in log] == list(range(1, OPT["iterations"] + 1))
    loss = np.array([r["image_loss"] for r in log])
    assert np.isfinite(loss).all()
    assert all(r["nonfinite_grads"] == 0 for r in log)
    assert loss[-5:].mean() < loss[:5].mean(), loss

    # before the densify event, the single-process loop's losses
    base = str(tmp_path / "single")
    train(make_synthetic_scene(**SCENE, device="cpu"),
          ModelParams(sh_degree=1), OptimizationParams(**dict(
              OPT, iterations=8)), PipelineParams(), base,
          save_iterations=(), test_iterations=(), log_every=1, quiet=True,
          device="cpu")
    want = [r["image_loss"] for r in _log(base)]
    np.testing.assert_allclose(loss[:8], want, rtol=1e-3)

    events = _log(path, "densify_log.jsonl")
    assert [e["iter"] for e in events] == [8]
    assert events[0]["gsp_shards"] == 2
    assert events[0]["n_alive_after"] != events[0]["n_alive_before"]
    for tree in ("params", "mu", "nu"):
        for k in tg.PARAM_FIELDS:
            np.testing.assert_array_equal(r0["model"][tree][k],
                                          r1["model"][tree][k])
    ck = r0["checkpoint"]
    for tree in ("params", "mu", "nu"):
        for k in tg.PARAM_FIELDS:
            np.testing.assert_array_equal(ck[f"{tree}.{k}"],
                                          r0["model"][tree][k])
    for k in ("alive",) + tg.STAT_FIELDS:
        np.testing.assert_array_equal(ck[k], r0["model"][k])
    assert int(ck["step"]) == r0["step"] == OPT["iterations"]
    assert r0["resumed_step"] == OPT["iterations"] + 2
    assert os.path.exists(os.path.join(
        path, "point_cloud", f"iteration_{OPT['iterations']}",
        "point_cloud.ply"))


def test_train_cli_on_a_one_rank_mesh(tmp_path, capsys):
    out = str(tmp_path / "cli")
    assert train_cli.main([
        "--synthetic", "--synthetic_spec", "4", "32", "32", "300", "150",
        "--iterations", "3", "--device", "cpu", "-m", out, "--quiet",
        "--gsp_shards", "1", "--checkpoint_iterations", "3"]) == 0
    assert "GSP mesh: 1 x 1 devices across 1 process(es)" in \
        capsys.readouterr().out
    assert not torch.distributed.is_initialized()
    assert [r["iter"] for r in _log(out)] == [1]    # log_every 200
    assert os.path.exists(os.path.join(out, "chkpnt3.npz"))
