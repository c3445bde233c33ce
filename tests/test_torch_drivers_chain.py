"""The port's suite runner end to end on the COLMAP fixture, on the CPU.

`python -m ibgs_tpu_torch.exp_script` chains `python -m
ibgs_tpu_torch.train`, `.render` and `.metrics` as subprocesses on
tests/fixtures/mini_colmap with `--device cpu` and the schedule of the JAX
package's tests/test_colmap_e2e.py::test_exp_script_chain_on_fixture (15
iterations, without `--backend`), and is held to that test's assertions:
result_fps_mem.json with positive FPS and Gaussians, a finite test PSNR
above 5, the aggregate results and the per-view file.  The stages run on
one torch thread each (OMP_NUM_THREADS=1), as the suite's workers do.
"""
import json
import os

import numpy as np

from ibgs_tpu_torch import exp_script
from tests.test_torch_slice import one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "mini_colmap")


def test_exp_script_chain_on_fixture(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    exp_script.main([
        "--data_root", os.path.dirname(FIXTURE), "--out_root", str(tmp_path),
        "--scenes", "mini_colmap", "--device", "cpu",
        "--extra",
        "--eval", "--iterations", "15", "--densify_from_iter", "6",
        "--densification_interval", "6", "--densify_until_iter", "12",
        "--single_view_weight_from_iter", "8",
        "--multi_view_weight_from_iter", "8",
        "--use_color_aggregation", "--start_color_aggregation_iter", "10",
        "--color_aggregate_burnin_steps", "3",
        "--number_src_frames", "2", "--nb_visible_src_frames", "2",
        "--position_lr_max_steps", "15", "--multi_view_num", "3",
        "--multi_view_max_angle", "120", "--multi_view_max_dis", "10",
        "--instance_cap", "16384",
        "--save_iterations", "15", "--test_iterations", "15",
        "--checkpoint_iterations", "15", "--quiet",
    ])
    out = os.path.join(str(tmp_path), "custom", "mini_colmap")
    fps = json.load(open(os.path.join(out, "result_fps_mem.json")))
    assert fps["fps"] > 0 and fps["n_gaussians"] > 0
    res = json.load(open(os.path.join(out, "results_renders.json")))
    (vals,) = res.values()
    assert np.isfinite(vals["PSNR"]) and vals["PSNR"] > 5.0
    assert os.path.exists(os.path.join(out, "results_renders_aggregate.json"))
    assert os.path.exists(os.path.join(out, "per_view_renders.json"))
