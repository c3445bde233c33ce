"""The port's snapshot replay against the JAX package's, on the CPU.

`ibgs_tpu_torch.scripts.replay_snapshot.replay`'s per-term, per-leaf
non-finite gradient counts and input health equal the JAX
scripts/replay_snapshot.py's printed ones (oracle backend; its
REPLAY_* settings for a 4-view 32x32 synthetic scene, instance cap
4,096) on two snapshots:

* one written by the port's training loop in debug mode: a NaN seed point
  makes the first step's gradients non-finite, so the loop dumps its
  inputs and raises;
* one in the JAX loop's format, built from the JAX package's own scene,
  model and source pack, with one alive row's log_scale NaN.

Both snapshots hold 512 slots, the JAX model's default for 100 seeds, so
the second JAX replay reuses the first one's compiled operations, and the
JAX scene (deterministic in its arguments) is built once for the file.
"""
import dataclasses
import functools
import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ibgs_tpu.data import synthetic as jsynthetic
from ibgs_tpu.models import gaussians as jg
from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
from ibgs_tpu_torch.models.gaussians import PARAM_FIELDS
from ibgs_tpu_torch.scripts import replay_snapshot as treplay
from tests.test_torch_slice import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REPLAY_SCENE = dict(n_views=4, width=32, height=32, n_gt=200, n_seed=100,
                    eval_every=8)
REPLAY_CAP = 4096
_TERM_RE = re.compile(r"^term (\w+): value")
_GRAD_RE = re.compile(r"^\s+grad\[(\w+)\]: (\d+) non-finite in (\d+) rows")
_IN_RE = re.compile(r"^\s+in\[(\w+)\]: nonfinite (\d+)")


_jax_scene = functools.lru_cache(maxsize=None)(
    jsynthetic.make_synthetic_scene)


def _jax_replay(path, monkeypatch, capsys):
    """The JAX replay's printed per-term, per-leaf counts and input
    health."""
    monkeypatch.setattr(jsynthetic, "make_synthetic_scene", _jax_scene)
    for k, v in dict(REPLAY_VIEWS=4, REPLAY_GT=200, REPLAY_SEED_PTS=100,
                     REPLAY_CAP=REPLAY_CAP).items():
        monkeypatch.setenv(k, str(v))
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["replay_snapshot.py", path, "32x32"])
    capsys.readouterr()
    _load("jax_replay", "scripts/replay_snapshot.py").main()
    terms, health, cur = {}, {}, None
    for line in capsys.readouterr().out.splitlines():
        if m := _TERM_RE.match(line):
            cur = terms.setdefault(m.group(1), {})
        elif m := _GRAD_RE.match(line):
            cur[m.group(1)] = [int(m.group(2)), int(m.group(3))]
        elif m := _IN_RE.match(line):
            health[m.group(1)] = int(m.group(2))
    return terms, health


def _port_snapshot(tmp_path):
    """A snapshot written by the port's loop in debug mode: one seed point
    is NaN, so the first step's gradients are not finite."""
    from ibgs_tpu_torch.config import (ModelParams, OptimizationParams,
                                       PipelineParams)
    from ibgs_tpu_torch.train.loop import train
    scene = make_synthetic_scene(**REPLAY_SCENE, device="cpu")
    pts = scene.points.copy()
    pts[7] = np.nan
    opt = OptimizationParams(
        iterations=2, use_color_aggregation=False,
        single_view_weight_from_iter=10_000,
        multi_view_weight_from_iter=10_000, number_src_frames=2,
        position_lr_max_steps=10)
    with pytest.raises(FloatingPointError, match="snapshot_fw"):
        train(dataclasses.replace(scene, points=pts),
              ModelParams(init_capacity=512), opt,
              PipelineParams(instance_cap=1 << 14, debug=True),
              str(tmp_path), save_iterations=(), test_iterations=(),
              log_every=1, quiet=True, device="cpu")
    return str(tmp_path / "snapshot_fw.npz")


def _jax_format_snapshot(tmp_path):
    """A snapshot with the JAX loop's keys, built from the JAX package's
    own scene, model and source pack; alive row 5's log_scale is NaN."""
    from ibgs_tpu.renderer import source_views_from_stacks
    js = _jax_scene(**REPLAY_SCENE)
    m = jg.init_from_points(js.points, js.colors, 2)
    p = {k: np.array(getattr(m.params, k)) for k in PARAM_FIELDS}
    p["log_scale"][5, 1] = np.nan
    cam_idx = 1
    nb = js.nearest_ids[cam_idx][:2]
    idx = np.zeros(5, np.int32)
    idx[:len(nb)] = nb
    H, W = js.images.shape[1:3]
    depths = np.random.default_rng(5).uniform(
        2.0, 4.0, (js.n_train, H, W)).astype(np.float32)
    w2v, centers, _ = js.poses_stack()
    src = source_views_from_stacks(
        jnp.asarray(js.images), jnp.asarray(depths), jnp.asarray(w2v),
        jnp.asarray(centers), jnp.asarray(idx), jnp.int32(len(nb)),
        js.train_cameras[cam_idx])
    path = str(tmp_path / "jax_snapshot.npz")
    np.savez(path, iter=1, cam_idx=cam_idx, src_idx=idx, **p,
             alive=np.asarray(m.alive), gt=np.asarray(js.images[cam_idx]),
             bg=np.zeros(3, np.float32),
             src_images=np.asarray(src.images),
             src_depths=np.asarray(src.depths),
             src_ref_to_src=np.asarray(src.ref_to_src),
             src_cam_pos=np.asarray(src.cam_pos),
             src_count=np.asarray(src.count), burned_in=0.5, use_app=False,
             nonfinite_grads=1)
    return path


@pytest.mark.parametrize("make", [_port_snapshot, _jax_format_snapshot],
                         ids=["port_loop", "jax_format"])
def test_replay_matches_jax(make, tmp_path, monkeypatch, capsys):
    path = make(tmp_path)
    d = dict(np.load(path))
    scene = make_synthetic_scene(**REPLAY_SCENE, device="cpu")
    rep = treplay.replay(d, scene.train_cameras[int(d["cam_idx"])], "cpu",
                         REPLAY_CAP)
    terms, health = _jax_replay(path, monkeypatch, capsys)
    assert sorted(terms) == sorted(rep["terms"]) == sorted(treplay.TERMS)
    for name, rec in rep["terms"].items():
        assert rec["leaves"] == terms[name], name
    assert {k: h["nonfinite"] for k, h in rep["input"].items()} == health
    # the poison shows: the NaN row's leaves, no other row's
    assert all(rec["leaves"] for rec in rep["terms"].values())
    assert all(len(rec["rows"]) == 1 for rec in rep["terms"].values())
