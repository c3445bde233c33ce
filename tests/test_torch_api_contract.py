"""Input validation of the port's `rasterize` against the JAX package's
(tests/test_api_contract.py; reference diff_plane_rasterization/
__init__.py:294-316).

Each case builds one set of numpy inputs (20 splats facing a 32x32 view),
runs the JAX `rasterize` (oracle backend, CPU) and the port's on them, and
expects both to raise `ValueError` with the same message; the last case
passes `rgb_override` alone, which both accept and render finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ibgs_tpu.ops.rasterize import rasterize as jrasterize
from ibgs_tpu_torch.core.camera import look_at_camera
from ibgs_tpu_torch.ops.rasterize import RasterConfig, rasterize
from tests.test_torch_slice import one_torch_thread  # noqa: F401
from tests.utils import face_camera, random_cloud, simple_camera

P = 20


def _inputs():
    cam = simple_camera(32, 32)
    p = face_camera(random_cloud(jax.random.PRNGKey(0), P), cam)
    return {k: np.array(v, np.float32) for k, v in p.items()}


def _bad(p, case):
    """The keyword inputs of one case (numpy), colour sources included."""
    r = np.random.default_rng(1)
    kw = dict(p)
    if case == "scale_width_2":
        kw["scale"] = p["scale"][:, :2]
    elif case == "both_colour_sources":
        kw["rgb_override"] = np.zeros((P, 3), np.float32)
    elif case == "sh_last_dim_4":
        kw["sh_coeffs"] = r.uniform(-1, 1, (P, 1, 4)).astype(np.float32)
    elif case == "sh_extra_rows":
        kw["sh_coeffs"] = r.uniform(-1, 1, (P + 3, 1, 3)).astype(np.float32)
    elif case in ("rgb_width_4", "rgb_width_1", "rgb_only"):
        width = {"rgb_width_4": 4, "rgb_width_1": 1, "rgb_only": 3}[case]
        kw["sh_coeffs"] = None
        kw["rgb_override"] = np.full((P, width), 0.7, np.float32)
    return kw


def _jax(kw):
    return jrasterize(
        **{k: (None if v is None else jnp.asarray(v)) for k, v in kw.items()},
        active_sh_degree=0, cam=simple_camera(32, 32), bg=jnp.zeros(3),
        cfg=JRasterConfig(instance_cap=2048, backend="oracle"),
        render_geo=False)


def _port(kw):
    cam = look_at_camera([0.0, 0.0, -3.0], [0.0, 0.0, 0.0],
                         [0.0, -1.0, 0.0], 0.8, 0.8, 32, 32, device="cpu")
    return rasterize(
        **{k: (None if v is None else torch.as_tensor(v))
           for k, v in kw.items()},
        active_sh_degree=0, cam=cam, bg=torch.zeros(3), cfg=RasterConfig(),
        render_geo=False)


@pytest.mark.parametrize("case", ["scale_width_2", "both_colour_sources",
                                  "sh_last_dim_4", "sh_extra_rows",
                                  "rgb_width_4", "rgb_width_1", "rgb_only"])
def test_rasterize_input_contract_matches_jax(case):
    kw = _bad(_inputs(), case)
    if case == "rgb_only":
        j, t = _jax(kw), _port(kw)
        assert np.isfinite(np.asarray(j.render)).all()
        assert bool(torch.isfinite(t.render).all())
        return
    with pytest.raises(ValueError) as jerr:
        _jax(kw)
    with pytest.raises(ValueError) as terr:
        _port(kw)
    assert str(terr.value) == str(jerr.value)
