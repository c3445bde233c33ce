"""The port's SIBR viewer bridge (ibgs_tpu_torch/eval/viewer.py) and the
training loop's viewer hook.

* the loopback round trip of tests/test_viewer.py against the port: the
  RGB bytes, the verify string, the camera at the origin (1e-6);
* `receive_camera` of the port and of ibgs_tpu on the same message bytes:
  the same camera (view, projection, centre and intrinsics within 1e-6);
* `train(..., viewer_port=0)` on a tiny synthetic scene, a client whose
  message waits before the first iteration: the reply is the viewer's
  resolution of bytes and the verify string, and the run takes exactly one
  forward blend more than its iterations (a plain render, sources off),
  counted on the plain blend that the CPU runs.
"""
import json
import socket
import struct
import threading
import time

import numpy as np

from ibgs_tpu.eval import viewer as jviewer
from ibgs_tpu_torch.eval import viewer as tviewer
from tests.test_torch_slice import one_torch_thread  # noqa: F401

CAM_TOL = 1e-6


def _message(W, H, seed=0):
    """A SIBR camera message: a look-at view, transposed, y and z columns
    negated."""
    r = np.random.default_rng(seed)
    eye = r.uniform(-1, 1, 3) + np.array([0, 0, -3.0])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0, -1, 0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], 1)
    V = np.eye(4)
    V[:3, :3], V[:3, 3] = R.T, -R.T @ eye
    wvt = V.T.copy()
    wvt[:, 1] *= -1
    wvt[:, 2] *= -1
    return {"resolution_x": W, "resolution_y": H, "train": True,
            "fov_x": 0.9, "fov_y": 0.6, "z_near": 0.01, "z_far": 100.0,
            "shs_python": False, "rot_scale_python": False,
            "keep_alive": True, "scaling_modifier": 1.0,
            "view_matrix": wvt.reshape(-1).tolist(),
            "view_projection_matrix": np.eye(4).reshape(-1).tolist()}


def _packed(msg):
    payload = json.dumps(msg).encode()
    return struct.pack("<i", len(payload)) + payload


def _read_reply(s, H, W):
    img = b""
    while len(img) < H * W * 3:
        img += s.recv(H * W * 3 - len(img))
    (n,) = struct.unpack("<i", s.recv(4))
    return np.frombuffer(img, np.uint8).reshape(H, W, 3), s.recv(n).decode()


def test_viewer_roundtrip():
    H, W = 16, 32
    port = tviewer.init(port=0)
    try:
        view = np.eye(4)
        view[:, 1] *= -1
        view[:, 2] *= -1
        msg = dict(_message(W, H), view_matrix=view.T.reshape(-1).tolist(),
                   fov_x=1.0)
        out = {}

        def client():
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=10) as s:
                s.sendall(_packed(msg))
                out["img"], out["verify"] = _read_reply(s, H, W)

        t = threading.Thread(target=client)
        t.start()
        got = {}

        def render_fn(cam, m):
            got["cam"] = cam
            img = np.zeros((H, W, 3), np.float32)
            img[..., 0] = 0.5
            return img

        for _ in range(500):
            tviewer.serve_once(render_fn, verify="ok", device="cpu")
            if "cam" in got:
                break
            time.sleep(0.02)
        t.join(timeout=10)
        assert not t.is_alive()
        assert out["verify"] == "ok" and out["img"].shape == (H, W, 3)
        assert int(out["img"][0, 0, 0]) == 127 and int(out["img"].max()) == 127
        assert (got["cam"].width, got["cam"].height) == (W, H)
        np.testing.assert_allclose(got["cam"].cam_pos.numpy(), np.zeros(3),
                                   atol=CAM_TOL)
    finally:
        tviewer.shutdown()


def test_receive_camera_matches_jax():
    msg = _message(40, 24, seed=3)
    cams = {}
    for name, mod, kw in (("port", tviewer, {"device": "cpu"}),
                          ("jax", jviewer, {})):
        a, b = socket.socketpair()
        try:
            b.sendall(_packed(msg))
            mod._conn = a
            cams[name], got_msg = mod.receive_camera(**kw)
            assert got_msg == msg
        finally:
            mod._conn = None
            a.close()
            b.close()
    t, j = cams["port"], cams["jax"]
    assert (t.width, t.height) == (j.width, j.height) == (40, 24)
    for k in ("view", "proj", "full_proj", "cam_pos"):
        np.testing.assert_allclose(getattr(t, k).numpy(),
                                   np.asarray(getattr(j, k)), rtol=0,
                                   atol=CAM_TOL, err_msg=k)
    for k in ("fx", "fy", "cx", "cy"):
        assert abs(getattr(t, k) - float(getattr(j, k))) <= CAM_TOL * abs(
            float(getattr(j, k)))
    a, b = socket.socketpair()
    try:
        b.sendall(_packed(dict(msg, resolution_x=0)))
        tviewer._conn = a
        cam, got_msg = tviewer.receive_camera(device="cpu")
    finally:
        tviewer._conn = None
        a.close()
        b.close()
    assert cam is None and got_msg["resolution_x"] == 0


def test_training_loop_serves_one_viewer_frame(tmp_path, monkeypatch):
    from ibgs_tpu_torch.config import (ModelParams, OptimizationParams,
                                       PipelineParams)
    from ibgs_tpu_torch.data.synthetic import make_synthetic_scene
    from ibgs_tpu_torch.ops import blend
    from ibgs_tpu_torch.train import loop

    scene = make_synthetic_scene(n_views=4, width=32, height=32, n_gt=300,
                                 n_seed=150, device="cpu")
    opt = OptimizationParams(iterations=3, use_color_aggregation=False,
                             single_view_weight_from_iter=10_000,
                             multi_view_weight_from_iter=10_000)
    H, W = 20, 28                        # the viewer's own resolution
    client = {}
    real_init = tviewer.init

    def init(**kw):
        port = real_init(**kw)
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(_packed(_message(W, H, seed=1)))
        client["socket"] = s
        return port

    calls = {"n": 0}
    real_plain = blend.blend_plain

    def counted(*a, **k):
        calls["n"] += 1
        return real_plain(*a, **k)

    monkeypatch.setattr(tviewer, "init", init)
    monkeypatch.setattr(blend, "blend_plain", counted)
    try:
        loop.train(scene, ModelParams(), opt, PipelineParams(),
                   str(tmp_path), save_iterations=(), test_iterations=(),
                   quiet=True, viewer_port=0, device="cpu")
        img, verify = _read_reply(client["socket"], H, W)
    finally:
        if "socket" in client:
            client["socket"].close()
        tviewer.shutdown()
    assert calls["n"] == opt.iterations + 1
    assert verify == "1" and img.shape == (H, W, 3) and img.any()
    assert tviewer._listener is None
