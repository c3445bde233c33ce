"""Live network viewer bridge, SIBR remote-viewer protocol (counterpart of
ibgs_tpu/eval/viewer.py, the same bytes on the wire).

A non-blocking TCP listener takes one viewer connection; each message is
a little-endian int32 length and a JSON camera, and each reply the
rendered RGB bytes, then a length-prefixed verify string.  The training
loop calls `serve_once` every iteration (`train/loop.train(...,
viewer_port=...)`): one non-blocking accept when no viewer is attached.
The listener and the connection are this module's state, one viewer per
process, as in the JAX package.
"""
from __future__ import annotations

import json
import select
import socket
import struct
import traceback

import numpy as np
import torch

from ibgs_tpu_torch.core.camera import make_camera

_listener = None
_conn = None


def init(host="127.0.0.1", port=6009):
    """Listen on (host, port); port 0 takes a free one.  Returns the
    port."""
    global _listener
    _listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    _listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    _listener.bind((host, port))
    _listener.listen()
    _listener.settimeout(0)
    return _listener.getsockname()[1]


def shutdown():
    global _listener, _conn
    for s in (_conn, _listener):
        try:
            if s is not None:
                s.close()
        except OSError:
            pass
    _listener = _conn = None


def try_connect():
    global _conn
    if _listener is None or _conn is not None:
        return
    try:
        _conn, _addr = _listener.accept()
        _conn.settimeout(None)
    except (BlockingIOError, OSError):
        pass


def _read_bytes(n):
    data = b""
    while len(data) < n:
        chunk = _conn.recv(n - len(data))
        if not chunk:
            raise ConnectionError("viewer disconnected")
        data += chunk
    return data


def receive_camera(device="cuda"):
    """Read one viewer message: (camera on `device` or None, payload
    dict).  The view matrix arrives transposed with its y and z columns
    negated; it becomes a COLMAP-style camera (R camera → world, t world
    → camera).  A zero resolution gives no camera."""
    (nbytes,) = struct.unpack("<i", _read_bytes(4))
    msg = json.loads(_read_bytes(nbytes).decode("utf-8"))
    width, height = msg["resolution_x"], msg["resolution_y"]
    if width == 0 or height == 0:
        return None, msg
    wvt = np.array(msg["view_matrix"], np.float64).reshape(4, 4)
    wvt[:, 1] *= -1.0
    wvt[:, 2] *= -1.0
    V = wvt.T
    cam = make_camera(V[:3, :3].T, V[:3, 3], msg["fov_x"], msg["fov_y"],
                      width, height, device)
    return cam, msg


def send_image(img, verify="1"):
    """Reply: the image's RGB bytes (truncated to 8 bits), then the
    length-prefixed verify string."""
    if _conn is None:
        return
    if img is not None:
        arr = img.detach().cpu().numpy() if torch.is_tensor(img) else img
        arr = (np.clip(np.asarray(arr), 0, 1) * 255).astype(np.uint8)
        _conn.sendall(arr.tobytes())
    _conn.sendall(struct.pack("<i", len(verify)))
    _conn.sendall(verify.encode("ascii"))


def serve_once(render_fn, verify="1", device="cuda"):
    """Serve at most one pending viewer message.  `render_fn(cam, msg)`
    returns an (H, W, 3) image in [0, 1].  Returns False when the viewer
    asks to stop training, True otherwise.  Safe to call every
    iteration."""
    global _conn
    if _listener is None:
        return True
    try_connect()
    if _conn is None:
        return True
    r, _, _ = select.select([_conn], [], [], 0)
    if not r:
        return True
    try:
        cam, msg = receive_camera(device)
        img = render_fn(cam, msg) if cam is not None else None
        send_image(img, verify)
        if msg.get("train") is False and not msg.get("keep_alive", True):
            return False
    except (ConnectionError, OSError):
        traceback.print_exc()
        try:
            _conn.close()
        except OSError:
            pass
        _conn = None
    return True
