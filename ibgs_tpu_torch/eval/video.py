"""Fly-through video (counterpart of ibgs_tpu/eval/video.py)."""
from __future__ import annotations

import os

import numpy as np

from ibgs_tpu_torch.core.camera import ellipse_path
from ibgs_tpu_torch.utils import image_io


def render_video(ev, out_path: str, n_frames: int = 120, fps: int = 30):
    """Render an elliptical camera path fitted to the train cameras
    (`ev.scene`'s) through `ev.render_one` (fused frames where the net is
    on) and write an mp4 with cv2's writer when cv2 imports and the writer
    opens; otherwise a PNG sequence in `out_path + "_frames"`.  Returns
    the path written."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    cams = ellipse_path(ev.scene.train_cameras, n_frames=n_frames)
    H, W = ev.H, ev.W
    writer = None
    if cv2 is not None:
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (W, H))
        if not writer.isOpened():
            writer.release()
            writer = None
    frames_dir = None
    nearest = ev.scene.nearest_ids[0]
    for k, cam in enumerate(cams):
        out = ev.render_one(cam, nearest)
        img = out.get("aggregate", out["render"])
        frame = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        if writer is not None:
            writer.write(np.ascontiguousarray(frame[..., ::-1]))
        else:
            frames_dir = out_path + "_frames"
            os.makedirs(frames_dir, exist_ok=True)
            image_io.write_png(os.path.join(frames_dir, f"{k:05d}.png"),
                               frame)
    if writer is not None:
        writer.release()
    return out_path if frames_dir is None else frames_dir
