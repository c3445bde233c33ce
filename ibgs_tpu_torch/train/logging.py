"""Training observability (counterpart of ibgs_tpu/train/logging.py):
loss scalars, eval PSNR with render / depth / normal panels, the opacity
histogram and the point count, to TensorBoard through
`torch.utils.tensorboard` when it imports; without it the loop's
train_log.jsonl is the only record.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class TrainLogger:
    def __init__(self, model_path: str):
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(model_path)
        except Exception:
            self.writer = None

    def scalars(self, it: int, values: dict):
        if self.writer is None:
            return
        for k, v in values.items():
            self.writer.add_scalar(k, float(v), it)

    def image(self, it: int, tag: str, img):
        if self.writer is None:
            return
        arr = np.clip(_np(img), 0, 1)
        if arr.ndim == 3 and arr.shape[-1] in (1, 3):
            arr = arr.transpose(2, 0, 1)
        self.writer.add_image(tag, arr, it)

    def histogram(self, it: int, tag: str, values):
        if self.writer is None:
            return
        # logging must never end a training run: drop non-finite values
        # (a NaN-poisoned model otherwise makes add_histogram raise) and
        # record their share instead
        arr = np.asarray(_np(values), np.float32).ravel()
        finite = arr[np.isfinite(arr)]
        if finite.size < arr.size:
            self.scalars(it, {f"{tag}/nonfinite_frac":
                              1.0 - finite.size / max(arr.size, 1)})
        if finite.size == 0:
            return
        try:
            self.writer.add_histogram(tag, torch.from_numpy(finite), it)
        except ValueError:
            pass

    def close(self):
        if self.writer is not None:
            self.writer.close()


def colorize_depth(d):
    """Depth map → an (H, W, 3) colour ramp in [0, 1] (2nd percentile of
    the positive depths to the maximum)."""
    d = _np(d)
    pos = d[d > 0]
    lo = np.percentile(pos, 2) if pos.size else 0.0
    hi = d.max() + 1e-9
    x = np.clip((d - lo) / (hi - lo + 1e-9), 0, 1)
    r = np.clip(1.5 * x, 0, 1)
    g = np.clip(1.5 * x - 0.4, 0, 1)
    b = np.clip(2.0 * x - 1.2, 0, 1) + (1 - x) * 0.15
    return np.stack([r, g, np.clip(b, 0, 1)], -1)
