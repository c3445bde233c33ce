"""Image metrics: PSNR, SSIM and LPIPS over saved renders (counterpart of
ibgs_tpu/eval/metrics.py).

`evaluate_model_dir` scores each test/ours_N/{renders, renders_aggregate}
against test/ours_N/gt and writes results_<split>.json and
per_view_<split>.json, the JAX package's layout and keys.  PSNR is float64
numpy on the host, SSIM the port's exact-float32 `train/losses.ssim` on
`device`.  LPIPS needs a local weights file named by $IBGS_LPIPS_WEIGHTS
(layout in `eval/lpips.py`); without one it is null, as in the JAX
package.  PNGs are read by `utils/image_io`.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ibgs_tpu_torch.train import losses
from ibgs_tpu_torch.utils import image_io


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float(-10.0 * np.log10(mse + 1e-12))


def ssim(a: np.ndarray, b: np.ndarray, device="cuda") -> float:
    dev = torch.device(device)
    return float(losses.ssim(torch.as_tensor(a).to(dev),
                             torch.as_tensor(b).to(dev)))


def lpips_fn(device="cuda"):
    """The LPIPS metric of $IBGS_LPIPS_WEIGHTS, or None."""
    path = os.environ.get("IBGS_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    from ibgs_tpu_torch.eval.lpips import LPIPS
    return LPIPS.from_npz(path, device)


def evaluate_dirs(render_dir: str, gt_dir: str, device="cuda"):
    """Per-image and mean metrics over paired directories of RGB images
    (the render driver's PNGs)."""
    names = sorted(os.listdir(render_dir))
    lp = lpips_fn(device)
    per_view = {"psnr": {}, "ssim": {}, "lpips": {}}
    for nm in names:
        r = (image_io.read_image(os.path.join(render_dir, nm))
             / 255.0).astype(np.float32)
        g = (image_io.read_image(os.path.join(gt_dir, nm))
             / 255.0).astype(np.float32)
        per_view["psnr"][nm] = psnr(r, g)
        per_view["ssim"][nm] = ssim(r, g, device)
        if lp is not None:
            per_view["lpips"][nm] = float(lp(r, g))
    mean = {k: (float(np.mean(list(v.values()))) if v else None)
            for k, v in per_view.items()}
    return mean, per_view


def evaluate_model_dir(model_path: str,
                       splits=("renders", "renders_aggregate"),
                       device="cuda"):
    """Score every test/ours_N/<split> of a model directory; returns
    {"ours_N/<split>": mean metrics} and writes the JSON files."""
    results = {}
    test_root = os.path.join(model_path, "test")
    if not os.path.exists(test_root):
        return results
    for ours in sorted(os.listdir(test_root)):
        base = os.path.join(test_root, ours)
        gt_dir = os.path.join(base, "gt")
        for split in splits:
            rdir = os.path.join(base, split)
            if not (os.path.isdir(rdir) and os.path.isdir(gt_dir)
                    and os.listdir(rdir)):
                continue
            mean, per_view = evaluate_dirs(rdir, gt_dir, device)
            results[f"{ours}/{split}"] = mean
            with open(os.path.join(model_path,
                                   f"results_{split}.json"), "w") as f:
                json.dump({ours: {"PSNR": mean["psnr"],
                                  "SSIM": mean["ssim"],
                                  "LPIPS": mean["lpips"]}}, f, indent=2)
            with open(os.path.join(model_path,
                                   f"per_view_{split}.json"), "w") as f:
                json.dump(per_view, f, indent=2)
    return results
