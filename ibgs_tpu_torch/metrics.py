"""Metrics CLI of the port (counterpart of the root metrics.py): PSNR,
SSIM and LPIPS of each model directory's test renders.

    python -m ibgs_tpu_torch.metrics -m <model_dir> [<model_dir> ...] \\
        [--device cuda]

Writes results_<split>.json and per_view_<split>.json into each directory
(`eval/metrics.evaluate_model_dir`) and prints one line per split.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="ibgs_tpu_torch metrics")
    p.add_argument("--model_path", "-m", required=True, nargs="+")
    p.add_argument("--device", default="cuda",
                   help="torch device of the SSIM / LPIPS (default cuda)")
    args = p.parse_args(argv)
    from ibgs_tpu_torch.eval.metrics import evaluate_model_dir
    for mp in args.model_path:
        print("evaluating", mp)
        results = evaluate_model_dir(mp, device=args.device)
        for k, v in results.items():
            print(f"  {k}: PSNR {v['psnr']:.3f}  SSIM {v['ssim']:.4f}  "
                  f"LPIPS {v['lpips']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
