"""Benchmark-suite runner of the port (counterpart of the root
exp_script.py): chains train → render → metrics over the standard scene
suites with their per-dataset flags, each stage a `python -m
ibgs_tpu_torch.{train,render,metrics}` subprocess on `--device`.

    python -m ibgs_tpu_torch.exp_script --data_root /data \\
        --out_root ./output [--suites m360_indoor m360_outdoor db shiny tnt] \\
        [--scenes <dir> ...] [--device cuda] [--extra <train flags> ...]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITES = {
    "m360_indoor": dict(
        scenes=["bonsai", "counter", "kitchen", "room"],
        flags=["-r", "2", "--eval"]),
    "m360_outdoor": dict(
        scenes=["bicycle", "flowers", "garden", "stump", "treehill"],
        flags=["-r", "4", "--eval"]),
    "db": dict(
        scenes=["drjohnson", "playroom"],
        flags=["-r", "1", "--eval", "--multi_view_max_angle", "50",
               "--multi_view_max_dis", "4.5"]),
    "shiny": dict(
        scenes=["guitars", "lab", "cd"],
        flags=["-r", "1008", "--eval", "--multi_view_max_angle", "50",
               "--multi_view_max_dis", "4.5"]),
    "tnt": dict(
        scenes=["train", "truck"],
        flags=["-r", "2", "--eval", "--exposure_compensation",
               "--enable_exposure_correction"]),
}


def run(cmd):
    print("+", " ".join(cmd), flush=True)
    # the stages import the package from wherever this one was imported
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    subprocess.run(cmd, check=True, env=env)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ibgs_tpu_torch suite runner")
    p.add_argument("--data_root", required=True)
    p.add_argument("--out_root", default="./output")
    p.add_argument("--suites", nargs="+", default=list(SUITES))
    p.add_argument("--scenes", nargs="+", default=None,
                   help="explicit scene dirs under data_root (bypasses "
                        "--suites; flags come from --extra only)")
    p.add_argument("--device", default="cuda",
                   help="torch device of every stage (default cuda)")
    p.add_argument("--extra", nargs="*", default=[])
    # unknown flags pass through to training (argparse's nargs="*" refuses
    # tokens that look like options, so `--extra --eval ...` lands here)
    args, unknown = p.parse_known_args(argv)
    args.extra = list(args.extra) + list(unknown)
    return args


def commands(args):
    """The stages' command lines, in order: per scene, train, render
    (test split only) and metrics."""
    py = sys.executable
    if args.scenes:
        suites = [("custom", dict(scenes=args.scenes, flags=[]))]
    else:
        suites = [(s, SUITES[s]) for s in args.suites]
    dev = ["--device", args.device]
    cmds = []
    for suite, cfg in suites:
        for scene in cfg["scenes"]:
            src = os.path.join(args.data_root, scene)
            out = os.path.join(args.out_root, suite, scene)
            cmds += [
                [py, "-m", "ibgs_tpu_torch.train", "-s", src, "-m", out,
                 *cfg["flags"], *args.extra, *dev],
                [py, "-m", "ibgs_tpu_torch.render", "-m", out,
                 "--skip_train", *dev],
                [py, "-m", "ibgs_tpu_torch.metrics", "-m", out, *dev]]
    return cmds


def main(argv=None):
    for cmd in commands(parse_args(argv)):
        run(cmd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
