"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (imports, the card, the inputs made from the seed, the port's
kernels built or loaded, warm-up) is timed from the start of this module
as `setup_s`.  With --trace 0 the window runs for --seconds and gives the
cell's end-to-end metrics; with --trace 1 a traced window gives its
per-layer metrics.  Then the program's state is freed and the reference
checks what the window produced.  The result is the last line of stdout;
the numbers compared, each with its limit, are the last lines of stderr
and the result's last key.  No card, too few cards, a failed check of the
run itself, or a loaded JAX module: a non-zero exit and no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        line = out.stdout.strip().splitlines()[0] if out.stdout else ""
        return line.split(",")[-1].strip() if line else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def context(args):
    """Everything a driver reads: the spec's cell, its configuration and
    traffic (files found by name), the seed and the run's options."""
    spec = harness.load_spec()
    w = harness.cell(spec, args.workload)
    cfg, cfg_mod = harness.config_files(w["config"])
    traffic = harness.traffic(w["traffic"])
    return spec, w, {"config": cfg, "config_module": cfg_mod,
                     "traffic": traffic, "seed": args.seed,
                     "seconds": args.seconds, "trace": bool(args.trace),
                     "cell": w["name"]}


def main(argv=None) -> int:
    args = parse(argv)
    spec, w, ctx = context(args)
    drv = harness.driver(ctx["traffic"]["driver"])
    limits = harness.limits(w["name"])

    import torch
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(w["chips"]):
        print(f"benchmark: {w['name']} needs {w['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx["device"] = dev

    run = drv.Run(ctx)
    run.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    if args.trace:
        rec = run.traced()
    else:
        rec = run.window(args.seconds)
    peak = torch.cuda.max_memory_allocated(dev)
    run.release()

    # the reference checks what the window produced (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    checks, detail, work = run.check(limits)
    print(f"benchmark: set-up {setup_s:.3f} s, window "
          f"{t_check - setup_s - T0:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": int(w["chips"]), "memory_peak_bytes": int(peak),
              "power_limit": power_limit()}
    if args.trace:
        metrics = per_layer(spec, w["name"], rec, work)
        device["busy_s"] = rec["plain"]["busy_s"]
        device["window_s"] = rec["plain"]["window_s"]
        if rec["plain"]["lost"] or rec["stacked"]["lost"]:
            print(f"benchmark: the profiler lost {rec['plain']['lost']} / "
                  f"{rec['stacked']['lost']} device events", file=sys.stderr)
            return 3
    else:
        metrics = {m["name"]: {"value": rec["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in harness.metrics_of(spec, w["name"], "end_to_end")
                   if m["name"] in rec["metrics"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    bad = harness.forbidden_loaded()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    correct = all(lim is not None and math.isfinite(v) and v <= lim
                  for _, v, lim in checks)
    result = {"correct": bool(correct), "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": device,
              "detail": detail}
    if args.trace:
        result["breakdown"] = {
            "device_ops": rec["plain"]["by_kernel"],
            "idle_gaps": rec["stacked"]["idle_gaps"]}
    harness.emit(result, checks)
    return 0


def per_layer(spec, cell_name: str, rec: dict, work: dict) -> dict:
    """Each per-layer metric of the cell read by its reader from the
    traced windows and the layer counts; a reader that finds nothing
    returns None and the metric is left out."""
    ctx = dict(rec)
    ctx["work"] = {}
    for path in sorted((harness.HERE / "rooflines").glob("*.py")):
        ctx["work"][path.stem] = harness.roofline(path.stem).count(work)
    out = {}
    for m in harness.metrics_of(spec, cell_name, "per_layer"):
        v = harness.metric_reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


if __name__ == "__main__":
    sys.exit(main())
