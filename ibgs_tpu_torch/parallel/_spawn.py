"""Run a function on N ranks, one spawned process each (gloo on the CPU,
NCCL on cards), and collect what each returns.

    results = run("pkg.module:function", world, workdir, *args)

Each rank starts from a fresh interpreter (the `spawn` method), joins the
group through a FileStore under `workdir` (so concurrent runs cannot
collide on a port), calls function(*args) and writes its return value to
`workdir/rank<r>.pt` (torch.save).  A rank that raises writes its
traceback instead; `run` then raises with it.  Every collective times out
after `timeout_s`, and `run` kills every rank that is still alive after
`join_timeout_s`, so a deadlock fails instead of hanging.
"""
from __future__ import annotations

import importlib
import multiprocessing
import os
import time
import traceback

DEFAULT_TIMEOUT_S = 120.0


def _worker(rank: int, world: int, workdir: str, target: str, args,
            device: str, timeout_s: float):
    import torch

    from ibgs_tpu_torch.parallel import distributed

    out = os.path.join(workdir, f"rank{rank}.pt")
    try:
        torch.set_num_threads(1)
        distributed.initialize(
            num_processes=world, process_id=rank, device=device,
            init_method="file://" + os.path.join(workdir, "store"),
            timeout_s=timeout_s)
        mod, fn = target.split(":")
        result = getattr(importlib.import_module(mod), fn)(*args)
        torch.save({"result": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def run(target: str, world: int, workdir: str, *args, device: str = "cpu",
        timeout_s: float = DEFAULT_TIMEOUT_S,
        join_timeout_s: float = 4 * DEFAULT_TIMEOUT_S) -> list:
    """`target` ("module:function") on `world` ranks; returns the list of
    their results in rank order."""
    import torch

    os.makedirs(workdir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, workdir, target,
                                               args, device, timeout_s))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + join_timeout_s
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"{target}: {len(hung)} of {world} ranks still "
                           f"running after {join_timeout_s} s")
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{r}.pt")
        if not os.path.exists(path):
            raise RuntimeError(f"{target}: rank {r} exited with code "
                               f"{p.exitcode} and no result")
        rec = torch.load(path, weights_only=False)
        if "error" in rec:
            raise RuntimeError(f"{target}: rank {r} failed:\n{rec['error']}")
        results.append(rec["result"])
    return results
