"""Process group and meshes (counterpart of ibgs_tpu/parallel/distributed.py).

The port runs one process per rank.  `initialize()` joins the process
group that the environment describes, with the backend that the device
takes: NCCL on `cuda`, gloo on `cpu` (there is no fallback from one to the
other).  It reads

* an explicit `init_method` (e.g. `file:///tmp/store`, a FileStore) with
  `num_processes` / `process_id`;
* COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, as the JAX package;
* torchrun's MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE (LOCAL_RANK
  picks the card).

With none of them it is the single-process no-op (world size 1), as in the
JAX package; `global_mesh` then opens a one-rank group of its own over an
in-process store.  An explicit request that fails raises.  Every
collective of the group and of the meshes times out after `timeout_s`, so
a rank that never joins fails the others instead of hanging them.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def backend_for(device) -> str:
    """The collective backend of a device: NCCL on a card, gloo on the
    CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _timeout(timeout_s: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(timeout_s))


def _init(device, init_method: str, world: int, rank: int,
          timeout_s: float, store=None):
    """init_process_group on `device`'s backend.  On a card the rank's
    card is made current and NCCL starts at the group's first collective
    (no `device_id`, so DeviceMesh builds its groups with new_group, not
    by splitting an eager communicator)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            store=store, world_size=world, rank=rank,
                            timeout=_timeout(timeout_s))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               init_method: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join (or create) the process group.  Returns True when more than
    one process takes part, False for the single-process case."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "COORDINATOR_ADDRESS")
    if init_method is None and coordinator_address:
        init_method = f"tcp://{coordinator_address}"
    if init_method is not None:
        if num_processes is None:
            num_processes = int(env["NUM_PROCESSES"])
        if process_id is None:
            process_id = int(env["PROCESS_ID"])
    elif all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                "WORLD_SIZE")):
        init_method = "env://"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    _init(device, init_method, num_processes, process_id, timeout_s)
    return dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(dp: int, axis2: int, axis_names=("dp", "gs"),
                device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S):
    """A (dp, axis2) DeviceMesh over every rank of the process group, rank
    r at (r // axis2, r % axis2).  The group must have exactly dp·axis2
    ranks; with no group yet and dp·axis2 == 1, a one-rank group over an
    in-process store is opened first."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    if not dist.is_initialized():
        if dp * axis2 != 1:
            raise RuntimeError(
                f"global_mesh: a {dp} x {axis2} mesh needs {dp * axis2} "
                f"processes; call initialize() in each (torchrun, or "
                f"COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID)")
        _init(dev, None, 1, 0, timeout_s, store=dist.HashStore())
    if dist.get_world_size() != dp * axis2:
        raise RuntimeError(f"global_mesh: {dp} x {axis2} mesh over "
                           f"{dist.get_world_size()} processes")
    if backend_for(dev) != dist.get_backend():
        raise RuntimeError(f"global_mesh: the process group runs "
                           f"{dist.get_backend()}, the device {dev} takes "
                           f"{backend_for(dev)}")
    opts = (dist.ProcessGroupNCCL.Options() if dev.type == "cuda"
            else dist.ProcessGroupGloo._Options())
    opts._timeout = _timeout(timeout_s)
    backend = backend_for(dev)
    return init_device_mesh(
        dev.type, (dp, axis2), mesh_dim_names=tuple(axis_names),
        backend_override={n: (backend, opts) for n in axis_names})


def process_local_batch(n_items: int) -> range:
    """The slice of a global batch of n_items that this process feeds."""
    per = n_items // max(world_size(), 1)
    lo = rank() * per
    return range(lo, lo + per)
