"""Tracing (counterpart of ibgs_tpu/utils/profiling.py).

`trace(logdir)` captures a `torch.profiler` trace (host ops and, on a
card, its kernels) of the code it wraps and writes it as a Chrome trace
(viewable in Perfetto or chrome://tracing).  The training loop opens it
over the `--profile_from_iter` / `--profile_num_steps` window.
`step_annotation` labels one training step in that trace, and in an
Nsight timeline through NVTX when the device is a card; `annotate` labels
any host region.  `trace_files` lists the captures under a directory.
"""
from __future__ import annotations

import contextlib
import glob
import os

import torch


@contextlib.contextmanager
def trace(logdir):
    """Capture a torch.profiler trace into `logdir`/trace.json (no-op if
    falsy)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def step_annotation(name: str, step: int, device="cpu"):
    """Label one training step (`name` #`step`) in the trace timeline."""
    label = f"{name}#{step}"
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(label))
        if torch.device(device).type == "cuda":
            stack.enter_context(torch.cuda.nvtx.range(label))
        yield


def annotate(name: str):
    """Label a host-side region in the trace timeline."""
    return torch.profiler.record_function(name)


def trace_files(logdir: str):
    """The Chrome trace files `trace` wrote under `logdir`."""
    return sorted(glob.glob(os.path.join(logdir, "**", "*.json"),
                            recursive=True))
