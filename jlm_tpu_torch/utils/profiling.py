"""Device profiling helpers (SURVEY.md §7 "Tracing / profiling").

Counterpart of :mod:`jlm_tpu.utils.profiling`.  ``trace`` wraps
``torch.profiler`` and writes a Chrome trace (``chrome://tracing`` or
Perfetto opens it); ``device_timer`` measures the steady-state time of a
call, forcing each call to finish before its clock stops: a CUDA
synchronize where a card is present, then a host copy of the first tensor
of the output, as the original forces a host fetch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity where a card is present) and write its Chrome trace to
    ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):  # in key order, as a pytree's leaves
        out = [out[k] for k in sorted(out)]
    if isinstance(out, (list, tuple)):
        for x in out:
            leaf = _first_tensor(x)
            if leaf is not None:
                return leaf
    return None


def _touch(out) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    leaf = _first_tensor(out)
    if leaf is not None:
        np.asarray(leaf.detach().cpu())


def device_timer(fn: Callable, *args, reps: int = 5, warmup: int = 1) -> float:
    """Median seconds per call of ``fn(*args)`` with forced materialization."""
    for _ in range(warmup):
        _touch(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.time()
        _touch(fn(*args))
        times.append(time.time() - t0)
    return sorted(times)[len(times) // 2]
