"""Profiling and timing (port of btsbot_tpu/utils/profiling.py).

* ``trace`` — a context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, loadable in chrome://tracing or Perfetto)
  into a directory: the host's operators and, on the card, its kernels;
* ``annotate`` — a named region: ``torch.profiler.record_function`` (shown
  on the profiler's timeline) plus an NVTX range when CUDA is available;
* ``time_device_fn`` — seconds per call of ``fn(*args)``: on the card CUDA
  events around ``iters`` calls after a warm-up (the best of ``reps``
  runs), on the CPU ``time.perf_counter``.  PyTorch returns before the card
  finishes, so a host clock without a synchronise would time the enqueue.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str = "btsbot_torch_trace"):
    """Profile the enclosed code; the Chrome trace lands in
    ``{log_dir}/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region on the profiler's timeline (and an NVTX range on
    CUDA)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def time_device_fn(fn: Callable, args: tuple, iters: int = 50,
                   reps: int = 3) -> float:
    """Mean seconds per call of ``fn(*args)``, the best of ``reps`` runs of
    ``iters`` calls after one warm-up call.  The device is the one of the
    first tensor among ``args`` (the CPU if there is none)."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  torch.device("cpu"))
    on_card = device.type == "cuda"
    fn(*args)
    best = float("inf")
    for _ in range(reps):
        if on_card:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            torch.cuda.synchronize(device)
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            secs = time.perf_counter() - t0
        best = min(best, secs)
    return best / iters
