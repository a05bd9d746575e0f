"""Profiling: spans and counters on the profiler's clock.

* ``trace`` — a context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, loadable in chrome://tracing or Perfetto)
  into a directory: the host's operators, the program's spans and, on the
  card, its kernels and copies, on one timeline; and beside it
  ``counters.json``, the counters of the traced code;
* ``annotate`` — a named span: a ``torch.profiler.record_function`` range
  while a profiler is recording, else a shared no-op context;
* ``count`` / ``counters`` / ``reset_counters`` — process-wide integer
  counters that add only while a profiler is recording, so they cover the
  traced window and nothing else.

With no profiler recording, a span or a count costs one check.  The
program's spans and counters:

* ``AlertScorer.__call__`` (``engine/serve.py``): ``serve.batch`` a padded
  batch, holding ``serve.pad`` (host zero-pad, ``from_numpy``, host cast),
  ``serve.h2d`` (the copy to the device), ``serve.forward`` (the forward,
  an enqueue on the card) and ``serve.readback`` (the scores back to the
  host, under a mesh after gathering every rank's; on the card it waits for
  the forward); counters ``serve.batches``, ``serve.rows``,
  ``serve.padded_rows`` (a rank's own, under a mesh) and
  ``serve.h2d_bytes``.  On a CUDA card the batch is fed through the pinned
  ring: ``serve.pad`` is the host copy of one chunk of real rows into pinned
  memory (several an input), ``serve.h2d`` the queueing of that chunk's copy
  on the copy stream, or of the padding's zeroing on the card;
  ``serve.forward`` also queues the gather (under a mesh) and the scores'
  copy to the host; ``serve.readback`` waits for that copy, and for all but
  a call's last batch falls in the next batch's ``serve.batch``, after its
  ``serve.forward``; ``serve.h2d_bytes`` counts the real rows only, the
  bytes that cross.  Two more counters there: ``serve.staged_batches``
  (batches fed through the ring; ÷ ``serve.batches`` is its engagement) and
  ``serve.ring_waits`` (times the host waited for a slot's earlier copy
  before staging into it).  The stream scorer's batches have ``serve.pad``,
  ``serve.h2d`` and ``serve.h2d_bytes`` only;
* the data feed: ``feed.gather`` (``data/dataset.py::iterate_batches``) and
  ``feed.to_device`` (``engine/steps.py::to_device``);
* the train step (``engine/steps.py::make_train_step``): ``step.run``,
  holding ``step.augment``, ``step.forward``, ``step.backward``,
  ``step.allreduce`` (under a mesh) and ``step.optimizer``.
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

# True while a profiler records on this thread: the one check of the off path
_recording = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_COUNTERS: dict[str, int] = {}


@contextlib.contextmanager
def trace(log_dir: str = "btsbot_torch_trace"):
    """Profile the enclosed code; the Chrome trace lands in
    ``{log_dir}/trace.json`` and its counters in ``{log_dir}/counters.json``
    (reset on entry)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset_counters()
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(counters(), f, indent=1, sort_keys=True)


def annotate(name: str):
    """A named span on the profiler's timeline while a profiler records;
    otherwise a shared context that does nothing."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _recording():
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def counters() -> dict[str, int]:
    """A copy of every counter."""
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()
