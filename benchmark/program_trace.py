"""What the program records about itself in a traced window, for the
per-layer readers: its spans (``btsbot_tpu_torch.utils.profiling.annotate``,
``user_annotation`` events on the profiler's clock, in ``Trace.host``) and
its counters (``profiling.counters()``, read in the same process after the
window; they add only while the profiler records).  Both are empty where
the program records none."""

from __future__ import annotations


def counters() -> dict:
    """The program's counters, or nothing where it keeps none."""
    from btsbot_tpu_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    return read() if read else {}


def span_seconds(trace, name: str) -> list[float]:
    """The durations of the window's spans called ``name``, in seconds."""
    if trace is None:
        return []
    return [d for n, _, d in trace.host if n == name]
