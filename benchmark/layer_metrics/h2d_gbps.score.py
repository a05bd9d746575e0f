"""Rate of the scorer's host → card copies: the bytes the program handed to
them in the traced window (its ``serve.h2d_bytes``) over the device time of
the profiler's host-to-device copies.  Nothing where either is missing."""

from benchmark import program_trace


def read(run):
    moved = program_trace.counters().get("serve.h2d_bytes", 0)
    if run.trace is None or not moved:
        return None
    seconds = sum(d for name, _, d in run.trace.memcpys if "HtoD" in name)
    return moved / seconds / 1e9 if seconds > 0 else None
