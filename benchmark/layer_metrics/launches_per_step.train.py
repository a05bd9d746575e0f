"""Kernels launched on the card per train step in the traced window."""


def read(run):
    steps = run.counters.get("steps_traced", 0)
    if run.trace is None or not steps:
        return None
    return len(run.trace.kernels) / steps
