"""Host → card copy time per scored batch: the profiler's host-to-device
copies over the traced window, divided by the forwards in it."""


def read(run):
    batches = len(run.counters.get("forward_rows", []))
    if run.trace is None or not batches:
        return None
    return sum(d for name, _, d in run.trace.memcpys if "HtoD" in name) * 1e3 / batches
