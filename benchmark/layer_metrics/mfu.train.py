"""The train step's share of the card's peak: three times the forward
operations of the alerts trained in the traced window, over the window,
against the highest rate at which the card takes float32 operands."""

from benchmark import counts


def read(run):
    alerts = run.counters.get("alerts_traced", 0)
    if run.trace is None or not alerts:
        return None
    flops = 3 * counts.forward_flops_per_alert(run.cfg) * alerts
    return 100 * flops / run.trace.window_s / counts.PEAK_FLOPS["float32"]
