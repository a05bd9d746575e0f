"""The scoring forward's share of the card's peak: the forward operations of
the alerts scored in the traced window (padded rows not counted), over the
window, against the serving type's peak."""

from benchmark import counts


def read(run):
    alerts = run.counters.get("alerts_traced", 0)
    if run.trace is None or not alerts:
        return None
    flops = counts.forward_flops_per_alert(run.cfg) * alerts
    return 100 * flops / run.trace.window_s / counts.PEAK_FLOPS[run.cfg["serve_dtype"]]
