"""The MaxxViT forward's share of the card's peak: the forward operations
(``counts_maxxvit``) of the alerts scored in the traced window (padded rows
not counted), over the window, against the serving type's peak."""

from benchmark import counts, counts_maxxvit


def read(run):
    alerts = run.counters.get("alerts_traced", 0)
    if run.trace is None or not alerts:
        return None
    flops = counts_maxxvit.forward_flops_per_alert(run.cfg) * alerts
    return 100 * flops / run.trace.window_s / counts.PEAK_FLOPS[run.cfg["serve_dtype"]]
