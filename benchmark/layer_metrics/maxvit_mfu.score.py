"""mm_MaxViT's scoring forward's share of the card's peak: the forward
operations (``counts_maxvit``) of the alerts scored in the traced window
(padded rows not counted), over the window, against the serving type's
peak."""

from benchmark import counts, counts_maxvit


def read(run):
    alerts = run.counters.get("alerts_traced", 0)
    if run.trace is None or not alerts:
        return None
    flops = counts_maxvit.forward_flops_per_alert(run.cfg) * alerts
    return 100 * flops / run.trace.window_s / counts.PEAK_FLOPS[run.cfg["serve_dtype"]]
