"""The partition-attention kernel's share of its roofline: the bound of
every such launch of the traced window's forwards (``counts_maxvit``, at
the rows each forward took, padding included), over the device time of the
kernels named ``partition_attention``.  Nothing when none ran."""

from benchmark import counts_maxvit


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_time("partition_attention")
    if not launches:
        return None
    bound = sum(counts_maxvit.attention_bound_s(run.cfg, rows, run.cfg["serve_dtype"])
                for rows in run.counters.get("forward_rows", []))
    return 100 * bound / seconds
