"""The bfloat16 block kernel's share of its roofline: the bound of every
block launch of the traced window's forwards (at the rows each forward
took, padding included), over the device time of the kernels named
``convnext_block``.  Nothing when no such kernel ran."""

from benchmark import counts


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_time("convnext_block")
    if not launches:
        return None
    bound = sum(counts.blocks_bound_s(run.cfg, rows, run.cfg["serve_dtype"])
                for rows in run.counters.get("forward_rows", []))
    return 100 * bound / seconds
