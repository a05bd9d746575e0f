"""The MBConv kernel's share of its roofline: the bound of every MBConv
launch of the traced window's forwards (``counts_mbconv``, at the rows each
forward took, padding included), over the device time of the kernels named
``mbconv_dw``.  Nothing when none ran."""

from benchmark import counts_mbconv


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_time("mbconv_dw")
    if not launches:
        return None
    bound = sum(counts_mbconv.mbconv_bound_s(run.cfg, rows, run.cfg["serve_dtype"])
                for rows in run.counters.get("forward_rows", []))
    return 100 * bound / seconds
