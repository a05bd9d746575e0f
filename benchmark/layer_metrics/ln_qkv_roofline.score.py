"""The LN-qkv kernel's share of its roofline: the bound of every LN-qkv
launch of the traced window's forwards (``counts_ln_qkv``, at the rows each
forward took, padding included), over the device time of the kernels named
``ln_qkv``.  Nothing when none ran."""

from benchmark import counts_ln_qkv


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_time("ln_qkv")
    if not launches:
        return None
    bound = sum(counts_ln_qkv.ln_qkv_bound_s(run.cfg, rows, run.cfg["serve_dtype"])
                for rows in run.counters.get("forward_rows", []))
    return 100 * bound / seconds
