"""The block kernel's share of its roofline in the MaxxViT forward: the
bound of every stride-1 ConvNeXt half of the traced window's forwards
(``counts_maxxvit.blocks_bound_s``, at the rows each forward took, padding
included), over the device time of the kernels named ``convnext_block``.
Nothing when none ran."""

from benchmark import counts_maxxvit


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_time("convnext_block")
    if not launches:
        return None
    bound = sum(counts_maxxvit.blocks_bound_s(run.cfg, rows, run.cfg["serve_dtype"])
                for rows in run.counters.get("forward_rows", []))
    return 100 * bound / seconds
