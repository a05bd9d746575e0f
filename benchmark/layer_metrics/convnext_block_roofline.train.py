"""The float32 block kernel's share of its roofline in the train step: the
bound of every block launch of the traced steps' forwards (operations at
495 TFLOP/s), over the device time of the kernels of ``csrc/tf32x3.cu``
(the weight split, the products, the split sums).  Nothing when none ran."""

from benchmark import counts

KERNELS = ("tf32x3_kernel", "split_weights_kernel", "reduce_splits")


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_time(*KERNELS)
    if not launches:
        return None
    bound = sum(counts.blocks_bound_s(run.cfg, rows, "float32")
                for rows in run.counters.get("forward_rows", []))
    return 100 * bound / seconds
