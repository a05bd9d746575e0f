"""The strided depthwise convolutions' share of their roofline: the bound
of every stride-2 depthwise 7×7 of the traced window's MaxxViT forwards
(``counts_maxxvit.strided_dw_bound_s``, at the rows each forward took,
padding included), over the device time of the kernels that run them.
Nothing when none ran."""

from benchmark import counts_maxxvit

# the kernel that runs them (cuDNN's grouped direct convolution on an NHWC
# bfloat16 map, H100; the stem's dense convs run others)
KERNELS = ("cudnn::cnn::conv2d_grouped_direct_kernel",)


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_time(*KERNELS)
    if not launches:
        return None
    bound = sum(counts_maxxvit.strided_dw_bound_s(run.cfg, rows, run.cfg["serve_dtype"])
                for rows in run.counters.get("forward_rows", []))
    return 100 * bound / seconds
