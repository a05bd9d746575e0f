"""Rate of the partition-attention kernel: the bytes the program counted
for its launches in the traced window (its ``partition_attention.bytes``:
qkv read once, the output written once, the bias table) over the device
time of the kernels named ``partition_attention``.  Nothing where either
is missing."""

from benchmark import program_trace


def read(run):
    moved = program_trace.counters().get("partition_attention.bytes", 0)
    if run.trace is None or not moved:
        return None
    seconds, launches = run.trace.kernel_time("partition_attention")
    return moved / seconds / 1e9 if launches and seconds > 0 else None
