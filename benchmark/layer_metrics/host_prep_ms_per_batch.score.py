"""Host time to pad and wrap a scored batch's inputs: the program's
``serve.pad`` spans (zero-pad, ``from_numpy``, host cast; one an input)
summed over the traced window, per ``serve.batch`` span.  Nothing where the
program records no batch."""

from benchmark import program_trace


def read(run):
    batches = len(program_trace.span_seconds(run.trace, "serve.batch"))
    if not batches:
        return None
    return 1e3 * sum(program_trace.span_seconds(run.trace, "serve.pad")) / batches
