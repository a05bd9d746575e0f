"""Host time of the data feed per train step: the program's ``feed.gather``
(the batch's indexed gather) and ``feed.to_device`` (pin and copy) spans
summed over the traced window, per ``step.run`` span.  Nothing where the
program records no step."""

from benchmark import program_trace


def read(run):
    steps = len(program_trace.span_seconds(run.trace, "step.run"))
    if not steps:
        return None
    feed = sum(sum(program_trace.span_seconds(run.trace, name))
               for name in ("feed.gather", "feed.to_device"))
    return 1e3 * feed / steps
