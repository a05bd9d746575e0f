"""Host time to enqueue one train step: the mean of the program's
``step.run`` spans in the traced window (the step reads nothing back, so on
the card this is the launches' host time, not the step's device time).
Nothing where the program records no step."""

from benchmark import program_trace


def read(run):
    steps = program_trace.span_seconds(run.trace, "step.run")
    if not steps:
        return None
    return 1e3 * sum(steps) / len(steps)
