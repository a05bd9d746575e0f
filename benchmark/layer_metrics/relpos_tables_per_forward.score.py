"""Bias tables built a forward: the program's ``maxxvit.relpos_tables``
counter over the forwards of the traced window (one table a
partition-attention launch, 22 a MaxxViT forward).  Nothing where the
program counts none."""

from benchmark import program_trace


def read(run):
    tables = program_trace.counters().get("maxxvit.relpos_tables", 0)
    forwards = len(run.counters.get("forward_rows", []))
    if run.trace is None or not tables or not forwards:
        return None
    return tables / forwards
