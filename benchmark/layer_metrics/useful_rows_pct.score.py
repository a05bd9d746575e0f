"""Share of the scored rows that were real alerts: the program's
``serve.rows`` over its ``serve.padded_rows`` (each batch's bucket) in the
traced window.  Nothing where nothing was traced or the program counts
neither."""

from benchmark import program_trace


def read(run):
    c = program_trace.counters()
    if run.trace is None or not c.get("serve.padded_rows"):
        return None
    return 100 * c.get("serve.rows", 0) / c["serve.padded_rows"]
