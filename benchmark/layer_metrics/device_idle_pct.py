"""Share of the traced window in which no kernel ran on the card (copies do
not count as busy)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
