"""The device's idle share of the traced batch: 1 - the union of its
activity intervals over the batch's wall time."""


def read(run):
    if run.trace is None or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.wall_s)
