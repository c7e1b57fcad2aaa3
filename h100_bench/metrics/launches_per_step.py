"""Host kernel and graph launches inside the configuration's spans, over
the anchor steps the program counts (the configuration's `stats.steps`
key of `stats=`, from a batch of the same input).  Nothing to read where
the device ran no step or launched nothing."""


def read(run):
    if run.trace is None or run.stats is None or not run.trace.launches:
        return None
    steps = run.stats[run.cell.config["stats"]["steps"]]
    return run.trace.launches / steps if steps else None
