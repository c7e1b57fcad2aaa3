"""The share of the window the host waits on the card: the program's
span `<entry>.wait` (the plan's stream drained before the copy back),
over the summed wall time of the window's batches."""

from h100_bench.harness.spans import window_spans


def read(run):
    w = window_spans(run)
    return None if w is None else w.share(("wait",))
