"""The anchor loop's share of the window on the host: the program's
span `<entry>.dp` (the device DP's ops enqueued), over the summed wall
time of the window's batches."""

from h100_bench.harness.spans import window_spans


def read(run):
    w = window_spans(run)
    return None if w is None else w.share(("dp",))
