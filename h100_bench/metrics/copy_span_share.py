"""The copies' share of the window: the program's spans `<entry>.h2d`
and `.d2h`, over the summed wall time of the window's batches."""

from h100_bench.harness.spans import window_spans


def read(run):
    w = window_spans(run)
    return None if w is None else w.share(("h2d", "d2h"))
