"""The exact scalar DP's share of the window: the program's span
`<entry>.scalar` (the records its device path defers, run in C on the
host), over the summed wall time of the window's batches."""

from h100_bench.harness.spans import window_spans


def read(run):
    w = window_spans(run)
    return None if w is None else w.share(("scalar",))
