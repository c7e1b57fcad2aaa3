"""The share of the window's records that the program's device path
defers to its exact scalar DP: the counts `<entry>.deferred` over
`<entry>.records` under the window's batches.  Nothing to read where
the program counts no deferrals."""

from h100_bench.harness.spans import window_spans


def read(run):
    w = window_spans(run)
    if w is None or "deferred" not in w.counts \
            or not w.counts.get("records"):
        return None
    return 100.0 * w.counts["deferred"] / w.counts["records"]
