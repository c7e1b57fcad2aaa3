"""Host preparation's share of the window: the program's spans
`<entry>.starts` (window starts), `.plan` (plans and their inputs) and
`.unpack` (results into records), over the summed wall time of the
window's batches."""

from h100_bench.harness.spans import window_spans


def read(run):
    w = window_spans(run)
    return None if w is None else w.share(("starts", "plan", "unpack"))
