"""The plans a batch: the program's count `<entry>.plans` under the
window's batches, over the batches."""

from h100_bench.harness.spans import window_spans


def read(run):
    w = window_spans(run)
    if w is None or "plans" not in w.counts:
        return None
    return w.counts["plans"] / w.roots
