"""The score-cap resumes a batch: the program's count `wfa.resumes`
(each doubling of a chunk's score cap, which grows its state and may
rebuild its mismatch table) under the window's batches, over the
batches."""

from h100_bench.harness.spans import window_spans


def read(run):
    w = window_spans(run)
    if w is None or "resumes" not in w.counts:
        return None
    return w.counts["resumes"] / w.roots
