"""The score steps a batch: the program's count `wfa.score_steps` (each
chunk's lock-step score loop runs to the highest score of its pairs)
under the window's batches, over the batches."""

from h100_bench.harness.spans import window_spans


def read(run):
    w = window_spans(run)
    if w is None or "score_steps" not in w.counts:
        return None
    return w.counts["score_steps"] / w.roots
