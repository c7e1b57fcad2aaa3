"""The backtrace's share of the window: the program's spans
`wfa.backtrace` (the device backtrace, enqueued and drained), over the
summed wall time of the window's batches.  Nothing to read where the
program keeps no `wfa.batch` root tiled by its phases (`wfa.forward` no
child of one)."""

from h100_bench.harness.spans import window_spans


def read(run):
    w = window_spans(run)
    if w is None or "forward" not in w.phase_s:
        return None
    return w.share(("backtrace",))
