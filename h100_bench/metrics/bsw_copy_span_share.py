"""The copies' share of the window: the program's spans `bsw.h2d` (the
base planes and the pairs' lengths, start scores and bands to the card)
and `bsw.d2h` (the scores back, put in input order), over the summed
wall time of the window's batches.  Nothing to read where the program
keeps no `bsw.batch` root tiled by its phases (`bsw.kernel` no child of
one)."""

from h100_bench.harness.spans import window_spans


def read(run):
    w = window_spans(run)
    if w is None or "kernel" not in w.phase_s:
        return None
    return w.share(("h2d", "d2h"))
