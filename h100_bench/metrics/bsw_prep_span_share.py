"""Host preparation's share of the window: the program's spans
`bsw.prep` (lengths, the sort into groups, the band limits and the
padded base planes of `kernel_inputs`), over the summed wall time of the
window's batches.  Nothing to read where the program keeps no
`bsw.batch` root tiled by its phases (`bsw.kernel` no child of one)."""

from h100_bench.harness.spans import window_spans


def read(run):
    w = window_spans(run)
    if w is None or "kernel" not in w.phase_s:
        return None
    return w.share(("prep",))
