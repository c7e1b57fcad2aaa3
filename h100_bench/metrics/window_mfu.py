"""The window's share of the chip's peak: the least time the chip could
take for the window's work (`harness/roofline.py`) over the window's
wall time."""


def read(run):
    return 100.0 * run.window_sum("bound_s") / run.window_s
