"""The DP's share of its roofline: the least time the chip could take for
the traced batch's work (`harness/roofline.py`) over the summed device
time of every kernel in that batch.  Nothing to read where the device
ran no anchor step (the program did the DP elsewhere), or where the
program deferred records to another path: the work would then be
counted against kernels that did only part of it."""

from h100_bench.harness.window import TRACED_INPUT


def read(run):
    if run.trace is None or not run.trace.kernel_s or run.stats is None:
        return None
    if not run.stats[run.cell.config["stats"]["steps"]] \
            or run.stats.get("deferred"):
        return None
    return 100.0 * run.work[TRACED_INPUT]["bound_s"] / run.trace.kernel_s
