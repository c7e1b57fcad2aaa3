"""The traced batch's share of its roofline: the least time the card
could take for its band cells and bytes (the reference's `bsw_bound_s`,
`reference/bsw.py::bound`) over the summed device time of every kernel
in that batch.  Nothing to read without a device trace, or where the
reference counts no such bound (another configuration's work)."""

from h100_bench.harness.window import TRACED_INPUT


def read(run):
    if run.trace is None or not run.trace.kernel_s:
        return None
    try:
        bound = run.work[TRACED_INPUT]["bsw_bound_s"]
    except KeyError:    # another configuration's work
        return None
    return 100.0 * bound / run.trace.kernel_s
