"""The window's share of the card's peak: the least time the card could
take for the window's wavefront offsets and bytes (the reference's
`wfa_bound_s` summed over the window's batches) over the window's wall
time.  Nothing to read where the reference counts no such bound
(another configuration's work)."""


def read(run):
    try:
        bound = run.window_sum("wfa_bound_s")
    except KeyError:    # another configuration's work
        return None
    return 100.0 * bound / run.window_s
