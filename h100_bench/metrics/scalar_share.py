"""The share of a batch's wall time spent in the program's exact scalar
DP on the host, for the records its device path defers (the
configuration's `stats.scalar` keys of `stats=`), over the wall time of
the same batch.  Nothing to read where the configuration has no such
path."""


def read(run):
    keys = run.cell.config["stats"].get("scalar")
    if run.stats is None or not keys:
        return None
    return 100.0 * sum(run.stats[k] for k in keys) / run.stats_wall_s
