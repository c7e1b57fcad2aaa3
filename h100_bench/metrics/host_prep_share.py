"""Host preparation's share of a batch's wall time: the program's
preparation seconds (the configuration's `stats.prep` keys of `stats=`)
over the wall time of the same batch."""


def read(run):
    if run.stats is None:
        return None
    keys = run.cell.config["stats"]["prep"]
    return 100.0 * sum(run.stats[k] for k in keys) / run.stats_wall_s
