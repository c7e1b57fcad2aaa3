"""DP window cells completed per second: every cell of the batches the
window completed, over the time from its start to the last completion."""


def read(run):
    return run.window_sum("cells") / run.window_s
