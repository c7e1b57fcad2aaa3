"""Seconds from the process's start to the first timed batch."""


def read(run):
    return run.setup_s
