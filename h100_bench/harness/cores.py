"""The host cores a run holds: the configuration's `host_cores` of the
cores the process was given, the highest of them, for the program and
every thread it starts; after the window, the set it started with."""

from __future__ import annotations

import os

_START = None


def pin(count: int) -> set:
    """Hold this process to `count` of its cores (all, where it has
    fewer); returns the set."""
    global _START
    if _START is None:
        _START = os.sched_getaffinity(0)
    cores = set(sorted(_START)[-count:])
    os.sched_setaffinity(0, cores)
    return cores


def release() -> None:
    """Give the process back the cores it started with (where `pin` ran)."""
    if _START is not None:
        os.sched_setaffinity(0, _START)
