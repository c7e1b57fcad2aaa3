"""Host kernel launches inside the program's `wfa.forward` spans (the
configuration's `spans`) over the score steps of a batch of the same
input (`stats["score_steps"]`), read as `launches_per_step.py` reads
the anchor loops'."""

from h100_bench.harness.cell import BENCH_DIR, load_module


def read(run):
    return load_module(BENCH_DIR / "metrics" / "launches_per_step.py") \
        .read(run)
