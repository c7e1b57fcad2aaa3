"""The `chain` configuration on the program: a batch's records through
the entry its configuration names (`chain_batch`, the function the
chain CLI's region of interest calls), on one card."""

from h100_bench.adapters._records import (  # noqa: F401
    chain_records as inputs, run_on_one_card as run)
