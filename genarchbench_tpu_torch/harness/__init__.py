"""The regression harness: job scheduling and the dataset-bound sweeps."""

from genarchbench_tpu_torch.harness.scheduler import (  # noqa: F401
    Job, JobResult, JobRunner, detect_scheduler, read_energy_j)
