"""Typed configuration, the port's copy of the JAX package's
core/config.py, for two of the reference's config tiers (SURVEY.md
§5.6):

  1. environment (reference: benchmarks/setup.sh:3-23 env vars) —
     `EnvConfig.from_env()`, the one reader of the deployment's
     variables: the device resolver (core/backend.py), the mesh and
     process group (sharding/mesh.py), the job harness
     (harness/scheduler.py, harness/dataset_regress.py) and the ROI
     traces (core/roi.py) all take them from it;
  2. runtime key=value config files (reference: Flye's config.h loader
     with %include, kmer-cnt/config.h) — `load_kv_config`.

What differs from JAX: the JAX field `platform` (GENARCH_PLATFORM, a JAX
backend name) is `device` here (GENARCH_DEVICE, a torch device: `cuda`
unless set, `cpu` for the plain versions); the process group's
coordinator and rank, which JAX's mesh read itself, are fields too; and
JAX's `KernelVariants` (build-time variant flags that no code path
read) is not kept.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Tier 1: the process environment (setup.sh equivalent)."""
    inputs_root: Optional[str] = None   # GENARCH_BENCH_INPUTS_ROOT
    device: Optional[str] = None        # GENARCH_DEVICE ("cpu" for the host)
    devices: int = 1                    # GENARCH_DEVICES (job scripts export)
    hosts: int = 1                      # GENARCH_HOSTS
    trace_dir: Optional[str] = None     # GENARCH_TRACE_DIR
    job_scheduler: Optional[str] = None  # GENARCH_JOB_SCHEDULER override
    job_dir: Optional[str] = None       # GENARCH_JOB_DIR (stage dirs)
    regress_timeout_s: float = 1800.0   # GENARCH_REGRESS_TIMEOUT
    coordinator: Optional[str] = None   # GENARCH_COORDINATOR (host:port)
    process_id: Optional[int] = None    # GENARCH_PROCESS_ID (rank)

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "EnvConfig":
        e = os.environ if env is None else env

        def _int(k, d):
            try:
                return int(e[k]) if k in e else d
            except ValueError:
                return d

        def _float(k, d):
            try:
                return float(e.get(k, d))
            except ValueError:
                return d

        return cls(
            inputs_root=e.get("GENARCH_BENCH_INPUTS_ROOT"),
            device=e.get("GENARCH_DEVICE"),
            devices=max(1, _int("GENARCH_DEVICES", 1)),
            hosts=max(1, _int("GENARCH_HOSTS", 1)),
            trace_dir=e.get("GENARCH_TRACE_DIR"),
            job_scheduler=e.get("GENARCH_JOB_SCHEDULER"),
            job_dir=e.get("GENARCH_JOB_DIR"),
            regress_timeout_s=_float("GENARCH_REGRESS_TIMEOUT", 1800.0),
            coordinator=e.get("GENARCH_COORDINATOR") or None,
            process_id=_int("GENARCH_PROCESS_ID", None),
        )


def load_kv_config(path: str) -> Dict[str, str]:
    """Tier 3: key = value lines, `#` comments, and `%include <file>` (a
    path relative to the including file's directory, read in place)."""
    cfg: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            if line.startswith("%include"):
                inc = line.split(None, 1)[1].strip()
                cfg.update(load_kv_config(
                    os.path.join(os.path.dirname(path), inc)))
                continue
            if "=" in line:
                key, val = (t.strip() for t in line.split("=", 1))
                cfg[key] = val
    return cfg
