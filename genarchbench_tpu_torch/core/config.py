"""Flye-style key=value configuration files (kmer-cnt/config.h): the
port's copy of the JAX package's `load_kv_config`.  The JAX module's
`EnvConfig` and `KernelVariants` have no user outside the harness and
are not ported yet (ROADMAP queue 1, item 12)."""

from __future__ import annotations

import os
from typing import Dict


def load_kv_config(path: str) -> Dict[str, str]:
    """key = value lines, `#` comments, and `%include <file>` (a path
    relative to the including file's directory, read in place)."""
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
