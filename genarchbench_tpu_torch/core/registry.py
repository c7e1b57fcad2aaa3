"""Kernel registry.

Each ported kernel has a `KernelSpec` giving its CLI name, runner
module, golden-check rule and timing line, as in the JAX package's
registry.  Only the kernels the port has so far are listed; the rest
are queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, List


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str                      # CLI name, e.g. "bpm"
    module: str                    # python module implementing run(args) -> int
    description: str
    check_rule: str                # one of: exact | sorted | tolerant_abea | scalar
    timing_line: str               # greppable timing-line prefix


_REGISTRY = {s.name: s for s in (
    KernelSpec("bpm", "genarchbench_tpu_torch.kernels.bpm",
               "bit-parallel Myers edit distance", "sorted",
               "Time.Benchmark"),
    KernelSpec("bsw", "genarchbench_tpu_torch.kernels.bsw",
               "banded affine-gap Smith-Waterman (BWA-MEM2 extension)",
               "exact", "Overall SW cycles"),
)}


def get_kernel(name: str) -> KernelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown kernel {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_kernels() -> List[KernelSpec]:
    return sorted(_REGISTRY.values(), key=lambda s: s.name)


def load_runner(name: str) -> Callable:
    return importlib.import_module(get_kernel(name).module).run
