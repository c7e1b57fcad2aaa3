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
    KernelSpec("abea", "genarchbench_tpu_torch.kernels.abea",
               "adaptive banded event alignment (f5c eventalign)",
               "tolerant_abea", "Data processing time:"),
    KernelSpec("bpm", "genarchbench_tpu_torch.kernels.bpm",
               "bit-parallel Myers edit distance", "sorted",
               "Time.Benchmark"),
    KernelSpec("bsw", "genarchbench_tpu_torch.kernels.bsw",
               "banded affine-gap Smith-Waterman (BWA-MEM2 extension)",
               "exact", "Overall SW cycles"),
    KernelSpec("chain", "genarchbench_tpu_torch.kernels.chain",
               "minimap2 anchor chaining DP (exact, with skip heuristics)",
               "exact", "Time in kernel:"),
    KernelSpec("fast-chain", "genarchbench_tpu_torch.kernels.fast_chain",
               "simplified 32-bit anchor chaining (vectorized, no "
               "heuristics)", "exact", "Time in kernel:"),
    KernelSpec("wfa", "genarchbench_tpu_torch.kernels.wfa",
               "gap-affine wavefront alignment", "sorted",
               "Time.Alignment:"),
    KernelSpec("fmi", "genarchbench_tpu_torch.kernels.fmi",
               "FM-index SMEM search (BWA-MEM2 seeding)", "exact",
               "Computing time:"),
    KernelSpec("poa", "genarchbench_tpu_torch.kernels.poa",
               "partial-order alignment consensus (spoa)", "exact",
               "Runtime:"),
    KernelSpec("kmer-cnt", "genarchbench_tpu_torch.kernels.kmer",
               "canonical k-mer counting (Flye)", "scalar", "Kernel time:"),
    KernelSpec("dbg", "genarchbench_tpu_torch.kernels.dbg",
               "windowed de-Bruijn-graph variant paths (Platypus)", "sorted",
               "Kernel runtime:"),
    KernelSpec("pileup", "genarchbench_tpu_torch.kernels.pileup",
               "pileup base-count matrices (Medaka)", "exact",
               "Kernel runtime:"),
    KernelSpec("nn-base", "genarchbench_tpu_torch.nn.basecall",
               "QuartzNet-CTC nanopore basecalling (Bonito)", "exact",
               "> samples per second"),
    KernelSpec("nn-variant", "genarchbench_tpu_torch.nn.variant",
               "Clair3 pileup + full-alignment variant calling", "sorted",
               "VariantCalling execution time:"),
)}


def get_kernel(name: str) -> KernelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown kernel {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_kernels() -> List[KernelSpec]:
    return sorted(_REGISTRY.values(), key=lambda s: s.name)


def load_runner(name: str) -> Callable:
    return importlib.import_module(get_kernel(name).module).run
