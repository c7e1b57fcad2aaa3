"""Kernel registry.

Every kernel has a `KernelSpec` giving its CLI name, runner module,
golden-check rule and timing line, as in the JAX package's registry.
The CLI and the regression harness are generic over it.

What differs from JAX: a spec may name the lines of the kernel's output
that its golden check compares (`output_lines`, bsw's `score=` lines on
stderr, where JAX bound that filter to the dataset table only), so that
`regress` applies it whether the command came from the table or the
command line.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str                      # CLI name, e.g. "bpm"
    module: str                    # python module implementing run(args) -> int
    description: str
    check_rule: str                # one of: exact | sorted | tolerant_abea | scalar
    timing_line: str               # greppable timing-line prefix
    # optional regex extracting the work-item count from the kernel's
    # own output, for the regress sweep's items/s scaling table
    items_re: Optional[str] = None
    items_unit: str = "items"
    # the lines of the kernel's output that a golden check compares
    # (the reference regression's grep before its diff); None: all
    output_lines: Optional[Callable[[List[str]], List[str]]] = None


def _score_lines(lines: List[str]) -> List[str]:
    """bsw's result lines (`[i] score=...`), without the timing and
    count lines, or anything else the process writes to stderr
    (bsw/scripts/regression_*.sh diffs these alone)."""
    return [ln for ln in lines if "score=" in ln]


_REGISTRY: Dict[str, KernelSpec] = {}


def register_kernel(spec: KernelSpec) -> KernelSpec:
    _REGISTRY[spec.name] = spec
    return spec


for _spec in (
    KernelSpec("abea", "genarchbench_tpu_torch.kernels.abea",
               "adaptive banded event alignment (f5c eventalign)",
               "tolerant_abea", "Data processing time:"),
    KernelSpec("bpm", "genarchbench_tpu_torch.kernels.bpm",
               "bit-parallel Myers edit distance", "sorted",
               "Time.Benchmark"),
    KernelSpec("bsw", "genarchbench_tpu_torch.kernels.bsw",
               "banded affine-gap Smith-Waterman (BWA-MEM2 extension)",
               "exact", "Overall SW cycles", output_lines=_score_lines),
    KernelSpec("chain", "genarchbench_tpu_torch.kernels.chain",
               "minimap2 anchor chaining DP (exact, with skip heuristics)",
               "exact", "Time in kernel:"),
    KernelSpec("fast-chain", "genarchbench_tpu_torch.kernels.fast_chain",
               "simplified 32-bit anchor chaining (vectorized, no "
               "heuristics)", "exact", "Time in kernel:"),
    KernelSpec("wfa", "genarchbench_tpu_torch.kernels.wfa",
               "gap-affine wavefront alignment", "sorted",
               "Time.Alignment:", r"Total.reads: (\d+)", "pairs"),
    KernelSpec("fmi", "genarchbench_tpu_torch.kernels.fmi",
               "FM-index SMEM search (BWA-MEM2 seeding)", "exact",
               "Computing time:", r"numReads = (\d+)", "reads"),
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
):
    register_kernel(_spec)


def get_kernel(name: str) -> KernelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown kernel {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_kernels() -> List[KernelSpec]:
    return sorted(_REGISTRY.values(), key=lambda s: s.name)


def load_runner(name: str) -> Callable:
    return importlib.import_module(get_kernel(name).module).run
