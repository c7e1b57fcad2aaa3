"""GenArchBench on PyTorch and CUDA: the genomics kernels of
`genarchbench_tpu` ported to an NVIDIA Hopper card.

The JAX package stays the reference; this package imports none of it
and keeps its own copies of what it needs.  Layers:
  core/     device resolution, kernel registry, ROI timing, golden checks
  io/       host-side readers of the reference's input formats
  kernels/  the kernels' host code (numpy) and their device code: torch
            ops, and hand-written CUDA C++ where the JAX package had a
            Pallas kernel (csrc/*.cu, built by kernels/_build.py)

Entry points run on the card (`GENARCH_DEVICE`, default `cuda`) and
raise when there is none; `GENARCH_DEVICE=cpu` runs the kernels' plain
PyTorch versions, which the tests compare with the JAX package.
"""

__version__ = "0.1.0"

from genarchbench_tpu_torch.core.registry import get_kernel, list_kernels  # noqa: F401
