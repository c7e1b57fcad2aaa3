"""Umbrella CLI of the PyTorch/CUDA port.

    python -m genarchbench_tpu_torch.cli list
    python -m genarchbench_tpu_torch.cli run <kernel> [kernel args...]

`run` dispatches to the kernel's own reference-compatible CLI (see the
registry, core/registry.py).  Kernels run on the CUDA card; set
GENARCH_DEVICE=cpu to run their plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from genarchbench_tpu_torch.core.registry import list_kernels, load_runner


def cmd_list() -> int:
    for spec in list_kernels():
        print(f"{spec.name:12s} {spec.check_rule:14s} {spec.description}")
    return 0


def cmd_run(name: str, args: List[str]) -> int:
    return load_runner(name)(args) or 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv.pop(0)
    if cmd == "list":
        return cmd_list()
    if cmd == "run":
        if not argv:
            print("usage: run <kernel> [args...]", file=sys.stderr)
            return 1
        return cmd_run(argv[0], argv[1:])
    print(f"unknown command {cmd!r}; try list|run", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
