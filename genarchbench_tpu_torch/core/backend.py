"""Device resolution.

Entry points run on the CUDA card unless the caller asks for the CPU
(`device="cpu"`, or `GENARCH_DEVICE=cpu` for the CLIs).  A request for
the card on a host without one raises; nothing falls back to the CPU.
Which code runs is then decided by the tensors' device alone: a kernel
wrapper launches its CUDA kernel on a CUDA tensor and takes its plain
PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device`, else `GENARCH_DEVICE`, else `cuda`; raises RuntimeError
    when that names a CUDA card and none is available."""
    if device is None:
        device = os.environ.get("GENARCH_DEVICE", "cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asks for a CUDA card, but no CUDA card is "
            "available to PyTorch on this host; set GENARCH_DEVICE=cpu (or "
            "pass device='cpu') to run the plain PyTorch versions on the CPU")
    return dev
