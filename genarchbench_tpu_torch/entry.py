"""The port's entry point: the forward step of its flagship model, the
QuartzNet-CTC basecaller (nn-base), the counterpart of the JAX
package's `__graft_entry__.entry`."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from genarchbench_tpu_torch.nn.basecall import Basecaller


def entry(device: Optional[str] = None) -> Tuple[Callable, Tuple[torch.Tensor]]:
    """(fn, example_args): the DEFAULT_CONFIG model in eval mode on the
    resolved device (the card unless asked for the CPU), and a
    (4, 1, 3000) float32 chunk batch in its NCW layout; fn(*example_args)
    gives (4, 1000, 5) log-probabilities."""
    caller = Basecaller.init(chunksize=3000, device=device)
    x = torch.zeros((4, 1, 3000), dtype=torch.float32, device=caller.device)
    return caller.model, (x,)
