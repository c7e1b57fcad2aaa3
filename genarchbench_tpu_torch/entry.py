"""The port's entry points, the counterparts of the JAX package's
`__graft_entry__`: `entry`, the forward step of its flagship model, the
QuartzNet-CTC basecaller (nn-base), and `dryrun_multichip`, one training
step of that model over a (dp, sp, tp) grid of devices, then the
k-mer and FM-index collective checks.

    python -m genarchbench_tpu_torch.entry [n_devices]    # default 8

runs `dryrun_multichip` on n cards, or on n CPU shards under
GENARCH_DEVICE=cpu.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from genarchbench_tpu_torch.nn.basecall import Basecaller
from genarchbench_tpu_torch.nn.train import step_from_state
from genarchbench_tpu_torch.sharding.mesh import Mesh, data_grid


def entry(device: Optional[str] = None) -> Tuple[Callable, Tuple[torch.Tensor]]:
    """(fn, example_args): the DEFAULT_CONFIG model in eval mode on the
    resolved device (the card unless asked for the CPU), and a
    (4, 1, 3000) float32 chunk batch in its NCW layout; fn(*example_args)
    gives (4, 1000, 5) log-probabilities."""
    caller = Basecaller.init(chunksize=3000, device=device)
    x = torch.zeros((4, 1, 3000), dtype=torch.float32, device=caller.device)
    return caller.model, (x,)


def tiny_config(filters: int = 16, n_classes: int = 5) -> Dict[str, Any]:
    """The dryrun's three-block model (`__graft_entry__._tiny_config`):
    a k 9 / stride 3 conv, a separable residual block of repeat 2, a k 1
    conv to 2 x filters, every dropout 0.0."""
    return {
        "input": {"features": 1},
        "encoder": {"activation": "swish"},
        "labels": {"labels": ["N", "A", "C", "G", "T"][:n_classes]},
        "block": [
            dict(filters=filters, repeat=1, kernel=[9], stride=[3],
                 dilation=[1], dropout=0.0, residual=False, separable=False),
            dict(filters=filters, repeat=2, kernel=[9], stride=[1],
                 dilation=[1], dropout=0.0, residual=True, separable=True),
            dict(filters=filters * 2, repeat=1, kernel=[1], stride=[1],
                 dilation=[1], dropout=0.0, residual=False, separable=False),
        ],
    }


def dryrun_multichip(n_devices: int = 8, device: Optional[str] = None,
                     devices: Optional[Sequence] = None) -> Dict[str, Any]:
    """One training step of `tiny_config(8 x tp)` over the
    `mesh_factors(n)` grid, on `devices` or n local devices of the
    resolved type (the card unless asked for the CPU; raises when the
    host has fewer cards): B = 2 x dp all-ones chunks of 96 samples,
    labels of eight 1s with no padding, weights from `Basecaller.init`'s
    seed 0.  Then kmer's `count_distinct_sharded` against
    `count_distinct` and fmi's sharded tables against the replicated
    ones over the same devices; raises when either disagrees or the loss
    is not finite.  Prints JAX's `dryrun_multichip ok:` line and returns
    its fields with the step's config, batch, initial and new state and
    gradients (on the CPU)."""
    from genarchbench_tpu_torch.io.fasta_io import ReadSet
    from genarchbench_tpu_torch.kernels import fmi as fmi_mod
    from genarchbench_tpu_torch.kernels.kmer import (count_distinct,
                                                     count_distinct_sharded)

    grid = data_grid(n_devices, device, devices)
    dp, sp, tp = grid.shape
    cfg = tiny_config(filters=8 * tp)
    B, T, L = 2 * dp, 96, 8
    initial = Basecaller.init(cfg, seed=0, device="cpu").model.state_dict()
    batch = (torch.ones((B, 1, T)), torch.ones((B, L), dtype=torch.int64),
             torch.zeros((B, L)))
    loss, state, grads = step_from_state(cfg, initial, *batch, grid=grid)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: non-finite loss {loss}")

    # kmer-cnt's all_to_all k-mer-space exchange and psum
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 4, 300).astype(np.uint8) for _ in range(6)]
    reads = ReadSet([f"r{i}" for i in range(6)], seqs)
    got = count_distinct_sharded(reads, 15, mesh=Mesh(grid.devices,
                                                      "kspace"))
    want = count_distinct(reads, 15, device=grid.devices[0])
    if got != want:
        raise RuntimeError(f"dryrun_multichip: sharded k-mer count {got} "
                           f"!= {want}")

    # fmi with its occ table split by rows over the devices: the SMEMs
    # must equal the replicated tables' exactly
    ref_codes = rng.integers(0, 4, 20000).astype(np.uint8)
    index = fmi_mod.build_index(ref_codes)
    fmi_sh = fmi_mod.FMISearch(index, mesh=Mesh(grid.devices, "batch"),
                               shard_tables=True)
    fmi_rep = fmi_mod.FMISearch(index, device=grid.devices[0])
    fq = [ref_codes[p:p + 80].copy() for p in (100, 5000, 12000, 17000)]
    got_s = fmi_mod.search_reads(fmi_sh, fq, 8, 19)
    want_s = fmi_mod.search_reads(fmi_rep, fq, 8, 19)
    if not all(np.array_equal(a, b) for a, b in zip(got_s[0], want_s[0])):
        raise RuntimeError("dryrun_multichip: sharded-table SMEM mismatch")
    nsmem = len(got_s[0][0])

    print(f"dryrun_multichip ok: mesh dp={dp} sp={sp} tp={tp} "
          f"loss={loss:.4f} kmer_all_to_all={got} "
          f"fmi_sharded_smems={nsmem}")
    return dict(mesh=(dp, sp, tp), loss=loss, kmer_all_to_all=got,
                fmi_sharded_smems=nsmem, config=cfg, batch=batch,
                initial=initial, state=state, grads=grads)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
