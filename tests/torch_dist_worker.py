"""Worker process for tests/test_torch_distributed.py.

Joins a 2-process gloo group (2 CPU shards a process, 4 in all), builds
the global mesh and drives the port's collectives across processes: a
psum, an all_gather and a psum_scatter over shards of both processes,
and the sharded k-mer count's all_to_all.

Prints "DIST_OK <sum> <distinct>"; the parent asserts both workers
printed the same values.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from genarchbench_tpu_torch.io.fasta_io import ReadSet  # noqa: E402
from genarchbench_tpu_torch.kernels.kmer import (  # noqa: E402
    count_distinct_sharded)
from genarchbench_tpu_torch.sharding.mesh import (  # noqa: E402
    all_gather, global_data_mesh, init_distributed, psum, psum_scatter,
    shard_args)


def main() -> None:
    assert init_distributed() == 2
    mesh = global_data_mesh()
    assert mesh.size == 4 and mesh.world == 2 and len(mesh.devices) == 2
    pi = mesh.rank

    # each process's LOCAL items, one a shard
    local = np.arange(2, dtype=np.int64) + 10 * pi
    xs, = shard_args(mesh, local)
    total = int(psum(mesh, [x.sum() for x in xs])[0])
    assert total == (0 + 1) + (10 + 11), total
    for g in all_gather(mesh, xs):
        assert g.tolist() == [0, 1, 10, 11], g
    blocks = [torch.arange(8, dtype=torch.int64) * (mesh.offset + i + 1)
              for i in range(2)]
    got = psum_scatter(mesh, blocks)       # the sum is arange(8) * 10
    assert [t.tolist() for t in got] == [
        [20 * (mesh.offset + i), 20 * (mesh.offset + i) + 10]
        for i in range(2)], got

    rng = np.random.default_rng(7)
    seqs = [rng.integers(0, 4, 400).astype(np.uint8) for _ in range(8)]
    reads = ReadSet([f"r{i}" for i in range(8)], seqs)
    # mesh=None: the count builds the global mesh over both processes
    distinct = count_distinct_sharded(reads, 15)
    print(f"DIST_OK {total} {distinct}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
