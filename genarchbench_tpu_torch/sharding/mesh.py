"""Device meshes and data-parallel sharding: the port's copy of the JAX
package's sharding/mesh.py.

The reference parallelizes every kernel with OpenMP `parallel for` over
independent work items (SURVEY.md §2.4).  The JAX package maps that to
SPMD over a 1-D device mesh; the port keeps its model: one controller
per process over the process's local devices, plus a process group
(`torch.distributed`) across processes.  Kernels accept an optional
`mesh`; the CLIs build one from GENARCH_DEVICES, which the harness's job
scripts export (harness/scheduler.py::_job_script).

A `Mesh` holds this process's shard devices.  Work items split along
their leading axis into equal contiguous chunks, chunk i on device i,
so shard i holds the items JAX's device i held; outputs come back in
shard order.  Shards run one after another in the calling thread, each
with its device current.  A batch function that launches every shard's
work before it reads any result back (bpm, bsw) lets the shards of
different cards overlap; the others (wfa, chain, fast-chain, abea, fmi
with replicated tables) read each shard's results to the host before
the next shard starts, so on n cards they run one card after another.
The one exception is fmi with sharded tables, whose shards must meet at
every table read: it runs a thread a shard (`run_threads`), which meet
in an `Exchange`.

The collectives take a list of per-shard tensors, one for each local
device: between local devices they are copies, across processes they
go through `torch.distributed` (NCCL for CUDA meshes, gloo for CPU
ones).  A collective that fails raises.

What differs from JAX: `data_mesh` raises when asked for more cards than
the host has, where JAX silently clamps to the devices it finds; a
GENARCH_DEVICE=cpu mesh holds n CPU shards, which stand in for the JAX
tests' 8 virtual host devices (the same splits, run one after another).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.core.config import EnvConfig


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: this process's shard devices, and, in a process group,
    the process's rank and the group's size.  Shard i of this process is
    shard `offset + i` of the mesh."""
    devices: Tuple[torch.device, ...]
    axis_name: str = "batch"
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        return len(self.devices) * self.world

    @property
    def offset(self) -> int:
        return self.rank * len(self.devices)


def devices_from_env() -> int:
    """GENARCH_DEVICES, exported by the harness job scripts (1 when unset
    or malformed)."""
    return EnvConfig.from_env().devices


def _device_type() -> str:
    return torch.device(EnvConfig.from_env().device or "cuda").type


def _local_devices(n: int, first: int = 0) -> Tuple[torch.device, ...]:
    """n shard devices of GENARCH_DEVICE's type: CPU shards, or the cards
    first .. first + n - 1, which the host must have."""
    kind = _device_type()
    if kind == "cpu":
        return (torch.device("cpu"),) * n
    if kind != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu devices, not {kind}")
    have = torch.cuda.device_count()
    if first + n > have:
        raise RuntimeError(
            f"a mesh of {n} CUDA cards from card {first} asks for more "
            f"cards than this host has ({have}); lower GENARCH_DEVICES, or "
            "set GENARCH_DEVICE=cpu for a mesh of CPU shards")
    return tuple(torch.device("cuda", first + i) for i in range(n))


def init_distributed() -> int:
    """Join the process group when the harness asked for more than one
    process; returns the process count in effect.  Idempotent.

    Env contract (the JAX package's):
      GENARCH_HOSTS        total process count (1 = no-op)
      GENARCH_COORDINATOR  host:port of process 0 (tcp:// rendezvous)
      GENARCH_PROCESS_ID   this process's rank, required with a coordinator
    Without a coordinator the group initializes from `env://`
    (MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE, which torchrun and
    SLURM wrappers set).  The backend is NCCL for GENARCH_DEVICE=cuda
    and gloo for cpu."""
    cfg = EnvConfig.from_env()
    n = cfg.hosts
    if n <= 1:
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    backend = "gloo" if _device_type() == "cpu" else "nccl"
    if cfg.coordinator:
        if cfg.process_id is None:
            raise RuntimeError(
                "GENARCH_COORDINATOR is set but GENARCH_PROCESS_ID is "
                "not a rank; export this process's rank "
                "(0..GENARCH_HOSTS-1)")
        dist.init_process_group(backend,
                                init_method=f"tcp://{cfg.coordinator}",
                                world_size=n, rank=cfg.process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    return n


def data_mesh(n_devices: Optional[int] = None,
              axis_name: str = "batch") -> Optional[Mesh]:
    """A mesh over the first `n_devices` devices of this process
    (GENARCH_DEVICES when None, of GENARCH_DEVICE's type); None for
    n <= 1, the single-device path.  Raises RuntimeError when the host
    has fewer cards: a scaling line that says n devices must have run
    on n."""
    if n_devices is None:
        n_devices = devices_from_env()
    if n_devices <= 1:
        return None
    return Mesh(_local_devices(n_devices), axis_name)


def global_data_mesh(axis_name: str = "batch") -> Optional[Mesh]:
    """A mesh over every process's GENARCH_DEVICES devices (after
    init_distributed); None when that is a single device.  With several
    processes on one host, a process's cards start at LOCAL_RANK x
    GENARCH_DEVICES."""
    world = init_distributed()
    n = devices_from_env()
    if world <= 1:
        return data_mesh(n, axis_name)
    first = int(os.environ.get("LOCAL_RANK", "0")) * n
    return Mesh(_local_devices(n, first), axis_name, dist.get_rank(), world)


def mesh_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.size


def pad_batch(n: int, mesh: Optional[Mesh]) -> int:
    """Smallest padded leading dim >= n divisible by the mesh size."""
    s = mesh_size(mesh)
    return ((n + s - 1) // s) * s


def mesh_devices(mesh: Optional[Mesh],
                 device=None) -> Tuple[torch.device, ...]:
    """The devices work runs on: the mesh's, or without one the resolved
    `device` (the card unless asked for the CPU)."""
    return mesh.devices if mesh is not None else (resolve_device(device),)


def device_scope(dev: torch.device):
    """`dev` made the current card for a block (nothing for the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def shard_ranges(n: int, mesh: Mesh) -> List[Tuple[int, int]]:
    """[lo, hi) of each of this process's shards over n items cut into
    mesh.size equal contiguous chunks of pad_batch(n) / size items; the
    last shards hold fewer, or none, where n is not a multiple."""
    c = pad_batch(n, mesh) // mesh.size
    return [(min(n, g * c), min(n, (g + 1) * c))
            for g in range(mesh.offset, mesh.offset + len(mesh.devices))]


def shard_index(n: int, mesh: Mesh) -> List[np.ndarray]:
    """Item indices of each local shard: range(n) padded to a multiple of
    the local shard count by repeating item n - 1, cut into equal
    contiguous chunks.  Padding repeats a real item, so every shard's
    inputs are ones its kernels take like any other; the outputs of the
    repeats are cut away (`gather_shards`)."""
    L = len(mesh.devices)
    c = -(-n // L)
    idx = np.minimum(np.arange(c * L), max(n - 1, 0))
    return [idx[i * c:(i + 1) * c] for i in range(L)]


def shard_args(mesh: Optional[Mesh], *arrays):
    """Each array (numpy or torch, same leading length n) padded and cut
    by `shard_index`, chunk i put on local device i: one list of tensors
    per array.  A process of a process group passes its LOCAL items, as
    in JAX.  Without a mesh, the arrays as they are."""
    if mesh is None:
        return arrays
    n = len(arrays[0])
    parts = shard_index(n, mesh)
    out = []
    for a in arrays:
        if len(a) != n:
            raise ValueError(f"shard_args: leading lengths {len(a)} != {n}")
        if isinstance(a, np.ndarray):
            out.append([torch.from_numpy(np.ascontiguousarray(a[ix])).to(d)
                        for ix, d in zip(parts, mesh.devices)])
        else:
            out.append([a[torch.from_numpy(ix).to(a.device)].to(d)
                        for ix, d in zip(parts, mesh.devices)])
    return tuple(out)


def shard_items(items: np.ndarray, mesh: Optional[Mesh]) -> List[np.ndarray]:
    """`items` (an index array) cut by `shard_index`, one part a local
    device; [items] without a mesh."""
    if mesh is None:
        return [items]
    return [items[ix] for ix in shard_index(len(items), mesh)]


def gather_shards(parts: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """The shards' outputs on the CPU in shard order, cut to n items."""
    return torch.cat([p.cpu() for p in parts])[:n]


# ---------------------------------------------------------------------------
# collectives over lists of per-shard tensors
# ---------------------------------------------------------------------------

def _comm_device(mesh: Mesh) -> torch.device:
    """Where the process group takes its tensors: the CPU for gloo, this
    process's first card for NCCL."""
    return (torch.device("cpu") if dist.get_backend() == "gloo"
            else mesh.devices[0])


def _check_local(mesh: Mesh, xs: Sequence[torch.Tensor], what: str) -> None:
    if len(xs) != len(mesh.devices):
        raise ValueError(f"{what}: {len(xs)} tensors for "
                         f"{len(mesh.devices)} local shards")


def psum(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over every shard of the mesh, on each local shard's
    device."""
    _check_local(mesh, xs, "psum")
    total = sum(x.to(xs[0].device) for x in xs)
    if mesh.world > 1:
        t = total.to(_comm_device(mesh))
        dist.all_reduce(t)
        total = t
    return [total.to(x.device) for x in xs]


def all_gather(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard's (m, ...) tensor concatenated in mesh order, (size *
    m, ...), on each local shard's device; all shapes must be equal."""
    _check_local(mesh, xs, "all_gather")
    if len({tuple(x.shape) for x in xs}) != 1:
        raise ValueError("all_gather: the shards' shapes differ")
    full = torch.cat([x.to(xs[0].device) for x in xs])
    if mesh.world > 1:
        t = full.to(_comm_device(mesh))
        bufs = [torch.empty_like(t) for _ in range(mesh.world)]
        dist.all_gather(bufs, t)
        full = torch.cat(bufs)
    return [full.to(x.device) for x in xs]


def psum_scatter(mesh: Mesh, xs: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
    """The sum over every shard of the (size * m, ...) tensors, block g
    of it to shard g: (m, ...) on each local shard's device.  Across
    processes the sum is one all_reduce, of which each process keeps its
    blocks."""
    total = psum(mesh, xs)[0]
    if total.shape[0] % mesh.size:
        raise ValueError(f"psum_scatter: {total.shape[0]} rows do not "
                         f"split over {mesh.size} shards")
    m = total.shape[0] // mesh.size
    return [total[(mesh.offset + i) * m:(mesh.offset + i + 1) * m].to(x.device)
            for i, x in enumerate(xs)]


def all_to_all(mesh: Mesh, parts: Sequence[Sequence[torch.Tensor]]
               ) -> List[List[torch.Tensor]]:
    """parts[i][g]: what local shard i sends to shard g of the mesh
    (tensors of one dtype and trailing shape, any leading length).
    Returns recv[i][g]: what shard g sent to local shard i, on local
    device i.  Across processes: one exchange of the counts, then one
    `all_to_all_single` with uneven split sizes."""
    L, S = len(mesh.devices), mesh.size
    _check_local(mesh, parts, "all_to_all")
    if any(len(row) != S for row in parts):
        raise ValueError(f"all_to_all: every shard sends {S} parts")
    if mesh.world == 1:
        return [[parts[g][i].to(d) for g in range(S)]
                for i, d in enumerate(mesh.devices)]
    comm = _comm_device(mesh)
    o, W = mesh.offset, mesh.world
    counts = torch.tensor([[p.shape[0] for p in row] for row in parts],
                          dtype=torch.int64)                    # (L, S)
    bufs = [torch.empty_like(counts.to(comm)) for _ in range(W)]
    dist.all_gather(bufs, counts.to(comm))
    allc = torch.stack(bufs).cpu()                              # (W, L, S)
    # to process q go, for each local shard i and each of q's shards j,
    # parts[i][q * L + j], in that order
    send = torch.cat([parts[i][q * L + j].to(comm)
                      for q in range(W) for i in range(L) for j in range(L)])
    in_splits = [int(counts[:, q * L:(q + 1) * L].sum()) for q in range(W)]
    out_splits = [int(allc[p, :, o:o + L].sum()) for p in range(W)]
    recv = send.new_empty((sum(out_splits), *send.shape[1:]))
    dist.all_to_all_single(recv, send, out_splits, in_splits)
    out: List[List[Optional[torch.Tensor]]] = [[None] * S for _ in range(L)]
    pos = 0
    for p in range(W):
        for i_p in range(L):
            for j in range(L):
                c = int(allc[p, i_p, o + j])
                out[j][p * L + i_p] = recv[pos:pos + c].to(mesh.devices[j])
                pos += c
    return out


class Exchange:
    """Lockstep exchanges among threads, one thread per local shard:
    each live shard calls `exchange(i, value)`, and once every shard
    that has not left has called it, `combine(values)` runs once (in the
    last caller) over the list of values, None for the shards that left,
    and each caller gets its entry of the result.  A shard that is done,
    or failed, calls `leave(i)`, after which the others go on without
    it; a failed combine raises in every caller."""

    def __init__(self, n: int, combine: Callable[[list], list]):
        self.combine = combine
        self._cv = threading.Condition()
        self._vals: list = [None] * n
        self._active = n
        self._arrived = 0
        self._gen = 0
        self._out: list = []
        self._error: Optional[BaseException] = None

    def _run(self) -> None:
        try:
            self._out = self.combine(list(self._vals))
        except BaseException as e:   # re-raised in every caller
            self._error = e
        self._vals = [None] * len(self._vals)
        self._arrived = 0
        self._gen += 1
        self._cv.notify_all()

    def exchange(self, i: int, value):
        with self._cv:
            if self._error is not None:
                raise RuntimeError("exchange: another shard failed") \
                    from self._error
            gen = self._gen
            self._vals[i] = value
            self._arrived += 1
            if self._arrived == self._active:
                self._run()
            while self._gen == gen:
                self._cv.wait()
            if self._error is not None:
                raise RuntimeError("exchange: the combine failed") \
                    from self._error
            return self._out[i]

    def leave(self, i: int) -> None:
        with self._cv:
            self._active -= 1
            if self._arrived and self._arrived == self._active:
                self._run()


def run_threads(fns: Sequence[Callable[[], object]],
                exchange: Optional[Exchange] = None) -> list:
    """Run each shard's fn in its own thread and return their results in
    order; a shard leaves `exchange` when its fn returns or raises.  The
    first error is raised after every thread has ended."""
    results: list = [None] * len(fns)
    errors: list = [None] * len(fns)

    def body(i):
        try:
            results[i] = fns[i]()
        except BaseException as e:    # re-raised in the caller
            errors[i] = e
        finally:
            if exchange is not None:
                exchange.leave(i)

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results
