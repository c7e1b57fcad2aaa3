"""kmer-cnt: canonical k-mer counting (Flye) as torch ops.

Reference semantics: kmer-cnt/vertex_index.cpp COUNT_VERSION 3
(:790-860, equivalently the range-partitioned v2 at :683-785):
"Total k-mers" = number of DISTINCT canonical k-mers over all kept
reads (forward strand only, kmer-cnt/vertex_index.cpp:725-728), where
canonical = min(kmer, reverse_complement) (kmer.h:53-62), reads kept
when longer than max(min_read_length, min_overlap)
(kmer_cnt.cpp:200-210), k from the key=value config (config.h,
asm_raw_reads.cfg: kmer_size=17).

The design is the JAX package's (kernels/kmer.py), which has no Pallas
kernel:
  * the canonical code of every k-mer position of a read batch is
    computed on the device as k shifted multiply-adds over (B, L)
    tensors: no serial scan, no gathers;
  * the distinct count is one sort of all the codes on the device and a
    run-length reduction, in place of the reference's 16 GB flat 4-bit
    counter (vertex_index.cpp:803-812); only the scalar leaves the card;
  * the minimizer index (`use_minimizers = 1`) stays on the host, numpy
    and the C deque scan (`native/minimizer.c`), since its uint64 hash
    has no full torch counterpart.

What differs from JAX: a code is one int64 (k <= 31), where JAX splits it
into an (hi, lo) int32 pair with `HI_SENTINEL` padding, a TPU int32
workaround (the packed code equals hi * 65536 + lo); the forward code
takes one `torch.add(b, fwd, alpha=4)` a base and the reverse complement
one `torch.add(acc, b, alpha=4**j)`, subtracted from 4**k - 1 at the
end; JAX's host merge by `np.unique` in `count_distinct` (a TPU sort
workaround) is dropped, so the codes never leave the card; a batch holds
its reads' rows only (JAX pads each to a fixed row count to bound its
compiles).

`count_distinct_sharded` spreads the count over a mesh: each shard
computes the codes of its share of the reads on its own device (JAX
computed every code on one device and sharded them), owners come from
a 64-bit mix of the code (JAX: an int32 mix; which shard owns a code
does not change the count), and one `all_to_all` with uneven split
sizes hands every code to its owner, where JAX exchanged fixed-capacity
buckets (`capacity_factor`) and fell back to the one-device count when
one overflowed.  Neither the capacity nor the fallback is kept.  Each
owner then counts its codes as `count_distinct` does, 256-wrap
included, and a `psum` adds the counts: the result is
`count_distinct`'s.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np
import torch

from genarchbench_tpu_torch import native
from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.core.config import load_kv_config
from genarchbench_tpu_torch.core.roi import Laps, ROITimer, span
from genarchbench_tpu_torch.io.fasta_io import ReadSet, read_fasta
from genarchbench_tpu_torch.sharding.batching import next_pow2
from genarchbench_tpu_torch.sharding.mesh import (Mesh, all_to_all,
                                                  device_scope,
                                                  global_data_mesh, psum,
                                                  shard_ranges)

MAX_K = 31                  # an int64 code holds 31 bases
SENTINEL = 1 << 62          # sorts after every valid code (< 4**31)


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k}: the int64 k-mer codes hold 1 to "
                         f"{MAX_K} bases")


def _codes_device(seqs: torch.Tensor, lens: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Canonical codes (int64) of every k-mer position of a read batch.

    seqs (B, L) 2-bit codes (uint8 or int32), lens (B,).  Returns
    (B, max(L - k, 0)): position i holds min(fwd, rc) of bases
    [i, i + k), or SENTINEL where i >= len - k.  IterKmers stops before
    len - k (kmer.h:194-198), so positions L - k and beyond are never
    valid and are not computed (JAX's (B, L) output holds its sentinel
    there)."""
    _check_k(k)
    B, L = seqs.shape
    n = max(L - k, 0)
    fwd = seqs[:, :n].long()
    rc = seqs[:, :n].long()
    for j in range(1, k):
        b = seqs[:, j:j + n]
        fwd = torch.add(b, fwd, alpha=4)          # first bases high
        rc = torch.add(rc, b, alpha=4 ** j)       # base j weighs 4**j
    rc = (4 ** k - 1) - rc                        # sum of (3 - b) 4**j
    canon = torch.minimum(fwd, rc)
    pos = torch.arange(n, device=seqs.device)
    valid = pos[None, :] < (lens.to(torch.int64)[:, None] - k)
    return torch.where(valid, canon, SENTINEL)


def _distinct_count_device(codes: torch.Tensor) -> torch.Tensor:
    """ONE sort of the flat int64 codes, then count k-mers the way the
    reference does: its 8-bit flat counter re-counts a k-mer every time
    the counter wraps (vertex_index.cpp:820-833, 'WARNING: This is wrong
    if there is overflow'), so the reported total is sum(ceil(count /
    256)) over distinct canonical k-mers, replicated here by the rank of
    each element within its sorted run: its index less its run's first
    index, which a binary search of the sorted codes finds (JAX takes
    a running max of the run starts instead).  Returns a 0-dim tensor
    on the codes' device."""
    s = torch.sort(codes).values
    rank = torch.arange(s.numel(), device=s.device) - torch.searchsorted(s, s)
    return ((rank % 256 == 0) & (s < SENTINEL)).sum()


def _batches(reads: ReadSet, k: int, batch_bases: int):
    """count_distinct's batches, as in JAX: reads bucketed by power-of-two
    padded length L (at least 2048), cut into at most max(8, batch_bases
    / L) rows (rounded up to 8).  Yields (rows (n, L) uint8 codes
    zero-padded, lens (n,) int32)."""
    buckets = defaultdict(list)
    for i, s in enumerate(reads.seqs):
        buckets[max(next_pow2(max(len(s), k), 2048), 2048)].append(i)
    for L, idxs in sorted(buckets.items()):
        rows = max(8, min(_round_up(len(idxs), 8),
                          _round_up(batch_bases // L, 8)))
        for lo in range(0, len(idxs), rows):
            chunk = idxs[lo:lo + rows]
            arr = np.zeros((len(chunk), L), np.uint8)
            lens = np.zeros(len(chunk), np.int32)
            for row, i in enumerate(chunk):
                s = reads.seqs[i]
                arr[row, :len(s)] = s
                lens[row] = len(s)
            yield arr, lens


def count_distinct(reads: ReadSet, k: int, batch_bases: int = 1 << 25, *,
                   device: Optional[str] = None,
                   stats: Optional[dict] = None) -> int:
    """Total k-mers across all reads: per-batch canonical codes on
    `device` (the card unless asked for the CPU), all batches' codes
    kept there and counted by `_distinct_count_device`; only the count
    comes back.

    Batches as `_batches` cuts them.  Replicates the reference's 8-bit
    counter overflow: a k-mer seen c times contributes ceil(c / 256)
    (vertex_index.cpp:820-833 re-counts on every wrap).  With `stats`, a
    dict, adds the seconds of each phase (a sync at each boundary):
    pack_s (host packing), h2d_s, codes_s, count_s, and the counts
    batches and codes (the positions sorted, sentinels included)."""
    _check_k(k)
    dev = resolve_device(device)
    laps = Laps(stats, dev)
    parts = []
    for arr, lens in _batches(reads, k, batch_bases):
        laps("pack_s")
        seqs_d = torch.from_numpy(arr).to(dev)
        lens_d = torch.from_numpy(lens).to(dev)
        laps("h2d_s")
        with span("kmer.codes"):
            parts.append(_codes_device(seqs_d, lens_d, k).reshape(-1))
        laps("codes_s")
    if not parts:
        return 0
    with span("kmer.count"):
        codes = torch.cat(parts) if len(parts) > 1 else parts[0]
        total = int(_distinct_count_device(codes))
    laps("count_s")
    if stats is not None:
        stats["batches"] = stats.get("batches", 0) + len(parts)
        stats["codes"] = stats.get("codes", 0) + codes.numel()
    return total


def count_distinct_hostmerge(reads: ReadSet, k: int,
                             batch_bases: int = 1 << 25, *,
                             device: Optional[str] = None) -> int:
    """For inputs whose codes exceed device memory: per-batch codes on
    `device` (the card unless asked for the CPU), each batch's distinct
    codes merged on the host by np.unique.  The result is the plain
    distinct count, without the 256-wrap replication."""
    _check_k(k)
    dev = resolve_device(device)
    order = np.argsort([len(s) for s in reads.seqs])[::-1]
    uniq_parts = []
    batch: list = []
    batch_cells = 0
    Lmax = 0

    def flush():
        nonlocal batch, batch_cells, Lmax
        if not batch:
            return
        arr = np.zeros((len(batch), Lmax), np.uint8)
        lens = np.zeros(len(batch), np.int32)
        for i, s in enumerate(batch):
            arr[i, :len(s)] = s
            lens[i] = len(s)
        code = _codes_device(torch.from_numpy(arr).to(dev),
                             torch.from_numpy(lens).to(dev), k).reshape(-1)
        code = code[code < SENTINEL].cpu().numpy()
        uniq_parts.append(np.unique(code))
        batch, batch_cells, Lmax = [], 0, 0

    for i in order:
        s = reads.seqs[i]
        Lpad = _round_up(max(len(s), k), 256)
        if batch and (batch_cells + Lpad > batch_bases or Lpad != Lmax):
            flush()
        Lmax = max(Lmax, Lpad)
        batch.append(s)
        batch_cells += Lpad
    flush()
    if not uniq_parts:
        return 0
    return int(np.unique(np.concatenate(uniq_parts)).size)


_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)     # splitmix64's multipliers, as
_MIX2 = 0x94D049BB133111EB - (1 << 64)     # the int64 of the same bits


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """x >> s on the 64 bits of x, as a uint64 shift: torch's `>>` on
    int64 copies the sign bit, so the top s bits are masked off."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def code_owner(codes: torch.Tensor, S: int) -> torch.Tensor:
    """The shard (0..S-1) that owns each int64 code: splitmix64's
    finalizer of the code (multiplies wrap at 64 bits in torch's int64,
    shifts are logical), its top 31 bits mod S."""
    x = codes ^ _srl(codes, 30)
    x = x * _MIX1
    x = x ^ _srl(x, 27)
    x = x * _MIX2
    x = x ^ _srl(x, 31)
    return _srl(x, 33) % S


def count_distinct_sharded(reads: ReadSet, k: int,
                           mesh: Optional[Mesh] = None) -> int:
    """`count_distinct` spread over a mesh (by default every process's
    devices, `global_data_mesh`): the reads cut into one contiguous share
    a shard (`shard_ranges`; a shard may hold none), each share's codes
    on its device, every code sent to its owner (`code_owner`) by one
    `all_to_all`, each owner's count as `count_distinct`'s and a `psum`
    of the counts.  A process of a process group passes every read and
    counts its own shards' shares.  Without a mesh, or on one device,
    `count_distinct`."""
    _check_k(k)
    if mesh is None:
        mesh = global_data_mesh()
    if mesh is None or mesh.size == 1:
        return count_distinct(reads, k,
                              device=mesh.devices[0] if mesh else None)
    S = mesh.size
    sends = []
    for dev, (lo, hi) in zip(mesh.devices, shard_ranges(len(reads), mesh)):
        with device_scope(dev):
            share = ReadSet(reads.names[lo:hi], reads.seqs[lo:hi])
            codes = [_codes_device(torch.from_numpy(arr).to(dev),
                                   torch.from_numpy(lens).to(dev),
                                   k).reshape(-1)
                     for arr, lens in _batches(share, k, 1 << 25)]
            c = (torch.cat(codes) if codes else
                 torch.zeros(0, dtype=torch.int64, device=dev))
            c = c[c < SENTINEL]
            owner = code_owner(c, S)
            order = torch.argsort(owner, stable=True)
            sizes = torch.bincount(owner, minlength=S).tolist()
            sends.append(list(torch.split(c[order], sizes)))
    counts = []
    for dev, got in zip(mesh.devices, all_to_all(mesh, sends)):
        with device_scope(dev):
            counts.append(_distinct_count_device(torch.cat(got)))
    return int(psum(mesh, counts)[0])


# ---------------------------------------------------------------------------
# minimizer index (buildIndexMinimizers, vertex_index.cpp:394-470), host
# ---------------------------------------------------------------------------

def _kmer_hash(x: int) -> int:
    """Kmer::hash (kmer.h:93-100): splitmix64 finalizer."""
    M = (1 << 64) - 1
    z = (x + 0x9E3779B97F4A7C15) & M
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M
    return z ^ (z >> 31)


def _splitmix64_arr(x: np.ndarray) -> np.ndarray:
    """Vectorized Kmer::hash (kmer.h:93-100)."""
    with np.errstate(over="ignore"):
        z = x + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _deque_scan_py(h: np.ndarray, window: int) -> np.ndarray:
    """The C minimizer deque scan's plain version, in Python."""
    from collections import deque
    q: deque = deque()           # positions
    out = []
    hl = h.tolist()
    for i in range(len(hl)):
        while q and hl[q[-1]] > hl[i]:
            q.pop()
        q.append(i)
        if q[0] <= i - window:
            while q[0] <= i - window:
                q.popleft()
            while len(q) >= 2 and hl[q[0]] == hl[q[1]]:
                q.popleft()
        if not out or out[-1] != q[0]:
            out.append(q[0])
    return np.asarray(out, np.int64)


def _minimizer_arrays(codes: np.ndarray, k: int, window: int):
    """(positions, fwd_codes, canonical_codes) of the minimizers of one
    read: vectorized k-mer codes and hashes, then the C deque scan
    (exact yieldMinimizers semantics, kmer.h:206-260: strictly-greater
    back pops keep ties, equal-hash front skipping after expiry, one
    emit per front position)."""
    n = len(codes) - k          # IterKmers drops the final position
    z = np.zeros(0, np.uint64)
    if n <= 0:
        return np.zeros(0, np.int64), z, z
    c = codes.astype(np.uint64)
    sw = np.lib.stride_tricks.sliding_window_view(c, k)[:n]
    wf = np.uint64(1) << (np.uint64(2)
                          * np.arange(k - 1, -1, -1, dtype=np.uint64))
    wr = np.uint64(1) << (np.uint64(2) * np.arange(k, dtype=np.uint64))
    with np.errstate(over="ignore"):
        fwd = (sw * wf).sum(axis=1, dtype=np.uint64)
        rc = ((np.uint64(3) - sw) * wr).sum(axis=1, dtype=np.uint64)
    canon = np.minimum(fwd, rc)
    if window == 1:
        return np.arange(n, dtype=np.int64), fwd, canon
    pos = native.minimizer_scan(_splitmix64_arr(canon), window)
    return pos, fwd[pos], canon[pos]


def yield_minimizers(codes: np.ndarray, k: int, window: int):
    """Exact yieldMinimizers (kmer.h:206-260).
    Returns [(position, fwd_code)]."""
    pos, fwd, _ = _minimizer_arrays(codes, k, window)
    return list(zip(pos.tolist(), fwd.tolist()))


def build_minimizer_index(reads: ReadSet, k: int, window: int,
                          min_coverage: int = 1,
                          repeat_kmer_rate: float = 100.0):
    """buildIndexMinimizers: count canonical minimizers, mark
    repetitive ones above rate * mean-frequency
    (vertex_index.cpp:394-470 + filterFrequentKmers).  Returns
    (counts dict canonical_code -> n, repetitive set)."""
    cats = [_minimizer_arrays(s, k, window)[2] for s in reads.seqs]
    allc = (np.concatenate(cats) if cats else np.zeros(0, np.uint64))
    uniqv, cnts = np.unique(allc, return_counts=True)
    counts: dict = dict(zip(uniqv.tolist(), cnts.tolist()))
    total = sum(c for c in counts.values() if c >= min_coverage)
    uniq = sum(1 for c in counts.values() if c >= min_coverage)
    thresh = repeat_kmer_rate * (total / (uniq + 1))
    repetitive = {km for km, c in counts.items() if c > thresh}
    return counts, repetitive


def parse_config(path: str) -> dict:
    """Flye key=value config with %include (kmer-cnt/config.h)."""
    return load_kv_config(path)


def run(argv: Sequence[str]) -> int:
    """CLI compatible with the reference kmer_cnt (kmer_cnt.cpp:80-130):
    --reads F --config F [--threads N] [--kmer K] [--min-ovlp N]
    [--debug]; runs on the card unless GENARCH_DEVICE=cpu."""
    import argparse
    p = argparse.ArgumentParser(prog="kmer-cnt")
    p.add_argument("--reads", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--kmer", type=int, default=-1)
    p.add_argument("--min-ovlp", dest="min_ovlp", type=int, default=5000)
    p.add_argument("--min-read", dest="min_read", type=int, default=0)
    p.add_argument("--debug", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device()

    cfg = parse_config(args.config)
    k = args.kmer if args.kmer > 0 else int(cfg.get("kmer_size", 15))
    use_minimizers = int(cfg.get("use_minimizers", "0"))
    min_len = max(args.min_read, args.min_ovlp)

    print(f"DEBUG: Running with k-mer size: {k}", file=sys.stderr)
    print("INFO: Reading sequences", file=sys.stderr)
    reads = read_fasta(args.reads, min_len=min_len)
    total_bp = sum(len(s) for s in reads.seqs)
    print(f"DEBUG: Total sequence: {total_bp} bp", file=sys.stderr)

    roi = ROITimer("kmer-cnt", "Kernel time: {t:.3f} sec")
    with roi:
        if use_minimizers:
            wnd = int(cfg.get("minimizer_window", 5))
            counts, repetitive = build_minimizer_index(reads, k, wnd)
            print(f"DEBUG: Minimizers {len(counts)} "
                  f"(repetitive {len(repetitive)})", file=sys.stderr)
            n = len(counts)
        else:
            n = count_distinct(reads, k, device=dev)
        roi.sync()
    print(f"DEBUG: Total k-mers {n}", file=sys.stderr)
    roi.report(file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
