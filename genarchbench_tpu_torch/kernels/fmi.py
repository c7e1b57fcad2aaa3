"""fmi: FM-index super-maximal exact match (SMEM) search as torch ops.

Reference semantics: fmi/fmi.cpp's main loop (3 passes :250-360, output
:429-461) over bwa-mem2's FMI_search
(bwa-mem2/sve/src/FMI_search.cpp): all-SMEM pass
`getSMEMsAllPosOneThread` :915, reseed `getSMEMsOnePosOneThread` :498,
LAST pass `bwtSeedStrategyAllPosOneThread` :975, `backwardExt`
:1268-1298 with the 64-entry checkpointed occ + one-hot BWT popcount
(GET_OCC, FMI_search.h:71-79), `sortSMEMs`/compare_smem (rid asc, m
asc, n desc) :1230-1265, and the index layout of build_index /
build_fm_index (reference = forward + reverse complement,
sentinel-first suffix array, BWT char 4 at the sentinel row).

The design is the JAX package's (kernels/fmi.py), which has no Pallas
kernel, so every loop here is torch ops on the device:
  * the index is built on the host (SA-IS in C, `native/sais.c`) and
    its packed checkpoint rows stay on the device as int32 words, 12 a
    row, or 16 with the counts split into low and high words when the
    index has 2^31 rows or more (row state is then int64);
  * pass 1 finds every read's restart positions with persistent lanes
    (each step moves every read one query position; a segment that
    dies records its item and the lane starts the next one);
  * every (read, restart) item then runs one backward SMEM search,
    at prev-list widths 8, 16, 64 and the read's full width, an item
    moving up a width when its list or its emissions overflow;
  * pass 2 reseeds the long, rare SMEMs through the same item search;
  * pass 3 (LAST seeding) runs its rounds with persistent lanes too.
What differs from JAX: GET_OCC counts bits with a SWAR popcount on
int64 words below 2^32 (torch has no popcount) and masks a word to its
top t bits by shifting it right by 32 - t; a backward step extends only
the read's char (one gather of three or four words a slot) where JAX
took all four; the first hit is an argmax over an int tensor, the
s-dedup a `cummax` over masked slot indices and the compaction one
`cumsum` and one `scatter_`, where JAX built one-hot products and
shift scans for the TPU; the item loops drop their finished lanes once
half of them are done, and read the card's live count once per
CHECK_EVERY steps (a finished lane is a no-op, so the extra steps change
nothing); the width narrowing and the packed u32 items and output blob
are not ported (ROADMAP queue 1, item 6).  The mesh runs one thread a
shard (see `FMISearch`), where the JAX package ran one SPMD program
whose loop conditions reduce over the mesh (`_gany`).  Two choices are
the card's: table words are read by `take` of the words needed, not by
`index_select` of whole rows, whose kernel on the card is several times
slower for rows this narrow, and every scan over a short last dimension
(the 4 chars, a prev list) runs along the first dimension of a
transposed copy (`_scan0`).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from genarchbench_tpu_torch import native
from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.core.roi import Laps, ROITimer
from genarchbench_tpu_torch.sharding.mesh import (Exchange, Mesh, all_gather,
                                                  data_mesh, device_scope,
                                                  psum_scatter, run_threads,
                                                  shard_ranges)

CP_SHIFT = 6
CP_MASK = 63
SPLIT_WIDTH = 10
MAX_MEM_INTV = 20
SPLIT_FACTOR = 1.5
CHECK_EVERY = 4          # loop steps per read of the card's live count
WIDE_ROWS = 0x7FFFFFFD   # an index past this many rows takes int64 rows

# memory a lane needs, for sizing chunks: a read lane of the restart
# scan or the LAST seeding, and a prev-list slot of an item lane (an
# item at width P takes P + 2 slots); a chunk holds half the card's free
# memory, or CPU_BUDGET on the CPU
READ_LANE_BYTES = 4096
ITEM_SLOT_BYTES = 512
CPU_BUDGET = 1 << 30

i32 = torch.int32
i64 = torch.int64
M32 = 0xFFFFFFFF

_ENC = np.full(256, 4, np.uint8)
for _i, _c in enumerate("ACGT"):
    _ENC[ord(_c)] = _i


# ---------------------------------------------------------------------------
# index build (host)
# ---------------------------------------------------------------------------

def suffix_array_plain(codes: np.ndarray) -> np.ndarray:
    """Suffix array of `codes` by prefix doubling in numpy: the plain
    version that the C SA-IS (`native.sais`) is held to."""
    n = len(codes)
    rank = codes.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    k = 1
    while k < n:
        rank2 = np.full(n, -1, np.int64)
        rank2[:-k] = rank[k:]
        order = np.lexsort((rank2, rank))
        newr = np.zeros(n, np.int64)
        r1 = rank[order]
        r2 = rank2[order]
        change = np.ones(n, bool)
        change[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        newr[order] = np.cumsum(change) - 1
        rank = newr
        sa = order
        if rank[order[-1]] == n - 1:
            break
        k *= 2
    return sa


@dataclasses.dataclass
class FMIndex:
    count: np.ndarray          # (5,) cumulative char counts (count[0]=0)
    cp_count: np.ndarray       # (ncp, 4) int32 (int64 past WIDE_ROWS)
    oh_hi: np.ndarray          # (ncp, 4) uint32 one-hot bits 0..31 (MSB first)
    oh_lo: np.ndarray          # (ncp, 4) uint32 bits 32..63
    sentinel: int
    seq_len: int               # 2L + 1 (bwt length incl sentinel)

    def save(self, path: str) -> None:
        np.savez(path, count=self.count, cp_count=self.cp_count,
                 oh_hi=self.oh_hi, oh_lo=self.oh_lo,
                 sentinel=self.sentinel, seq_len=self.seq_len)

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        z = np.load(path)
        return cls(z["count"], z["cp_count"], z["oh_hi"], z["oh_lo"],
                   int(z["sentinel"]), int(z["seq_len"]))

    @classmethod
    def load_bwt2bit64(cls, path: str) -> "FMIndex":
        """Load a prebuilt bwa-mem2 `<prefix>.bwt.2bit.64` index (written
        by build_fm_index, x86_64/src/FMI_search.cpp:162-298; read by
        load_index :384).

        Layout: int64 seq_len (2L+1, sentinel row included); int64
        count[5] (cumulative, un-shifted: load_index adds +1);
        CP_OCC[(seq_len>>6)+1] = {int64 cp_count[4]; uint64 one_hot[4]};
        then the sampled suffix array (int8 ms-bytes + uint32 ls-words,
        1/8 sampling under SA_COMPRESSION, else full length) and a final
        int64 sentinel_index.  The SA is skipped: SMEM output is query
        intervals, never reference positions (fmi.cpp:429-461)."""
        fsize = os.path.getsize(path)
        with open(path, "rb") as f:
            seq_len = int(np.fromfile(f, "<i8", 1)[0])
            if not 0 < seq_len < (1 << 39):
                raise ValueError(f"implausible index seq_len {seq_len} "
                                 "(format carries up to 2^39-1 rows, "
                                 "bwa-mem2 macro.h:64-68)")
            cdt = np.int32 if seq_len <= WIDE_ROWS else np.int64
            count = (np.fromfile(f, "<i8", 5) + 1).astype(cdt)
            ncp = (seq_len >> CP_SHIFT) + 1
            rec = np.dtype([("cnt", "<i8", (4,)), ("oh", "<u8", (4,))])
            cp = np.fromfile(f, rec, ncp)
            header = 8 + 40 + ncp * 64
            n_comp = (seq_len >> 3) + 1
            if fsize == header + n_comp * 5 + 8:      # SA_COMPRESSION
                f.seek(n_comp * 5, 1)
                sentinel = int(np.fromfile(f, "<i8", 1)[0])
            elif fsize == header + seq_len * 5:
                # full SA (no SA_COMPRESSION): the reference writes no
                # trailing sentinel int64, so it is derived: the sentinel
                # row is the one whose suffix starts at position 0
                ms = np.fromfile(f, "<i1", seq_len)
                ls = np.fromfile(f, "<u4", seq_len)
                zero = np.flatnonzero((ms == 0) & (ls == 0))
                if len(zero) != 1:
                    raise ValueError(
                        f"full-SA index has {len(zero)} zero entries; "
                        "cannot derive the sentinel row")
                sentinel = int(zero[0])
            else:
                raise ValueError(f"unrecognized index size {fsize}")
        oh = cp["oh"]
        return cls(count, cp["cnt"].astype(cdt),
                   (oh >> np.uint64(32)).astype(np.uint32),
                   (oh & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                   sentinel, seq_len)


def build_index(ref_codes: np.ndarray) -> FMIndex:
    """ref_codes: forward reference 2-bit codes (0..3).  Builds the
    bi-directional index over forward + reverse complement
    (FMI_search::pac2nt + build_index + build_fm_index)."""
    return build_index_artifacts(ref_codes)[0]


def build_index_artifacts(
        ref_codes: np.ndarray) -> Tuple[FMIndex, np.ndarray]:
    """build_index plus the sentinel-first suffix array (needed only to
    serialize the bwa-mem2 on-disk format, save_bwt2bit64)."""
    fwd = ref_codes.astype(np.uint8)
    rc = (3 - fwd)[::-1]
    seq = np.concatenate([fwd, rc])
    n = len(seq)

    counts = np.bincount(seq, minlength=4)
    count = np.zeros(5, np.int64)
    count[1:] = np.cumsum(counts)
    # load_index's sentinel correction: count[i] += 1 for every entry
    # (x86_64/src/FMI_search.cpp load_index), making count[a] the true
    # sentinel-first SA row where char a's suffix block starts
    count += 1

    sa = native.sais(seq)
    sa_full = np.concatenate([[n], sa])            # sentinel-first

    bwt = np.full(n + 1, 4, np.uint8)
    nz = sa_full > 0
    bwt[nz] = seq[sa_full[nz] - 1]
    sentinel = int(np.nonzero(sa_full == 0)[0][0])

    blen = n + 1
    ncp = (blen >> CP_SHIFT) + 1
    pad = ncp * 64
    bwt_p = np.full(pad, 5, np.uint8)
    bwt_p[:blen] = bwt
    cdt = np.int32 if blen <= WIDE_ROWS else np.int64
    cp_count = np.zeros((ncp, 4), np.int64)
    oh_hi = np.zeros((ncp, 4), np.uint32)
    oh_lo = np.zeros((ncp, 4), np.uint32)
    bits = (np.uint64(1) << np.uint64(63 - np.arange(64)))
    run = np.zeros(4, np.int64)
    # chunked over checkpoint blocks: the dense (ncp, 64, 4) one-hot
    # intermediates would need ~32 bytes/base, ~70 GB at human scale
    CH = 1 << 22
    for lo in range(0, ncp, CH):
        hi = min(lo + CH, ncp)
        onehot = (bwt_p[lo * 64:hi * 64].reshape(hi - lo, 64)[:, :, None]
                  == np.arange(4, dtype=np.uint8))   # (ch, 64, 4)
        per_block = onehot.sum(axis=1, dtype=np.int64)
        cp_count[lo:hi] = run + (np.cumsum(per_block, axis=0)
                                 - per_block)
        run = run + per_block.sum(axis=0)
        words = np.bitwise_or.reduce(
            np.where(onehot, bits[None, :, None], np.uint64(0)), axis=1)
        oh_hi[lo:hi] = (words >> np.uint64(32)).astype(np.uint32)
        oh_lo[lo:hi] = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    return (FMIndex(count.astype(cdt), cp_count.astype(cdt),
                    oh_hi, oh_lo, sentinel, blen), sa_full)


def save_bwt2bit64(fmi: FMIndex, sa_full: np.ndarray, path: str) -> None:
    """Serialize in the bwa-mem2 on-disk format (byte-identical to
    build_fm_index's output, x86_64/src/FMI_search.cpp:162-298), so that
    indexes built here load in the reference binaries and back.
    SA_COMPRESSION layout (1/8 sampling, macro.h:64-68)."""
    with open(path, "wb") as f:
        np.int64(fmi.seq_len).tofile(f)
        (fmi.count.astype(np.int64) - 1).tofile(f)      # un-shift the +1
        rec = np.dtype([("cnt", "<i8", (4,)), ("oh", "<u8", (4,))])
        cp = np.zeros(len(fmi.cp_count), rec)
        cp["cnt"] = fmi.cp_count.astype(np.int64)
        cp["oh"] = ((fmi.oh_hi.astype(np.uint64) << np.uint64(32))
                    | fmi.oh_lo.astype(np.uint64))
        cp.tofile(f)
        sampled = sa_full[::8].astype(np.int64)
        if len(sampled) < (fmi.seq_len >> 3) + 1:       # trailing slot
            sampled = np.concatenate([sampled, [0]])
        ((sampled >> 32) & 0xFF).astype(np.int8).tofile(f)
        (sampled & 0xFFFFFFFF).astype(np.uint32).tofile(f)
        np.int64(fmi.sentinel).tofile(f)


def read_fasta_codes(path: str) -> np.ndarray:
    """The 2-bit codes of a FASTA file's sequence lines, concatenated."""
    seqs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith(">"):
                seqs.append(_ENC[np.frombuffer(line.encode(), np.uint8)])
    return np.concatenate(seqs)


def build_index_from_fasta(path: str) -> FMIndex:
    codes = read_fasta_codes(path)
    if (codes > 3).any():
        raise ValueError("reference contains non-ACGT bases "
                         "(bwa's random N-conversion not replicated)")
    return build_index(codes)


def occ_table(index: FMIndex, wide: bool) -> np.ndarray:
    """The packed checkpoint rows, uint32: [cnt0..3 | hi0..3 | lo0..3]
    (width 12), or [cntlo0..3 | cnthi0..3 | hi0..3 | lo0..3] (width 16)
    when the row state is int64."""
    if wide:
        c64 = index.cp_count.astype(np.int64)
        cols = [(c64 & 0xFFFFFFFF).astype(np.uint32),
                (c64 >> 32).astype(np.uint32)]
    else:
        cols = [index.cp_count.astype(np.uint32)]
    return np.ascontiguousarray(
        np.concatenate(cols + [index.oh_hi, index.oh_lo], axis=1))


# ---------------------------------------------------------------------------
# GET_OCC and backwardExt
# ---------------------------------------------------------------------------

def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 element in [0, 2^32), by SWAR (torch has no
    popcount op); no step leaves [0, 2^57), so int64 never overflows."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _shifts(y: torch.Tensor) -> torch.Tensor:
    """(..., 2): the right shifts of a block's (hi, lo) words that keep
    its first y bits (y in 0..63)."""
    return torch.stack([32 - y.clamp(max=32), 32 - (y - 32).clamp(min=0)],
                       -1)


def _scan0(x: torch.Tensor, scan, **kw) -> torch.Tensor:
    """scan(t, 0, **kw) (a cumulative sum or max) along x's last
    dimension, run along the first dimension of a transposed copy: the
    card's scan kernel for a short innermost dimension is an order of
    magnitude slower."""
    return scan(x.movedim(-1, 0).contiguous(), 0, **kw).movedim(0, -1)


def _occ4(fmi: "FMISearch", pp: torch.Tensor) -> torch.Tensor:
    """occ(pp, c) for the four chars (GET_OCC, FMI_search.h:71-79) at
    row positions pp (any shape, row dtype): (*pp.shape, 4), row dtype.
    The count of char c before pp is the checkpoint's count plus the set
    bits of the one-hot words among the first y = pp & 63 of the block:
    the top y bits of the 64-bit word, so the top min(y, 32) of `hi` and
    the top max(y - 32, 0) of `lo`, each word shifted right by 32 less
    that many (a shift by 32 leaves 0)."""
    shape = pp.shape
    flat = pp.reshape(-1)
    W = fmi.occ.shape[1]
    cid = (flat >> CP_SHIFT).clamp_(0, fmi.ncp - 1).to(i64)
    rows = fmi.take(cid[:, None] * W + fmi.wcols)         # (N, 12|16) int32
    words = (rows[:, -8:].to(i64) & M32).view(-1, 2, 4)   # hi, lo
    sh = _shifts(flat & CP_MASK)                          # (N, 2)
    pc = _popcount32(words >> sh[:, :, None]).sum(1)      # (N, 4) int64
    if fmi.wide:
        cnt = (rows[:, 0:4].to(i64) & M32) | (rows[:, 4:8].to(i64) << 32)
    else:
        cnt = rows[:, 0:4]
    return (cnt + pc.to(cnt.dtype)).view(*shape, 4)


def _backward_ext(fmi: "FMISearch", k, l, s, a):
    """backwardExt (FMI_search.cpp:1268-1298) of the intervals (k, l, s)
    by chars a (code 4 counts as 3; its lanes are masked by the caller):
    the new (k, l, s).  Both GET_OCC lookups, of k and k + s, ride one
    gather of checkpoint rows; one gather picks a's column of the
    stacked (k, l, s) candidates."""
    ks = k + s
    occ = _occ4(fmi, torch.stack([k, ks], -1))           # (..., 2, 4)
    osp, oep = occ.unbind(-2)
    ss4 = oep - osp
    dt = k.dtype
    sent = ((k <= fmi.sentinel) & (ks > fmi.sentinel)).to(dt)
    # l[c] = l + sent + the sizes of the chars above c
    cs = _scan0(ss4, torch.cumsum, dtype=dt)
    ll = (l + sent)[..., None] + cs[..., 3:] - cs
    cand = torch.stack([fmi.count5[:4] + osp, ll, ss4], -2)   # (..., 3, 4)
    pick = a.clamp(0, 3)[..., None, None].expand(*a.shape, 3, 1)
    return cand.gather(-1, pick).squeeze(-1).unbind(-1)


def _backward_ext_ks(fmi: "FMISearch", k, s, a):
    """The (k, s) of backwardExt for prev lists (B, P) and one char per
    lane a (B,), for the backward SMEM walk, which needs no l: only a's
    count and one-hot words are read, one `take` of three (or four, when
    wide) int32 words at each of k and k + s."""
    B, P = k.shape
    ac = a.clamp(0, 3)
    pp = torch.stack([k, k + s], -1)                      # (B, P, 2)
    cid = (pp >> CP_SHIFT).clamp_(0, fmi.ncp - 1).to(i64) * fmi.occ.shape[1]
    cols = (fmi.cols + ac[:, None])[:, None, None, :]     # (B, 1, 1, C)
    v = fmi.take(cid[..., None] + cols)                   # (B, P, 2, C)
    if fmi.wide:
        cnt = (v[..., 0].to(i64) & M32) | (v[..., 1].to(i64) << 32)
    else:
        cnt = v[..., 0]
    words = v[..., -2:].to(i64) & M32                     # hi, lo
    occ = cnt + _popcount32(words >> _shifts(pp & CP_MASK)).sum(-1).to(
        cnt.dtype)
    osp, oep = occ.unbind(-1)
    return fmi.count5[ac][:, None] + osp, oep - osp


def _qchar(qdb, off, j, valid):
    """The query code at j of the reads at off (qdb flat, int64 codes),
    4 (ambiguous) where not valid; the index is clamped into qdb."""
    idx = (off + j).clamp_(0, qdb.shape[0] - 1)
    return torch.where(valid, qdb[idx], 4)


def _init_interval(fmi: "FMISearch", a):
    """The one-char interval (k, l, s) of codes a (4 counts as 3)."""
    ac = a.clamp(max=3)
    c = fmi.count5[torch.stack([ac, 3 - ac, ac + 1])]
    return c[0], c[1], c[2] - c[0]


def _push(buf, n, vals, mask):
    """Write the lanes' vals (a list of (B,) tensors) at slot n of buf
    (B, len(vals), W + 1) where mask holds; slot W takes every other
    lane and every lane whose n is past the W real slots."""
    W = buf.shape[2] - 1
    slot = torch.where(mask & (n < W), n, W).to(i64)
    src = torch.stack([v.to(buf.dtype) for v in vals], 1)
    buf.scatter_(2, slot[:, None, None].expand(-1, len(vals), 1),
                 src[:, :, None])


def _drive(st: Dict[str, torch.Tensor], step, retire) -> int:
    """Run `step(st, j)` for j = 1, 2, ... until no lane of st is live
    (st["on"]), reading the live count once per CHECK_EVERY steps.
    Lanes that are not live never change again: once they are half of
    st they go to `retire` (a dict of their tensors) and leave st, and
    at the end every lane left does.  Returns the steps run."""
    j = 1
    while True:
        on = st["on"]
        n_live = int(on.sum())
        if n_live == 0:
            break
        if 2 * n_live <= on.shape[0]:
            dead = (~on).nonzero().squeeze(1)
            retire({k: v[dead] for k, v in st.items()})
            keep = on.nonzero().squeeze(1)
            for k in list(st):
                st[k] = st[k][keep]
        for _ in range(CHECK_EVERY):
            step(st, j)
            j += 1
    retire(st)
    return j - 1


def _count(stats, key: str, total) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(total)


# ---------------------------------------------------------------------------
# the three passes on the device
# ---------------------------------------------------------------------------

def restart_scan(fmi: "FMISearch", qdb, qoff, qlen, x_init, min_intv: int,
                 Rcap: int, stats: Optional[dict] = None):
    """Pass-1 restart discovery: walks getSMEMsAllPosOneThread's restart
    chain (x = next_x until x >= qlen, FMI_search.cpp:915-968) for every
    read from x_init, with persistent lanes: each step moves every lane
    by one query position, starting a segment at x0 or extending the
    current one, and a segment that ends records its item (x0, forward
    end n) in the lane's next slot; a lane stops after Rcap items.
    Returns (items (B, 2, Rcap) int32 [x0, n], -1 in unused slots; the
    x0 (B,) each lane stopped at, >= qlen when its read is done)."""
    B = qoff.shape[0]
    dev = qdb.device
    x0 = x_init.clone()
    jj = torch.zeros(B, dtype=i32, device=dev)
    n = jj.clone()
    cnt = jj.clone()
    k = torch.zeros(B, dtype=fmi.rowdt, device=dev)
    l, s = k.clone(), k.clone()
    seg = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, 2, Rcap + 1), -1, dtype=i32, device=dev)
    ext_live = torch.zeros((), dtype=i64, device=dev)
    steps = 0
    while bool(((x0 < qlen) & (cnt < Rcap)).any()):
        for _ in range(CHECK_EVERY):
            live = (x0 < qlen) & (cnt < Rcap)
            pos = torch.where(seg, jj, x0)
            a = _qchar(qdb, qoff, pos, live & (pos < qlen))
            good = a < 4
            init = live & ~seg
            start = init & good
            skip = init & ~good                   # ambiguous base: x0 + 1
            k0, l0, s0 = _init_interval(fmi, a)
            ext = live & seg
            valid = ext & (jj < qlen)
            # forward extension = backwardExt on the reverse-complement
            # side, (k, l) swapped
            nl, nk, ns = _backward_ext(fmi, l, k, s, 3 - a)
            goodx = valid & good
            die = goodx & (ns < min_intv)
            fin = die | (valid & ~good) | (ext & ~valid)
            grow = goodx & ~die
            _push(out, cnt, [x0, n], fin)
            cnt = cnt + fin
            # the next segment starts at the dying position, past a
            # char break, or at the read's end; jj > x0 in a segment
            nx0 = torch.where(fin, torch.where(valid, jj + ~good, qlen),
                              x0 + skip)
            n = torch.where(start, x0, torch.where(grow, jj, n))
            k = torch.where(start, k0, torch.where(grow, nk, k))
            l = torch.where(start, l0, torch.where(grow, nl, l))
            s = torch.where(start, s0, torch.where(grow, ns, s))
            jj = torch.where(start, x0 + 1, jj + grow)
            seg = (seg | start) & ~fin
            x0 = nx0
            if stats is not None:
                ext_live += goodx.sum()
        steps += CHECK_EVERY
    _count(stats, "restart_steps", steps)
    _count(stats, "ext_restart", ext_live)
    return out[:, :, :Rcap], x0


def onepos_search(fmi: "FMISearch", qdb, qoff, qlen, x0, min_intv,
                  Pmax: int, min_seed: int, out_w: int,
                  stats: Optional[dict] = None, tag: str = "pass1"):
    """getSMEMsOnePosOneThread (FMI_search.cpp:498-914) once per lane,
    lanes being (read, x0) items (x0 < 0: an idle lane), with a prev
    list of Pmax entries and out_w emission slots a lane.  Returns (em,
    en, es (B, out_w) int32: the SMEMs' m, n and s clamped to 0..255,
    in emission order; ec (B,) int32: the emissions counted; ovf (B,)
    bool: the lanes whose prev list or emissions overflowed, to be
    retried wider)."""
    B = x0.shape[0]
    dev = qdb.device
    rd = fmi.rowdt
    P = Pmax
    active0 = x0 >= 0
    xs = x0.clamp(min=0)
    a0 = _qchar(qdb, qoff, xs, active0 & (xs < qlen))
    lane_on = active0 & (a0 < 4)
    k, l, s = _init_interval(fmi, a0)
    slots = torch.arange(P, dtype=i64, device=dev)
    ext_live = torch.zeros((), dtype=i64, device=dev)

    # ---- forward extension, pushing (m, n, k, s) whenever s changes ----
    st = dict(ids=torch.arange(B, device=dev), xs=xs, qoff=qoff, qlen=qlen,
              mi=min_intv, n=xs.clone(), k=k, l=l, s=s,
              PV=torch.zeros((B, 4, P + 1), dtype=rd, device=dev),
              npv=torch.zeros(B, dtype=i32, device=dev), on=lane_on)
    kept = ("n", "k", "s", "PV", "npv")
    fwd = {nm: st[nm].clone() for nm in kept}

    def fwd_step(st, j):
        nonlocal ext_live
        jj = st["xs"] + j
        valid = st["on"] & (jj < st["qlen"])
        a = _qchar(qdb, st["qoff"], jj, valid)
        good = valid & (a < 4)
        nl, nk, ns = _backward_ext(fmi, st["l"], st["k"], st["s"], 3 - a)
        s_neq = good & (ns != st["s"])
        _push(st["PV"], st["npv"], [st["xs"], st["n"], st["k"], st["s"]],
              s_neq)
        st["npv"] = st["npv"] + s_neq
        grow = good & (ns >= st["mi"])
        st["n"] = torch.where(grow, jj, st["n"])
        st["k"] = torch.where(grow, nk, st["k"])
        st["l"] = torch.where(grow, nl, st["l"])
        st["s"] = torch.where(grow, ns, st["s"])
        st["on"] = grow
        if stats is not None:
            ext_live = ext_live + good.sum()

    def fwd_retire(sub):
        for nm in kept:
            fwd[nm].index_copy_(0, sub["ids"], sub[nm])

    fsteps = _drive(st, fwd_step, fwd_retire)
    PV, npv = fwd["PV"], fwd["npv"]
    fin = lane_on & (fwd["s"] >= min_intv)
    _push(PV, npv, [xs, fwd["n"], fwd["k"], fwd["s"]], fin)
    npv = npv + fin
    ovf = lane_on & (npv > P)
    # reverse the first npv entries (overflowed lanes hold garbage here
    # and are retried wider)
    rev = torch.where(slots < npv[:, None], npv[:, None] - 1 - slots, slots)
    PV = PV[:, :, :P].gather(
        2, rev.clamp_(0, P - 1)[:, None, :].expand(-1, 4, -1))

    # ---- backward walk over the prev list ----
    em = torch.zeros((B, 3, out_w), dtype=i32, device=dev)
    ec = torch.zeros(B, dtype=i32, device=dev)
    st = dict(ids=torch.arange(B, device=dev), xs=xs, qoff=qoff,
              mi=min_intv, PV=PV, npv=npv, on=lane_on,
              EM=torch.zeros((B, 3, out_w + 1), dtype=i32, device=dev),
              ec=ec.clone())

    def emit(st, m, n, s, mask):
        _push(st["EM"], st["ec"], [m, n, s.clamp(0, 255)], mask)
        st["ec"] = st["ec"] + mask

    def bwd_step(st, j):
        nonlocal ext_live
        jj = st["xs"] - j
        valid = st["on"] & (jj >= 0)
        a = _qchar(qdb, st["qoff"], jj, valid)
        good = valid & (a < 4)
        PV = st["PV"]
        pm, pn, pk, ps = PV.unbind(1)
        inp = slots < st["npv"][:, None]
        nk, ns = _backward_ext_ks(fmi, pk, ps, a)
        low = ns < st["mi"][:, None]
        condA = inp & low & (pn - pm + 1 >= min_seed)
        condB = inp & ~low
        # first hit p0 (0 when none: then condA[0] and condB are false)
        p0 = (condA | condB).to(i32).argmax(1, keepdim=True)
        isA = condA.gather(1, p0).squeeze(1)
        sel = PV.gather(2, p0[:, None, :].expand(-1, 4, 1)).squeeze(2)
        emit(st, sel[:, 0], sel[:, 1], sel[:, 3], good & isA)
        # pushes: the eligible p >= p0 (> p0 after an emission) whose
        # new s differs from the last eligible one's
        elig = condB & (slots >= p0 + isA[:, None])
        last = _scan0(torch.where(elig, slots, -1),
                      lambda t, d: torch.cummax(t, d).values)
        prev = F.pad(last[:, :-1], (1, 0), value=-1)
        dup = (prev >= 0) & (ns == ns.gather(1, prev.clamp(min=0)))
        push = elig & ~dup
        # stable compaction of the pushed entries to the front: newSmem
        # = (m = jj, the entry's n, the extended k and s)
        csum = _scan0(push, torch.cumsum, dtype=i32)
        tgt = torch.where(push, csum - 1, P).to(i64)
        new = torch.zeros((PV.shape[0], 4, P + 1), dtype=rd, device=dev)
        new.scatter_(2, tgt[:, None, :].expand(-1, 4, -1), torch.stack(
            [jj.to(rd)[:, None].expand(-1, P), pn, nk, ns], 1))
        ncur = csum[:, -1]
        st["PV"] = torch.where(good[:, None, None], new[:, :, :P], PV)
        st["npv"] = torch.where(good, ncur, st["npv"])
        st["on"] = good & (ncur > 0)
        if stats is not None:
            ext_live = ext_live + (inp & good[:, None]).sum()

    def bwd_retire(sub):
        # the final emission: prev[0], if it is long enough
        top = sub["PV"][:, :, 0]
        emit(sub, top[:, 0], top[:, 1], top[:, 3],
             (sub["npv"] > 0) & (top[:, 1] - top[:, 0] + 1 >= min_seed))
        em.index_copy_(0, sub["ids"], sub["EM"][:, :, :out_w])
        ec.index_copy_(0, sub["ids"], sub["ec"])

    bsteps = _drive(st, bwd_step, bwd_retire)
    _count(stats, f"{tag}_fwd_steps", fsteps)
    _count(stats, f"{tag}_bwd_steps", bsteps)
    _count(stats, f"ext_{tag}", ext_live)
    em, en, es = em.unbind(1)
    return em, en, es, ec, ovf | (ec > out_w)


def bwt_seed(fmi: "FMISearch", qdb, qoff, qlen, x_init, max_intv: int,
             min_seed: int, Rcap: int, stats: Optional[dict] = None):
    """bwtSeedStrategyAllPosOneThread (FMI_search.cpp:975-1075) from
    x_init, with persistent lanes: a round extends forward from x until
    the interval drops under max_intv at a length of at least min_seed
    (a hit, recorded when the interval is not empty), or a bad char or
    the read's end stops it; the next round starts past it.  Each step
    moves every lane by one position, and a lane stops after Rcap
    rounds.  Returns (hits (B, 2, Rcap) int32 [x, hit end], -1 in the
    slots of rounds without a hit; the x (B,) each lane stopped at)."""
    B = qoff.shape[0]
    dev = qdb.device
    x = x_init.clone()
    jj = torch.zeros(B, dtype=i32, device=dev)
    cnt = jj.clone()
    k = torch.zeros(B, dtype=fmi.rowdt, device=dev)
    l, s = k.clone(), k.clone()
    seg = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, 2, Rcap + 1), -1, dtype=i32, device=dev)
    ext_live = torch.zeros((), dtype=i64, device=dev)
    steps = 0
    while bool(((x < qlen) & (cnt < Rcap)).any()):
        for _ in range(CHECK_EVERY):
            live = (x < qlen) & (cnt < Rcap)
            pos = torch.where(seg, jj, x)
            a = _qchar(qdb, qoff, pos, live & (pos < qlen))
            good = a < 4
            init = live & ~seg
            start = init & good
            skip = init & ~good                   # a round with no hit
            k0, l0, s0 = _init_interval(fmi, a)
            valid = seg & (jj < qlen)
            nl, nk, ns = _backward_ext(fmi, l, k, s, 3 - a)
            goodx = valid & good
            hit = goodx & (ns < max_intv) & (jj - x + 1 >= min_seed)
            cont = goodx & ~hit
            end = seg & ~cont
            _push(out, cnt, [x, jj], hit & (ns > 0))
            cnt = cnt + (skip | end)
            # the next round starts past the last position read, or at
            # the read's end
            nx = torch.where(end, jj + valid, x + skip)
            k = torch.where(start, k0, torch.where(cont, nk, k))
            l = torch.where(start, l0, torch.where(cont, nl, l))
            s = torch.where(start, s0, torch.where(cont, ns, s))
            jj = torch.where(start, x + 1, jj + cont)
            seg = start | cont
            x = nx
            if stats is not None:
                ext_live += goodx.sum()
        steps += CHECK_EVERY
    _count(stats, "pass3_steps", steps)
    _count(stats, "ext_pass3", ext_live)
    return out[:, :, :Rcap], x


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

def lanes_per_chunk(device: torch.device, lane_bytes: int) -> int:
    """Lanes of lane_bytes each that one chunk may hold: half the card's
    free memory, or CPU_BUDGET on the CPU."""
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] // 2
    else:
        budget = CPU_BUDGET
    return max(1, budget // lane_bytes)


class FMISearch:
    """The index's tables on the device: count (5,), the packed
    checkpoint rows (ncp, 12) int32, or (ncp, 16) when wide, and the
    sentinel row.  Indexes past WIDE_ROWS rows take the wide path (row
    state int64); GENARCH_FMI_FORCE_WIDE=1 takes it on any index.

    With a mesh (of this process's devices), `search_reads` splits the
    reads over its devices (the reference's OMP over read batches,
    fmi.cpp:250-263), one shard a device, run one after another.
    The tables are replicated on every device, or with `shard_tables`
    split by rows into contiguous ranges, one a device, so that an index
    larger than one card spreads over the mesh.  Every table read
    (GET_OCC) is then JAX's collective pair (fmi.py:291-347): the
    positions of every shard gathered (padded to the mesh-wide largest,
    for equal shapes), each device's masked read of the rows it holds,
    and a sum scattered back to the shards.  The shards then run a
    thread each, and the threads meet at each read (`Exchange`); a shard with no live lane left takes
    part with no positions, so no shard waits for another's loop to
    end, which JAX's lockstep loops (`_gany`) had to arrange."""

    def __init__(self, index: FMIndex, device=None,
                 mesh: Optional[Mesh] = None, shard_tables: bool = False):
        self.index = index
        self.wide = (index.seq_len > WIDE_ROWS
                     or os.environ.get("GENARCH_FMI_FORCE_WIDE") == "1")
        self.rowdt = i64 if self.wide else i32
        self.mesh = mesh
        self.shard_tables = False
        self.shard = 0                   # this view's shard of the mesh
        self.exchange: Optional[Exchange] = None
        occ = occ_table(index, self.wide).view(np.int32)
        self.ncp = occ.shape[0]
        self.shards: List[FMISearch] = []
        if mesh is None:
            self._place(resolve_device(device), occ, 0)
            return
        if mesh.world > 1:
            raise ValueError("fmi: a mesh of one process's devices only")
        self.device = mesh.devices[0]
        L = len(mesh.devices)
        c = -(-self.ncp // L) if shard_tables else 0
        for i, dev in enumerate(mesh.devices):
            view = copy.copy(self)
            view.mesh = None
            view.shard = i
            view._place(dev, occ[i * c:(i + 1) * c] if c else occ, i * c)
            self.shards.append(view)
        self.shard_tables = bool(c)

    def _place(self, dev: torch.device, rows: np.ndarray, row0: int) -> None:
        """The tables on dev, with the checkpoint rows `rows` (those from
        row0 on)."""
        self.device = dev
        cdt = np.int64 if self.wide else np.int32
        self.count5 = torch.from_numpy(self.index.count.astype(cdt)).to(dev)
        self.occ = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
        self.row0 = row0
        self.sentinel = torch.tensor(self.index.sentinel, dtype=self.rowdt,
                                     device=dev)
        # a row's words, and a char's: count (low and high when wide),
        # hi, lo
        self.wcols = torch.arange(rows.shape[1], dtype=i64, device=dev)
        self.cols = self.wcols[::4]

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        """The table words at flat indices idx (row * width + word): a
        local `take`, or the sharded tables' collective read."""
        if self.exchange is None:
            return self.occ.take(idx)
        return self.exchange.exchange(self.shard, idx)

    def _sharded_take(self, parts: list) -> list:
        """The collective read of the row-sharded tables for every
        shard's flat indices parts[i] (None for a shard that left)."""
        width = self.shards[0].occ.shape[1]
        m = max(p.numel() for p in parts if p is not None)
        pos = [F.pad(p.reshape(-1), (0, m - p.numel()), value=-1)
               if p is not None else
               torch.full((m,), -1, dtype=i64, device=v.device)
               for p, v in zip(parts, self.shards)]
        mine = []
        for want, v in zip(all_gather(self.mesh, pos), self.shards):
            held = torch.zeros_like(want, dtype=i32)
            if v.occ.numel():
                loc = want - v.row0 * width
                ok = (loc >= 0) & (loc < v.occ.numel())
                held = torch.where(
                    ok, v.occ.take(loc.clamp(0, v.occ.numel() - 1)), held)
            mine.append(held)
        got = psum_scatter(self.mesh, mine)
        return [g[:p.numel()].view(p.shape) if p is not None else None
                for g, p in zip(got, parts)]

    def restart_items(self, qdb, qoff, qlen, min_intv: int, Rcap: int = 16,
                      stats: Optional[dict] = None):
        """Phase A of the all-SMEM pass: the reads' restart items (read,
        x0, forward end n) via restart_scan, resumed for the reads with
        more than Rcap of them.  Returns flat (ridx int64, x0, nend
        int32) in chain order: by read, then by round."""
        x = torch.zeros(qoff.shape[0], dtype=i32, device=qdb.device)
        chunks = []
        while True:
            out, x = restart_scan(self, qdb, qoff, qlen, x, min_intv, Rcap,
                                  stats)
            chunks.append(out)
            _count(stats, "restart_calls", 1)
            if not bool((x < qlen).any()):
                break
        out = torch.cat(chunks, 2)
        bb, rr = (out[:, 0] >= 0).nonzero(as_tuple=True)
        return bb, out[bb, 0, rr], out[bb, 1, rr]

    def onepos_items(self, qdb, item_qoff, item_qlen, item_x0, item_mi,
                     item_flen, min_seed: int, stats: Optional[dict] = None,
                     tag: str = "pass1"):
        """Phase B: one backward SMEM search per item, at the prev-list
        widths [8, 16, 64, full] (items with a forward length under 8
        start at 8, the rest at 16), an item that overflows moving to
        the next width, in chunks of as many items as lanes_per_chunk
        allows.  Returns flat (item index int64, m, n,
        s int32); s is clamped to 0..255, which never matters: s is only
        read by the reseed filter (s <= SPLIT_WIDTH, fmi.cpp:301-317)."""
        dev = qdb.device
        M = item_x0.shape[0]
        Lmax_all = int(item_qlen.max()) if M else 0
        tiers = [8, 16, 64]
        wfull = 1 << max(Lmax_all + 1, 2).bit_length()
        if wfull > 64:
            tiers.append(wfull)
        todo = torch.ones(M, dtype=torch.bool, device=dev)
        # numPrev <= #distinct interval sizes <= fwd length + 1, so
        # short-extension items start at the narrow prev-list tier
        tier_of = torch.where(item_flen < 8, 0, 1)
        emits = []
        retries = {}
        for ti, Pmax in enumerate(tiers):
            sel = (todo & (tier_of <= ti)).nonzero().squeeze(1)
            if not len(sel):
                if not bool(todo.any()):
                    break
                continue
            out_w = min(Pmax + 4, 12) if Pmax <= 16 else Pmax + 4
            step = lanes_per_chunk(dev, ITEM_SLOT_BYTES * (Pmax + 2))
            fails = []
            for lo in range(0, len(sel), step):
                sub = sel[lo:lo + step]
                em, en, es, ec, ovf = onepos_search(
                    self, qdb, item_qoff[sub], item_qlen[sub], item_x0[sub],
                    item_mi[sub], Pmax, min_seed, out_w, stats, tag)
                _count(stats, f"{tag}_chunks", 1)
                ok = ~ovf
                todo[sub] = ovf
                bb, tt = ((torch.arange(out_w, device=dev) < ec[:, None])
                          & ok[:, None]).nonzero(as_tuple=True)
                emits.append((sub[bb], em[bb, tt], en[bb, tt], es[bb, tt]))
                fails.append(sub[ovf])
            fails = torch.cat(fails)
            if len(fails):
                if ti + 1 >= len(tiers):
                    # the emission bound (<= numPrev+1 <= read length)
                    # guarantees the full-width tier never overflows; a
                    # violation must fail loudly, not truncate
                    raise RuntimeError(
                        f"fmi: {len(fails)} items overflowed the "
                        f"full-width prev/emit buffers (P={Pmax})")
                tier_of[fails] = ti + 1
                retries[tiers[ti + 1]] = len(fails)
        if stats is not None:
            r = stats.setdefault(f"{tag}_retries", {})
            for w, c in retries.items():
                r[w] = r.get(w, 0) + c
        if not emits:
            z = torch.zeros(0, dtype=i32, device=dev)
            return z.to(i64), z, z, z
        return tuple(torch.cat(e) for e in zip(*emits))

    def bwt_seed_batch(self, qdb, qoff, qlen, rid, max_intv: int,
                       min_seed: int, Rcap: int = 16,
                       stats: Optional[dict] = None):
        """Pass 3 over reads rid: bwt_seed resumed until every read is
        done.  Returns flat (rid, m, n) of the hits, by read, then by
        round."""
        x = torch.zeros(qoff.shape[0], dtype=i32, device=qdb.device)
        chunks = []
        while True:
            out, x = bwt_seed(self, qdb, qoff, qlen, x, max_intv, min_seed,
                              Rcap, stats)
            chunks.append(out)
            _count(stats, "seed_calls", 1)
            if not bool((x < qlen).any()):
                break
        out = torch.cat(chunks, 2)
        bb, rr = (out[:, 0] >= 0).nonzero(as_tuple=True)
        return rid[bb], out[bb, 0, rr], out[bb, 1, rr]


def _search_mesh(fmi: FMISearch, reads: List[np.ndarray], batch_size: int,
                 min_seed: int) -> List[Tuple]:
    """search_reads over fmi's mesh: the reads cut by `shard_ranges`,
    each shard searching its reads on its device, one after another, or
    with sharded tables a thread a shard, meeting at every table read;
    the shards' sorted results, their read ids made global, in shard
    order."""
    exch = (Exchange(len(fmi.shards), fmi._sharded_take)
            if fmi.shard_tables else None)
    ranges = shard_ranges(len(reads), fmi.mesh)
    fns = []
    for view, (lo, hi) in zip(fmi.shards, ranges):
        view = copy.copy(view)
        view.exchange = exch

        def one(view=view, lo=lo, hi=hi):
            if hi == lo:
                return None
            with device_scope(view.device):
                return search_reads(view, reads[lo:hi], batch_size,
                                    min_seed)[0]
        fns.append(one)
    results = (run_threads(fns, exch) if exch is not None
               else [fn() for fn in fns])
    parts = [(r + lo, m, n) for (lo, _), res in zip(ranges, results)
             if res is not None for r, m, n in [res]]
    return [tuple(np.concatenate(a) for a in zip(*parts))]


def search_reads(fmi: FMISearch, reads: List[np.ndarray], batch_size: int,
                 min_seed: int,
                 stats: Optional[dict] = None) -> List[Tuple]:
    """The reference's 3-pass batch loop (fmi.cpp:262-356).

    batch_size (512 in the reference) is an OMP work-granularity knob
    that does not change the result: reads are independent, and the
    output is the global (rid, m, -n) stable sort.  Restart items for
    all reads first, then every (read, x0) backward search as one item
    sweep, the reseed of pass 2 through the same sweep, then LAST
    seeding.  Returns one group holding the sorted (rid, m, n) arrays.

    `stats`, when a dict, is filled with the items of passes 1 and 2,
    the hits of pass 3 and the SMEMs, each pass's tier retries, chunks
    and loop steps, the live backwardExt extensions of each loop
    (ext_*), and the seconds of host preparation, copies, restart scan,
    passes 1, 2 and 3 and the sort (the card synchronized at each
    boundary); on a mesh (`FMISearch`) `stats` are not taken."""
    if fmi.mesh is not None:
        if stats is not None:
            raise ValueError("fmi: stats are taken on one device")
        return _search_mesh(fmi, reads, batch_size, min_seed)
    n = len(reads)
    lens = np.array([len(r) for r in reads], np.int64)
    L = int(lens.max())
    if 1 << max(L - 1, 1).bit_length() > 0xFFFF:
        # the JAX package pads reads to a power of two and keeps query
        # positions in 16 bits: every read over 32768 bases is refused
        raise ValueError("fmi: reads longer than 65535 bases are not "
                         "supported by the packed item pipeline")
    dev = fmi.device
    lap = Laps(stats, dev)
    split_len = int(min_seed * SPLIT_FACTOR + .499)
    qdb = np.full((n, L), 4, np.uint8)
    qdb[np.arange(L)[None, :] < lens[:, None]] = np.concatenate(reads)
    lap("prep_s")
    qdb_t = torch.from_numpy(qdb.reshape(-1)).to(dev).to(i64)
    qlen_t = torch.from_numpy(lens.astype(np.int32)).to(dev)
    qoff_t = torch.arange(n, dtype=i64, device=dev) * L
    lap("h2d_s")

    step = lanes_per_chunk(dev, READ_LANE_BYTES)
    with torch.profiler.record_function("fmi.restart"):
        parts = []
        for i in range(0, n, step):
            ridx, x0, nend = fmi.restart_items(
                qdb_t, qoff_t[i:i + step], qlen_t[i:i + step], 1,
                stats=stats)
            parts.append((ridx + i, x0, nend))
        ridx, x0, nend = (torch.cat(p) for p in zip(*parts))
    lap("restart_s")

    with torch.profiler.record_function("fmi.pass1"):
        ib, m1, n1, sp1 = fmi.onepos_items(
            qdb_t, qoff_t[ridx], qlen_t[ridx], x0, torch.ones_like(x0),
            nend - x0 + 1, min_seed, stats=stats, tag="pass1")
        r1 = ridx[ib]
    lap("pass1_s")

    # pass 2: filter + reseed (fmi.cpp:301-324), one item per kept SMEM,
    # fwd length unknown (bounded by the read)
    with torch.profiler.record_function("fmi.pass2"):
        keep = (((n1 + 1 - m1) >= split_len) & (sp1 <= SPLIT_WIDTH)
                ).nonzero().squeeze(1)
        rr = r1[keep]
        if len(rr):
            rx0 = (n1 + 1 + m1)[keep] >> 1
            ib2, m2, n2, _ = fmi.onepos_items(
                qdb_t, qoff_t[rr], qlen_t[rr], rx0, sp1[keep] + 1,
                qlen_t[rr] - rx0, min_seed, stats=stats, tag="pass2")
            r2 = rr[ib2]
        else:
            r2 = rr
            m2 = n2 = torch.zeros(0, dtype=i32, device=dev)
    lap("pass2_s")

    with torch.profiler.record_function("fmi.pass3"):
        parts = []
        for i in range(0, n, step):
            rid = torch.arange(i, min(i + step, n), dtype=i64, device=dev)
            parts.append(fmi.bwt_seed_batch(
                qdb_t, qoff_t[i:i + step], qlen_t[i:i + step], rid,
                MAX_MEM_INTV, min_seed + 1, stats=stats))
        r3, m3, n3 = (torch.cat(p) for p in zip(*parts))
    lap("pass3_s")

    r_all = torch.cat([r1, r2, r3])
    m_all = torch.cat([m1, m2, m3]).to(i64)
    n_all = torch.cat([n1, n2, n3]).to(i64)
    # (rid asc, m asc, n desc): n and m are below 2^16
    order = torch.argsort((r_all << 32) | (m_all << 16) | (0xFFFF - n_all),
                          stable=True)
    out = torch.stack([r_all, m_all, n_all])[:, order].to(i32).cpu().numpy()
    lap("sort_s")
    if stats is not None:
        stats.update(reads=n, items_pass1=int(ridx.shape[0]),
                     items_pass2=int(rr.shape[0]), hits_pass3=int(r3.shape[0]),
                     smems=int(out.shape[1]))
    return [(out[0], out[1], out[2])]


def read_queries(path: str) -> List[np.ndarray]:
    """The reads of a FASTQ or FASTA file as code arrays, in order."""
    reads = []
    with open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == "@":
            while True:
                h = f.readline()
                if not h:
                    break
                s = f.readline().strip()
                f.readline()
                f.readline()
                reads.append(_ENC[np.frombuffer(s.encode(), np.uint8)])
        else:
            cur = []
            for line in f:
                line = line.strip()
                if line.startswith(">"):
                    if cur:
                        reads.append(_ENC[np.frombuffer(
                            "".join(cur).encode(), np.uint8)])
                    cur = []
                else:
                    cur.append(line)
            if cur:
                reads.append(_ENC[np.frombuffer(
                    "".join(cur).encode(), np.uint8)])
    return reads


def load_index(ref_file: str) -> FMIndex:
    """The index of ref_file: a `.bwt.2bit.64` file, one beside a fasta
    prefix, a saved `.npz`, or else a fasta built on the fly."""
    if ref_file.endswith(".bwt.2bit.64"):
        return FMIndex.load_bwt2bit64(ref_file)
    if os.path.exists(ref_file + ".bwt.2bit.64"):
        # reference CLI contract: fasta prefix with prebuilt bwa-mem2
        # artifacts beside it (FMI_search ctor + load_index)
        return FMIndex.load_bwt2bit64(ref_file + ".bwt.2bit.64")
    if ref_file.endswith(".npz"):
        return FMIndex.load(ref_file)
    return build_index_from_fasta(ref_file)


def smem_text(results) -> str:
    """The SMEM lines of search_reads' result: `rid:` before a read's
    first SMEM (and for every read since the last one printed), then
    `[m,n+1]` per SMEM; reads after the last read with an SMEM get no
    line, as in the JAX package."""
    prev_rid = -1
    parts = []
    for (r_a, m_a, n_a) in results:
        for r_, m_, n_ in zip(r_a.tolist(), m_a.tolist(),
                              (n_a.astype(np.int64) + 1).tolist()):
            if r_ != prev_rid:
                parts.append("".join(f"{j}:\n"
                                     for j in range(prev_rid + 1, r_ + 1)))
                prev_rid = r_
            parts.append(f"[{m_},{n_}]\n")
    return "".join(parts)


def run(argv: Sequence[str]) -> int:
    """CLI compatible with the reference fmi binary (fmi.cpp:74-79):
    ref_file query_set batch_size minSeedLen n_threads.  ref_file may be
    a fasta (index built on the fly, or a `.bwt.2bit.64` beside it), a
    `.bwt.2bit.64` file or a saved .npz index."""
    if len(argv) != 5:
        print("Need five arguments : ref_file query_set batch_size "
              "minSeedLen n_threads")
        return 1
    ref_file, query_file = argv[0], argv[1]
    batch_size, min_seed, nthreads = int(argv[2]), int(argv[3]), int(argv[4])
    dev = resolve_device()

    print("before reading sequences")
    reads = read_queries(query_file)
    fmi = FMISearch(load_index(ref_file), device=dev, mesh=data_mesh(),
                    shard_tables=os.environ.get("GENARCH_FMI_SHARD_TABLES",
                                                "0") == "1")

    lens = [len(r) for r in reads]
    print(f"numReads = {len(reads)}, max_readlength = {max(lens)}, "
          f"min_readlength = {min(lens)}")
    print(f"Running {nthreads} threads")

    roi = ROITimer("fmi", "Computing time: {t} s")
    with roi:
        results = search_reads(fmi, reads, batch_size, min_seed)
    total = sum(len(r[0]) for r in results)
    print(f"totalSmems = {total}")
    print("Reading time: 0 s")
    roi.report(file=sys.stdout)
    sys.stdout.write(smem_text(results))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
