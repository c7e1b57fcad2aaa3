"""Minimal BAM I/O: BGZF blocks, alignment records, the BAI index.

The role htslib plays in the reference (abea reads its alignments from a
BAM through htslib).  The BAM spec directly: BGZF framing, the binary
alignment record layout, and BAI binning and linear indexes, enough to
read coordinate-sorted BAMs, filter by region and write indexed BAMs for
tests and tools.  The port's own copy of the JAX package's
io/bam_io.py, except that the BGZF reader requires the C decoder
(`native.bgzf_decompress`); the zlib loop `bgzf_read_plain` is its plain
version.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from genarchbench_tpu_torch import native

BAM_MAGIC = b"BAM\x01"
BAI_MAGIC = b"BAI\x01"
CIGAR_OPS = "MIDNSHP=X"
NT16 = "=ACMGRSVTWYHKDBN"
NT16_OF = {c: i for i, c in enumerate(NT16)}
NT16_TABLE = np.full(256, 15, np.uint8)
for _c, _i in NT16_OF.items():
    NT16_TABLE[ord(_c)] = _i
    NT16_TABLE[ord(_c.lower())] = _i
REF_CONSUME = {0, 2, 3, 7, 8}      # M D N = X
QRY_CONSUME = {0, 1, 4, 7, 8}      # M I S = X

FUNMAP, FSECONDARY, FQCFAIL, FDUP, FSUPPL = 0x4, 0x100, 0x200, 0x400, 0x800
FREVERSE = 0x10

_EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


# ---------------------------------------------------------------------------
# BGZF
# ---------------------------------------------------------------------------

def _bgzf_compress(data: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    payload = comp.compress(data) + comp.flush()
    bsize = len(payload) + 25 + 1
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
              + struct.pack("<HHH", 6, 0x4342, 2)
              + struct.pack("<H", bsize - 1))
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + payload + footer


def bgzf_write(path: str, data: bytes,
               block_boundaries: Optional[List[int]] = None) -> List[int]:
    """Write `data` as BGZF blocks split at `block_boundaries` (offsets in
    data, ascending; default 64k chunks). Returns the compressed file
    offset of each block."""
    if block_boundaries is None:
        block_boundaries = list(range(0, len(data), 0xFF00))
    bounds = list(block_boundaries) + [len(data)]
    offsets = []
    with open(path, "wb") as f:
        for i in range(len(bounds) - 1):
            offsets.append(f.tell())
            f.write(_bgzf_compress(data[bounds[i]:bounds[i + 1]]))
        f.write(_EOF_BLOCK)
    return offsets


def bgzf_read(path: str) -> bytes:
    """The decompressed contents of a BGZF file (C decoder)."""
    with open(path, "rb") as f:
        return native.bgzf_decompress(f.read())


def bgzf_read_plain(path: str) -> bytes:
    """bgzf_read's plain version: the blocks inflated one by one with
    Python's zlib."""
    with open(path, "rb") as f:
        raw = f.read()
    out = []
    pos = 0
    while pos < len(raw):
        if raw[pos:pos + 2] != b"\x1f\x8b":
            raise ValueError(f"bad BGZF magic at {pos}")
        xlen = struct.unpack("<H", raw[pos + 10:pos + 12])[0]
        extra = raw[pos + 12:pos + 12 + xlen]
        bsize = None
        e = 0
        while e < len(extra):
            si1, si2, slen = extra[e], extra[e + 1], struct.unpack(
                "<H", extra[e + 2:e + 4])[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack("<H", extra[e + 4:e + 6])[0] + 1
            e += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BC field")
        payload = raw[pos + 12 + xlen:pos + bsize - 8]
        out.append(zlib.decompress(payload, -15))
        pos += bsize
    return b"".join(out)


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BamRecord:
    qname: str
    flag: int
    ref_id: int
    pos: int                       # 0-based
    mapq: int
    cigar: List[Tuple[int, int]]   # (op, len)
    seq: str
    qual: np.ndarray               # uint8 phred values
    aux: bytes = b""

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    def ref_span(self) -> int:
        return sum(n for op, n in self.cigar if op in REF_CONSUME)

    def nt16(self) -> np.ndarray:
        return NT16_TABLE[np.frombuffer(self.seq.encode("latin-1"),
                                        np.uint8)]


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_record(r: BamRecord) -> bytes:
    name = r.qname.encode() + b"\x00"
    cig = b"".join(struct.pack("<I", (n << 4) | op) for op, n in r.cigar)
    l_seq = len(r.seq)
    seq4 = bytearray((l_seq + 1) // 2)
    for i, c in enumerate(r.seq):
        v = NT16_OF.get(c.upper(), 15)
        seq4[i // 2] |= v << (4 if i % 2 == 0 else 0)
    qual = bytes(np.asarray(r.qual, np.uint8)) if l_seq else b""
    end = r.pos + max(r.ref_span(), 1)
    body = struct.pack(
        "<iiBBHHHiiii", r.ref_id, r.pos, len(name), r.mapq,
        _reg2bin(r.pos, end), len(r.cigar), r.flag, l_seq, -1, -1, 0)
    body += name + cig + bytes(seq4) + qual + r.aux
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, refs: List[Tuple[str, int]],
              records: List[BamRecord], index: bool = True) -> None:
    """Write a coordinate-sorted BAM (+ .bai when `index`)."""
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in refs)
    head = BAM_MAGIC + struct.pack("<i", len(text)) + text.encode()
    head += struct.pack("<i", len(refs))
    for n, l in refs:
        nm = n.encode() + b"\x00"
        head += struct.pack("<i", len(nm)) + nm + struct.pack("<i", l)

    encoded = [_encode_record(r) for r in records]
    # block boundaries: the header alone, then each record starts a block
    # if the current block would pass the BGZF limit (list-accumulated: a
    # bytes += loop is quadratic in the output's size)
    parts = [head]
    total = len(head)
    bounds = [0]
    rec_off: List[Tuple[int, int]] = []   # (block_idx, offset_in_block)
    cur_start = 0
    for enc in encoded:
        if total - cur_start + len(enc) > 0xFF00:
            bounds.append(total)
            cur_start = total
        rec_off.append((len(bounds) - 1, total - cur_start))
        parts.append(enc)
        total += len(enc)
    data = b"".join(parts)
    offsets = bgzf_write(path, data, bounds)

    if index:
        voffs = [(offsets[b] << 16) | o for b, o in rec_off]
        end_voff = (offsets[-1] << 16) | (len(data) - bounds[-1])
        _write_bai(path + ".bai", refs, records, voffs, end_voff)


def _write_bai(path: str, refs, records, voffs, end_voff) -> None:
    per_ref_bins: List[Dict[int, List[Tuple[int, int]]]] = \
        [dict() for _ in refs]
    per_ref_ioff: List[Dict[int, int]] = [dict() for _ in refs]
    for r, vo, vo_next in zip(
            records, voffs, voffs[1:] + [end_voff]):
        if r.ref_id < 0:
            continue
        beg = r.pos
        end = r.pos + max(r.ref_span(), 1)
        b = _reg2bin(beg, end)
        per_ref_bins[r.ref_id].setdefault(b, []).append((vo, vo_next))
        for w in range(beg >> 14, ((end - 1) >> 14) + 1):
            cur = per_ref_ioff[r.ref_id].get(w)
            per_ref_ioff[r.ref_id][w] = vo if cur is None else min(cur, vo)
    out = BAI_MAGIC + struct.pack("<i", len(refs))
    for bins, ioffs in zip(per_ref_bins, per_ref_ioff):
        out += struct.pack("<i", len(bins))
        for b, chunks in sorted(bins.items()):
            # merge adjacent chunks
            merged = [list(chunks[0])]
            for c in chunks[1:]:
                if c[0] == merged[-1][1]:
                    merged[-1][1] = c[1]
                else:
                    merged.append(list(c))
            out += struct.pack("<Ii", b, len(merged))
            for beg, end in merged:
                out += struct.pack("<QQ", beg, end)
        n_intv = (max(ioffs) + 1) if ioffs else 0
        out += struct.pack("<i", n_intv)
        prev = 0
        for w in range(n_intv):
            prev = ioffs.get(w, prev)
            out += struct.pack("<Q", prev)
    with open(path, "wb") as f:
        f.write(out)


def read_bam(path: str) -> Tuple[List[Tuple[str, int]], List[BamRecord]]:
    """Read all records of a BAM (no index needed)."""
    data = bgzf_read(path)
    if data[:4] != BAM_MAGIC:
        raise ValueError("not a BAM file")
    p = 4
    (l_text,) = struct.unpack_from("<i", data, p); p += 4
    p += l_text
    (n_ref,) = struct.unpack_from("<i", data, p); p += 4
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, p); p += 4
        name = data[p:p + l_name - 1].decode(); p += l_name
        (l_ref,) = struct.unpack_from("<i", data, p); p += 4
        refs.append((name, l_ref))
    records = []
    n = len(data)
    while p < n:
        (bsize,) = struct.unpack_from("<i", data, p); p += 4
        end = p + bsize
        (ref_id, pos, l_qname, mapq, _bin, n_cigar, flag, l_seq,
         _nref, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", data, p)
        q = p + 32
        qname = data[q:q + l_qname - 1].decode(); q += l_qname
        cigar = []
        for _ in range(n_cigar):
            (v,) = struct.unpack_from("<I", data, q); q += 4
            cigar.append((v & 0xF, v >> 4))
        nb = (l_seq + 1) // 2
        seqb = data[q:q + nb]; q += nb
        seq = "".join(
            NT16[(seqb[i // 2] >> (4 if i % 2 == 0 else 0)) & 0xF]
            for i in range(l_seq))
        qual = np.frombuffer(data[q:q + l_seq], np.uint8).copy(); q += l_seq
        aux = data[q:end]
        records.append(BamRecord(qname, flag, ref_id, pos, mapq, cigar,
                                 seq, qual, aux))
        p = end
    return refs, records


def parse_region(region: str) -> Tuple[str, Optional[int], Optional[int]]:
    """'chr:start-end' (1-based inclusive) -> (chr, start0, end0_excl)."""
    if ":" not in region:
        return region, None, None
    chrom, rng = region.rsplit(":", 1)
    if "-" in rng:
        s, e = rng.split("-")
        return chrom, int(s.replace(",", "")) - 1, int(e.replace(",", ""))
    return chrom, int(rng) - 1, None
