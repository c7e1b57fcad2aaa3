"""FASTA/FASTQ reading and 2-bit DNA encoding (Flye's SequenceContainer:
kmer-cnt/sequence_container.cpp:81-300, sequence.h:143-175).  The
port's copy of the JAX package's io/fasta_io.py, except that
`read_fasta` requires the C reader (`native.fasta_read`, zlib for
`.gz`); `_read_fasta_py` is its plain version.

Records longer than `min_len` (strictly) are kept, in file order.
Non-ACGT characters map to 3 ('T'): the reference's dnaToId table
returns (size_t)-1 for them, which packs as 0b11 into the 2-bit chunk
word, so an N counts as a T."""

from __future__ import annotations

import dataclasses
import gzip
from typing import List

import numpy as np

from genarchbench_tpu_torch import native

_DNA2BIT = np.full(256, 3, np.uint8)
for _i, _c in enumerate("ACGT"):
    _DNA2BIT[ord(_c)] = _i
    _DNA2BIT[ord(_c.lower())] = _i


@dataclasses.dataclass
class ReadSet:
    names: List[str]
    seqs: List[np.ndarray]        # 2-bit codes, uint8

    def __len__(self):
        return len(self.seqs)


def read_fasta(path: str, min_len: int = 0) -> ReadSet:
    """The records of a FASTA or FASTQ file (gzip or plain, told apart by
    the first byte) longer than `min_len`, by the C reader."""
    return ReadSet(*native.fasta_read(path, min_len))


def _read_fasta_py(path: str, min_len: int = 0) -> ReadSet:
    op = gzip.open if path.endswith(".gz") else open
    names: List[str] = []
    seqs: List[np.ndarray] = []
    with op(path, "rt") as f:
        first = f.read(1)
        f.seek(0)
        if first == "@":                      # fastq
            while True:
                h = f.readline()
                if not h:
                    break
                s = f.readline().strip()
                f.readline()
                f.readline()
                if len(s) > min_len:
                    names.append(h[1:].split()[0])
                    seqs.append(_DNA2BIT[np.frombuffer(
                        s.encode(), np.uint8)])
        else:                                 # fasta
            name, parts = None, []

            def flush():
                if name is not None:
                    s = "".join(parts)
                    if len(s) > min_len:
                        names.append(name)
                        seqs.append(_DNA2BIT[np.frombuffer(
                            s.encode(), np.uint8)])
            for line in f:
                line = line.rstrip()
                if line.startswith(">"):
                    flush()
                    name = line[1:].split()[0] if len(line) > 1 else ""
                    parts = []
                else:
                    parts.append(line)
            flush()
    return ReadSet(names, seqs)
