"""The port's SSW aligner against the JAX package, on the CPU, all exact:
`_sweep`'s four outputs in both directions and with `terminate`, at the
default block, a block of 7 and a block longer than Lref; `_banded_sw`,
band doubling included; `SswAligner.align_batch`'s seven fields and
CIGAR on test_ssw.py's three parameter sets and `mutate`; and
`realign_reads`' records (position, CIGAR) on a short-read input whose
reads span a deletion unaligned."""

import numpy as np
import pytest
import torch

from genarchbench_tpu.io import bam_io as JB
from genarchbench_tpu.nn import ssw as J
from genarchbench_tpu.nn import variant as JV
from genarchbench_tpu_torch.io import bam_io as TB
from genarchbench_tpu_torch.nn import ssw as T
from genarchbench_tpu_torch.nn import variant as TV
from tests import torch_variant_inputs as I
from tests.test_ssw import mutate

SETS = [(0, 24, 40, 80, 0.05), (1, 24, 100, 160, 0.12), (2, 16, 30, 30, 0.25)]


def pairs_of(seed, n, rdlen, rflen, err):
    """test_ssw.py's pairs, draw for draw."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        ref = "".join("ACGT"[c] for c in rng.integers(0, 4, rflen))
        lo = int(rng.integers(0, max(rflen - rdlen, 1)))
        read = mutate(rng, ref[lo:lo + rdlen], err)
        pairs.append((read or "A", ref))
    return pairs


def padded(seqs, L):
    """Base codes of seqs in a (B, L) int32 array padded with 4, lengths."""
    a = np.full((len(seqs), L), 4, np.int32)
    for b, s in enumerate(seqs):
        a[b, :len(s)] = T._ENC[np.frombuffer(s.encode(), np.uint8)]
    return a, np.array([len(s) for s in seqs], np.int32)


def sweep_inputs(seed, n, rdlen, rflen, err):
    pairs = pairs_of(seed, n, rdlen, rflen, err)
    Lread = T._pow2(max(len(r) for r, _ in pairs))
    Lref = T._pow2(max(len(f) for _, f in pairs))
    reads, rdl = padded([r for r, _ in pairs], Lread)
    refs, rfl = padded([f for _, f in pairs], Lref)
    return refs, reads, rfl, rdl, Lref, Lread


MAT = T.default_matrix(4, 6)


def both_sweeps(refs, reads, rfl, rdl, terminate, Lref, Lread, reverse,
                block=T.BLOCK):
    import jax.numpy as jnp
    want = J._sweep(jnp.asarray(refs), jnp.asarray(reads), jnp.asarray(rfl),
                    jnp.asarray(rdl), jnp.asarray(MAT), jnp.asarray(terminate),
                    Lref=Lref, Lread=Lread, gapO=8, gapE=2, reverse=reverse)
    got = T._sweep(*(torch.from_numpy(a) for a in (refs, reads, rfl, rdl)),
                   torch.from_numpy(MAT), torch.from_numpy(terminate), Lref,
                   Lread, 8, 2, reverse, block=block)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("params", SETS, ids=["set0", "set1", "set2"])
def test_sweep_exact(params, reverse):
    """Both directions, without and with `terminate` (the forward best
    scores, as the reverse pass of ssw_align takes them)."""
    refs, reads, rfl, rdl, Lref, Lread = sweep_inputs(*params)
    zero = np.zeros(len(rfl), np.int32)
    got, want = both_sweeps(refs, reads, rfl, rdl, zero, Lref, Lread, reverse)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    term = want[0].astype(np.int32)
    term[::3] = 0
    got, want = both_sweeps(refs, reads, rfl, rdl, term, Lref, Lread, reverse)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("block", [7, 1000])
def test_sweep_blocks(block):
    """Blocks of 7 steps (Lref not a multiple), and one block longer than
    Lref (padding steps write the spare column)."""
    refs, reads, rfl, rdl, Lref, Lread = sweep_inputs(*SETS[1])
    zero = np.zeros(len(rfl), np.int32)
    counts = {}
    for reverse in (False, True):
        want = T._sweep(*(torch.from_numpy(a) for a in (refs, reads, rfl, rdl)),
                        torch.from_numpy(MAT), torch.from_numpy(zero), Lref,
                        Lread, 8, 2, reverse)
        got = T._sweep(*(torch.from_numpy(a) for a in (refs, reads, rfl, rdl)),
                       torch.from_numpy(MAT), torch.from_numpy(zero), Lref,
                       Lread, 8, 2, reverse, block=block, counts=counts)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert counts["steps"] >= 2 * int(rfl.max())


def test_banded_sw_exact():
    """The sub-alignments ssw_align hands banded_sw on test_ssw.py's
    second set, at its band and at band 1, and a read 8 bases shorter
    than its ref at band 1: the band doubles."""
    pairs = pairs_of(*SETS[1])
    cases = []
    for (read, ref), a in zip(pairs, J.SswAligner().align_batch(
            [r for r, _ in pairs], [f for _, f in pairs], with_cigar=False)):
        sub_ref = T._ENC[np.frombuffer(ref.encode(), np.uint8)][
            a.ref_begin1:a.ref_end1 + 1]
        sub_read = T._ENC[np.frombuffer(read.encode(), np.uint8)][
            a.read_begin1:a.read_end1 + 1]
        bw = abs(len(sub_ref) - len(sub_read)) + 1
        cases += [(sub_ref, sub_read, a.score1, bw),
                  (sub_ref, sub_read, a.score1, 1)]
    ref = np.random.default_rng(5).integers(0, 4, 40).astype(np.int8)
    cases.append((ref, np.concatenate([ref[:10], ref[18:]]), 4 * 32 - 22, 1))
    for ref, read, score, bw in cases:
        got = T._banded_sw(ref, read, score, 8, 2, bw, MAT)
        assert got == J._banded_sw(ref, read, score, 8, 2, bw, MAT)
    assert [op for _, op in got] == ["M", "D", "M"] and got[1][0] == 8


@pytest.mark.parametrize("params", SETS, ids=["set0", "set1", "set2"])
def test_align_batch_exact(params):
    pairs = pairs_of(*params)
    reads, refs = [r for r, _ in pairs], [f for _, f in pairs]
    stats = {}
    got = T.SswAligner(device="cpu").align_batch(reads, refs, stats=stats)
    want = J.SswAligner().align_batch(reads, refs)
    fields = ("score1", "score2", "ref_begin1", "ref_end1", "read_begin1",
              "read_end1", "ref_end2")
    for g, w in zip(got, want):
        assert [getattr(g, f) for f in fields] == \
            [getattr(w, f) for f in fields]
        assert g.cigar == w.cigar and g.cigar_string() == w.cigar_string()
    assert len(got) == len(want) == params[1]
    assert stats["rev_steps"] <= stats["fwd_steps"]


def test_realign_reads_exact(tmp_path):
    """Short reads over a 2-base deletion written all-M: realignment moves
    them to CIGARs with the deletion and soft clips."""
    case = I.ilmn_case(tmp_path, TB, ref_len=600, n_reads=60)
    recs = TB.read_bam(str(case["bam"]))[1]
    jrecs = JB.read_bam(str(case["bam"]))[1]
    ref = case["ref_seq"]
    lo, hi = case["deletion"] - 120, case["deletion"] + 120
    got = TV.realign_reads(recs, ref, lo, hi, 0, device="cpu")
    want = JV.realign_reads(jrecs, ref, lo, hi, 0)
    assert [(r.qname, r.pos, r.cigar) for r in got] == \
        [(r.qname, r.pos, r.cigar) for r in want]
    moved = sum(a.cigar != b.cigar for a, b in zip(got, recs))
    assert moved and any(op == 2 for r in got for op, _ in r.cigar)
