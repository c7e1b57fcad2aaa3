"""The port's data-parallel mesh paths on the CPU, all exact: every batch
function run over `data_mesh(8)` (8 CPU shards, GENARCH_DEVICE=cpu)
equals the port's single-device run and the JAX package's run over its
own `data_mesh(8)` of virtual host devices (tests/conftest.py), on
tests/test_sharding.py's seeds and sizes; the sharded k-mer count equals
JAX's, `count_distinct` and, where JAX's pair codes break (k >= 23), the
Python oracle `tests/test_kmer.py::py_distinct`."""

import io

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from genarchbench_tpu.io import bsw_io as JBI
from genarchbench_tpu.io import chain_io as JCI
from genarchbench_tpu.io import fasta_io as JF
from genarchbench_tpu.io import seqpair_io as JSI
from genarchbench_tpu.kernels import abea as JA
from genarchbench_tpu.kernels import bpm as JBPM
from genarchbench_tpu.kernels import bsw as JBSW
from genarchbench_tpu.kernels import chain as JC
from genarchbench_tpu.kernels import fast_chain as JFC
from genarchbench_tpu.kernels import fmi as JFMI
from genarchbench_tpu.kernels import kmer as JK
from genarchbench_tpu.kernels import wfa as JW
from genarchbench_tpu.sharding.mesh import data_mesh as jax_data_mesh
from genarchbench_tpu_torch.io import bsw_io, chain_io, fasta_io, seqpair_io
from genarchbench_tpu_torch.kernels import (abea, bpm, bsw, chain,
                                            fast_chain, fmi, kmer, wfa)
from genarchbench_tpu_torch.sharding.mesh import data_mesh
from tests import torch_abea_inputs as AI
from tests.synth import gen_bsw_input, gen_chain_input, gen_seqpair_dataset
from tests.test_kmer import gen_fasta, py_distinct


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    monkeypatch.delenv("GENARCH_FMI_FORCE_WIDE", raising=False)


def seqpairs(tmp_path, seed, swap, **kw):
    f = tmp_path / "pairs.txt"
    f.write_text(gen_seqpair_dataset(np.random.default_rng(seed), **kw))
    return (seqpair_io.read_seqpairs(str(f), swap_longer_first=swap),
            JSI.read_seqpairs(str(f), swap_longer_first=swap))


def bpm_case(tmp_path, algo):
    ours, theirs = seqpairs(tmp_path, 12, True, n_pairs=24, length=70,
                            error_rate=0.12)
    if algo == "bpm":
        return (lambda mesh: bpm.bpm_batch(ours, mesh=mesh).tolist(),
                JBPM.bpm_batch(theirs, mesh=jax_data_mesh(8)).tolist())
    sc = (0, -1, -1) if algo == "bitpal-edit" else (1, -4, -2)
    return (lambda mesh: bpm.bitpal_batch(ours, *sc, mesh=mesh).tolist(),
            JBPM.bitpal_batch(theirs, *sc, mesh=jax_data_mesh(8)).tolist())


def bsw_case(tmp_path, lanes):
    f = tmp_path / "pairs.txt"
    f.write_text(gen_bsw_input(np.random.default_rng(13), n_pairs=20,
                               ref_len=90, query_len=80))
    ours, theirs = bsw_io.read_bsw_pairs(str(f)), JBI.read_bsw_pairs(str(f))
    return (lambda mesh: bsw.bsw_batch(ours, lanes=lanes,
                                       mesh=mesh).tolist(),
            JBSW.bsw_batch(theirs, lanes=lanes,
                           mesh=jax_data_mesh(8)).tolist())


def wfa_case(tmp_path):
    ours, theirs = seqpairs(tmp_path, 14, False, n_pairs=16, length=60,
                            error_rate=0.08)
    return (lambda mesh: wfa.wfa_batch(ours, mesh=mesh),
            JW.wfa_batch(theirs, mesh=jax_data_mesh(8)))


def chain_case(fast):
    text = gen_chain_input(np.random.default_rng(11), n_records=10,
                           max_anchors=60)
    ours = list(chain_io.read_records(io.StringIO(text)))
    theirs = list(JCI.read_records(io.StringIO(text)))

    def lists(res):
        return [[np.asarray(a).tolist() for a in r[:2]] for r in res]
    if fast:
        return (lambda mesh: lists(fast_chain.fast_chain_batch(ours,
                                                               mesh=mesh)),
                lists(JFC.fast_chain_batch(theirs, mesh=jax_data_mesh(8))))
    return (lambda mesh: lists(chain.chain_batch(ours, mesh=mesh)),
            lists(JC.chain_batch(theirs, mesh=jax_data_mesh(8))))


def abea_case():
    rng = np.random.default_rng(16)
    seqs = [AI.random_seq(rng, int(rng.integers(80, 140))) for _ in range(5)]
    ets = [abea.get_events(AI.synth_signal(rng, AI.synth_model(0), s))
           for s in seqs]
    model = AI.synth_model(0)
    with jax.enable_x64():
        want = JA.align_batch(seqs, ets, model, mesh=jax_data_mesh(8))
    assert all(want)
    return (lambda mesh: abea.align_batch(seqs, ets, model, mesh=mesh),
            want)


def fmi_case(shard_tables):
    rng = np.random.default_rng(15)
    ref = rng.integers(0, 4, 600).astype(np.uint8)
    reads = []
    for _ in range(12):
        p = int(rng.integers(0, 500))
        L = int(rng.integers(30, 80))
        r = ref[p:p + L].copy()
        nmut = max(1, L // 20)
        r[rng.integers(0, L, nmut)] = rng.integers(0, 4, nmut)
        reads.append(r)

    def flat(groups):
        return [np.concatenate([g[i] for g in groups]).tolist()
                for i in range(3)]
    index = fmi.build_index(ref)
    want = flat(JFMI.search_reads(
        JFMI.FMISearch(JFMI.build_index(ref), mesh=jax_data_mesh(8),
                       shard_tables=shard_tables), reads, 8, 19))
    return (lambda mesh: flat(fmi.search_reads(
        fmi.FMISearch(index, device="cpu", mesh=mesh,
                      shard_tables=shard_tables), reads, 8, 19)), want)


CASES = {
    "bpm": lambda tp: bpm_case(tp, "bpm"),
    "bitpal-edit": lambda tp: bpm_case(tp, "bitpal-edit"),
    "bitpal-scored": lambda tp: bpm_case(tp, "bitpal-scored"),
    "bsw": lambda tp: bsw_case(tp, 8),
    "bsw-i8": lambda tp: bsw_case(tp, 16),
    "wfa": wfa_case,
    "chain": lambda tp: chain_case(False),
    "fast-chain": lambda tp: chain_case(True),
    "abea": lambda tp: abea_case(),
    "fmi": lambda tp: fmi_case(False),
    "fmi-shard-tables": lambda tp: fmi_case(True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_single_and_jax(tmp_path, name):
    run, want = CASES[name](tmp_path)
    single = run(None)
    assert run(data_mesh(8)) == single
    assert single == want
    assert run(data_mesh(3)) == single          # shards of unequal fill


def kmer_reads(tmp_path, seed=2, **kw):
    f = tmp_path / "reads.fasta"
    gen_fasta(np.random.default_rng(seed), f, **kw)
    return fasta_io.read_fasta(str(f)), JF.read_fasta(str(f))


@pytest.mark.parametrize("S", [2, 3, 8])
def test_kmer_sharded_against_jax(tmp_path, S):
    ours, theirs = kmer_reads(tmp_path, n_reads=4, min_len=2000,
                              max_len=3000)
    want = kmer.count_distinct(ours, 15, device="cpu")
    assert kmer.count_distinct_sharded(ours, 15, mesh=data_mesh(S)) == want
    mesh = JMesh(np.array(jax.devices()[:S]), ("kspace",))
    assert JK.count_distinct_sharded(theirs, 15, mesh=mesh) == want


@pytest.mark.parametrize("k", [23, 25, 31])
def test_kmer_sharded_long_k(tmp_path, k):
    """Above k = 22 JAX's (hi, lo) pair codes break; the port's int64
    codes hold up to 31 bases."""
    ours, _ = kmer_reads(tmp_path, seed=k, n_reads=3, min_len=300,
                         max_len=600)
    got = kmer.count_distinct_sharded(ours, k, mesh=data_mesh(8))
    assert got == py_distinct(ours, k) == kmer.count_distinct(
        ours, k, device="cpu")


def test_kmer_sharded_empty_shards():
    """Two reads over 8 shards: six shards hold no read and take part in
    the exchange with no codes; one read is shorter than k."""
    rng = np.random.default_rng(7)
    reads = kmer.ReadSet(["a", "b", "c"],
                         [rng.integers(0, 4, 400).astype(np.uint8),
                          rng.integers(0, 4, 10).astype(np.uint8),
                          rng.integers(0, 4, 300).astype(np.uint8)])
    got = kmer.count_distinct_sharded(reads, 15, mesh=data_mesh(8))
    assert got == py_distinct(reads, 15) == kmer.count_distinct(
        reads, 15, device="cpu")
    assert kmer.count_distinct_sharded(
        kmer.ReadSet([], []), 15, mesh=data_mesh(8)) == 0
