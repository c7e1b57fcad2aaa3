"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and runs on the CUDA card unless asked for the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from genarchbench_tpu_torch import cli
from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.entry import dryrun_multichip, entry
from genarchbench_tpu_torch.io.chain_io import ChainRecord
from genarchbench_tpu_torch.kernels import (abea, bpm, bsw, chain, dbg,
                                            fast_chain, fmi, kmer, pileup,
                                            poa, wfa)
from genarchbench_tpu_torch.nn import basecall, ssw, variant
from tests import (torch_abea_inputs, torch_dbg_inputs, torch_kmer_inputs,
                   torch_pileup_inputs, torch_poa_inputs,
                   torch_variant_inputs)
from tests.synth import gen_bsw_input, gen_chain_input, gen_seqpair_dataset
from tests.torch_fmi_inputs import gen_case

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "genarchbench_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def test_import_leaves_jax_out():
    """Imported in a fresh process (this one already holds jax)."""
    code = ("import sys; import genarchbench_tpu_torch, "
            "genarchbench_tpu_torch.cli, genarchbench_tpu_torch.kernels.bpm, "
            "genarchbench_tpu_torch.kernels.bsw, genarchbench_tpu_torch.convert, "
            "genarchbench_tpu_torch.kernels.wfa, genarchbench_tpu_torch.nn.basecall, "
            "genarchbench_tpu_torch.nn.train, "
            "genarchbench_tpu_torch.native, genarchbench_tpu_torch.entry, "
            "genarchbench_tpu_torch.kernels.chain, "
            "genarchbench_tpu_torch.kernels.fast_chain, "
            "genarchbench_tpu_torch.kernels.fmi, "
            "genarchbench_tpu_torch.kernels.abea, "
            "genarchbench_tpu_torch.kernels.poa, "
            "genarchbench_tpu_torch.core.blocks, "
            "genarchbench_tpu_torch.io.bam_io, "
            "genarchbench_tpu_torch.io.fast5_io, "
            "genarchbench_tpu_torch.io.chain_io, "
            "genarchbench_tpu_torch.nn.variant, "
            "genarchbench_tpu_torch.nn.ssw, "
            "genarchbench_tpu_torch.sharding.batching, "
            "genarchbench_tpu_torch.sharding.mesh, "
            "genarchbench_tpu_torch.core.config, "
            "genarchbench_tpu_torch.harness, "
            "genarchbench_tpu_torch.harness.scheduler, "
            "genarchbench_tpu_torch.harness.dataset_regress; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'flax', 'genarchbench_tpu')); print(bad)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "optax", "flax",
                           "genarchbench_tpu"), (path, mod)


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GENARCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    assert resolve_device() == torch.device("cpu")


@pytest.mark.parametrize("kernel", ["bpm", "bsw", "wfa", "nn-base", "chain",
                                    "fast-chain", "fmi", "abea", "poa",
                                    "kmer-cnt", "kmer-cnt-minimizers", "dbg",
                                    "pileup", "nn-variant"])
def test_run_without_device_raises(monkeypatch, tmp_path, kernel):
    """With GENARCH_DEVICE unset, the CLIs ask for the card and do not
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GENARCH_DEVICE", raising=False)
    rng = np.random.default_rng(0)
    inp = tmp_path / "in.txt"
    if kernel in ("bpm", "wfa"):
        inp.write_text(gen_seqpair_dataset(rng, n_pairs=4, length=30))
        argv = ["-i", str(inp)]
    elif kernel == "nn-base":
        reads = tmp_path / "reads"
        reads.mkdir()
        np.save(reads / "r.npy", rng.normal(400, 60, 900).astype(np.int16))
        argv = ["default", str(reads), "--chunksize", "300"]
    elif kernel in ("chain", "fast-chain"):
        inp.write_text(gen_chain_input(rng, n_records=3, max_anchors=20))
        argv = ["-i", str(inp), "-o", str(tmp_path / "out.txt")]
    elif kernel == "fmi":
        fa, fq = gen_case(tmp_path, rng, ref_len=500, n_reads=2, read_len=50)
        argv = [str(fa), str(fq), "8", "19", "1"]
    elif kernel == "abea":
        from genarchbench_tpu_torch.io import bam_io
        model = torch_abea_inputs.synth_model(0)
        seq = torch_abea_inputs.random_seq(rng, 60)
        p = torch_abea_inputs.write_cli_case(
            tmp_path, model, [seq],
            [torch_abea_inputs.synth_signal(rng, model, seq)], bam_io)
        argv = ["-b", str(p["bam"]), "-g", str(p["ref"]), "-r",
                str(p["npy"]), "--kmer-model", str(p["model"])]
    elif kernel == "poa":
        inp.write_text(torch_poa_inputs.batches_text(rng, (3,), 30))
        argv = ["-s", str(inp)]
    elif kernel.startswith("kmer-cnt"):
        torch_kmer_inputs.gen_fasta(rng, inp, n_reads=2)
        cfg = tmp_path / "k.cfg"
        torch_kmer_inputs.write_config(
            cfg, use_minimizers=int(kernel.endswith("minimizers")))
        kernel, argv = "kmer-cnt", ["--reads", str(inp), "--config", str(cfg)]
    elif kernel == "dbg":
        from genarchbench_tpu_torch.io import bam_io
        bam, fa = torch_dbg_inputs.make_case(tmp_path, rng, bam_io,
                                             ref_len=2000, n_reads=10)
        argv = [str(bam), "tig1:1-2000", str(fa), "1", "1"]
    elif kernel == "nn-variant":
        from genarchbench_tpu_torch.io import bam_io
        rng_ref = torch_variant_inputs.random_ref(rng, 400)
        torch_variant_inputs.write_fasta(tmp_path / "ref.fa", "c1", rng_ref)
        bam_io.write_bam(str(inp), [("c1", 400)],
                         torch_variant_inputs.two_hap_records(
                             rng, rng_ref, {200: "A"}, bam_io))
        argv = ["--bam", str(inp), "--ref", str(tmp_path / "ref.fa"),
                "--region", "c1:1-400"]
    elif kernel == "pileup":
        from genarchbench_tpu_torch.io import bam_io
        torch_pileup_inputs.make_bam(inp, rng, bam_io, n_reads=10)
        argv = [str(inp), "tig1:1-2000", "1"]
    else:
        inp.write_text(gen_bsw_input(rng, n_pairs=4, ref_len=40,
                                     query_len=20))
        argv = ["-pairs", str(inp)]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["run", kernel, *argv])


def test_public_functions_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GENARCH_DEVICE", raising=False)
    from genarchbench_tpu_torch.io.bsw_io import BswPairs
    from genarchbench_tpu_torch.io.seqpair_io import SeqPairs
    seqs = SeqPairs([np.zeros(3, np.uint8)], [np.zeros(2, np.uint8)])
    reads = kmer.ReadSet(["r"], [np.zeros(40, np.uint8)])
    recs = [ChainRecord(2, 20.0, 5000, 5000, 500, 1,
                        np.array([5, 90], np.uint64),
                        np.array([1, 40], np.uint64))]
    for call in (lambda: bpm.bpm_batch(seqs),
                 lambda: bpm.bitpal_batch(seqs, 0, -1, -1),
                 lambda: wfa.wfa_batch(seqs),
                 lambda: chain.chain_batch(recs),
                 lambda: fast_chain.fast_chain_batch(recs),
                 lambda: fmi.FMISearch(fmi.build_index(np.zeros(8, np.uint8))),
                 lambda: abea.align_batch(["ACGTACGT"], [np.ones((4, 4))],
                                          torch_abea_inputs.synth_model(0)),
                 lambda: poa.ConvexNWEngine(),
                 lambda: kmer.count_distinct(reads, 11),
                 lambda: kmer.count_distinct_hostmerge(reads, 11),
                 lambda: kmer.count_distinct_sharded(reads, 11),
                 lambda: dbg._window_min_mask(["ACGT" * 10],
                                              [np.full(40, 30, np.uint8)]),
                 lambda: pileup.calculate_pileup([], 0, 0, 100),
                 lambda: basecall.Basecaller.init(),
                 lambda: variant.PileupCaller.init(),
                 lambda: variant.FullAlignmentCaller.init(),
                 lambda: ssw.SswAligner(),
                 lambda: variant.realign_reads([], "ACGT", 0, 4, 0),
                 lambda: entry(),
                 lambda: dryrun_multichip(2),
                 lambda: bsw.bsw_batch(BswPairs(
                     np.array([5], np.int32), [np.zeros(4, np.int32)],
                     [np.zeros(3, np.int32)]))):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_wrappers_check_their_inputs():
    from genarchbench_tpu_torch.kernels import bpm_cuda, bsw_cuda
    peq = torch.zeros((1, 4, 3), dtype=torch.int32)
    lens = torch.ones(3, dtype=torch.int32)
    text = torch.zeros((5, 3), dtype=torch.int8)
    with pytest.raises(TypeError, match="text must be torch.int8"):
        bpm_cuda.bpm_distance(peq, lens, text.int(), lens)
    with pytest.raises(ValueError, match="plen must be"):
        bpm_cuda.bpm_distance(peq, lens[:2], text, lens)
    s1 = torch.zeros((2, 8, 32), dtype=torch.uint8)
    lane = torch.zeros((2, 8), dtype=torch.int32)
    sc = dict(match=1, mismatch=-4, ambig=-1, o_del=6, e_del=1, o_ins=6,
              e_ins=1, zdrop=100, w=100)
    with pytest.raises(ValueError, match="h0 must be"):
        bsw_cuda.bsw_scores(s1, s1, lane, lane, lane[:1], lane, **sc)
    with pytest.raises(TypeError, match="seq2 must be torch.uint8"):
        bsw_cuda.bsw_scores(s1, s1.int(), lane, lane, lane, lane, **sc)
