"""The PyTorch port's umbrella CLI, on the CPU (GENARCH_DEVICE=cpu)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from genarchbench_tpu_torch import cli, get_kernel, list_kernels
from tests.synth import gen_bsw_input, gen_seqpair_dataset
from tests.torch_fmi_inputs import gen_case, smem_lines


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")


def test_list(capsys):
    assert cli.main(["list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [["abea", "tolerant_abea"],
                                                ["bpm", "sorted"],
                                                ["bsw", "exact"],
                                                ["chain", "exact"],
                                                ["fast-chain", "exact"],
                                                ["fmi", "exact"],
                                                ["nn-base", "exact"],
                                                ["wfa", "sorted"]]
    assert [s.name for s in list_kernels()] == ["abea", "bpm", "bsw",
                                                "chain", "fast-chain", "fmi",
                                                "nn-base", "wfa"]
    assert get_kernel("bsw").timing_line == "Overall SW cycles"
    assert get_kernel("wfa").timing_line == "Time.Alignment:"
    assert get_kernel("nn-base").timing_line == "> samples per second"
    assert get_kernel("chain").timing_line == "Time in kernel:"
    assert get_kernel("fast-chain").timing_line == "Time in kernel:"
    assert get_kernel("fmi").timing_line == "Computing time:"
    assert get_kernel("abea").timing_line == "Data processing time:"
    with pytest.raises(KeyError, match="unknown kernel"):
        get_kernel("poa")


def test_run_bpm(tmp_path, capsys):
    inp, out = tmp_path / "pairs.txt", tmp_path / "out.txt"
    inp.write_text(gen_seqpair_dataset(np.random.default_rng(0), n_pairs=8,
                                       length=60, error_rate=0.05))
    assert cli.main(["run", "bpm", "-i", str(inp), "-o", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 8
    assert all(re.fullmatch(r"\[\d+\] score=-?\d+", ln) for ln in lines)
    err = capsys.readouterr().err
    assert "=> Total.reads            8" in err
    assert re.search(r"=> Time.Benchmark      \d+\.\d\d s", err)
    assert "=> CellUpdates" in err


def test_run_bsw(tmp_path, capsys):
    inp = tmp_path / "pairs.txt"
    inp.write_text(gen_bsw_input(np.random.default_rng(1), n_pairs=12,
                                 ref_len=80, query_len=40))
    assert cli.main(["run", "bsw", "-pairs", str(inp)]) == 0
    cap = capsys.readouterr()
    assert len([ln for ln in cap.err.splitlines()
                if re.fullmatch(r"\[\d+\] score=\d+", ln)]) == 12
    assert cap.out.startswith("Number of input pairs: 12\n")
    assert re.search(r"Overall SW cycles = 0, \d+\.\d\d s", cap.out)
    assert "numCellsComputed = " in cap.out


def test_run_fmi(tmp_path, capsys):
    fa, fq = gen_case(tmp_path, np.random.default_rng(3), ref_len=3000,
                      n_reads=6)
    assert cli.main(["run", "fmi", str(fa), str(fq), "8", "19", "1"]) == 0
    out = capsys.readouterr().out
    assert "numReads = 6, max_readlength = 100, min_readlength = 100" in out
    assert re.search(r"^Computing time: \d+\.\d+(e-\d+)? s$", out, re.M)
    lines = smem_lines(out)
    assert lines and all(re.fullmatch(r"\d+:|\[\d+,\d+\]", ln)
                         for ln in lines)
    assert f"totalSmems = {sum(ln[0] == '[' for ln in lines)}" in out


def test_usage_errors(capsys):
    assert cli.main([]) == 0
    assert "run <kernel>" in capsys.readouterr().out
    assert cli.main(["run"]) == 1
    assert cli.main(["frobnicate"]) == 1


def test_module_entry_point(tmp_path):
    """`python -m genarchbench_tpu_torch.cli run bpm ...` as a user runs it."""
    inp, out = tmp_path / "pairs.txt", tmp_path / "out.txt"
    inp.write_text(gen_seqpair_dataset(np.random.default_rng(2), n_pairs=5,
                                       length=40))
    r = subprocess.run(
        [sys.executable, "-m", "genarchbench_tpu_torch.cli", "run", "bpm",
         "-i", str(inp), "-o", str(out)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**os.environ, "GENARCH_DEVICE": "cpu"},
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(out.read_text().splitlines()) == 5
