"""The PyTorch port's umbrella CLI, on the CPU (GENARCH_DEVICE=cpu)."""

import ast
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

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
                                                ["dbg", "sorted"],
                                                ["fast-chain", "exact"],
                                                ["fmi", "exact"],
                                                ["kmer-cnt", "scalar"],
                                                ["nn-base", "exact"],
                                                ["nn-variant", "sorted"],
                                                ["pileup", "exact"],
                                                ["poa", "exact"],
                                                ["wfa", "sorted"]]
    assert [s.name for s in list_kernels()] == ["abea", "bpm", "bsw",
                                                "chain", "dbg", "fast-chain",
                                                "fmi", "kmer-cnt", "nn-base",
                                                "nn-variant", "pileup", "poa",
                                                "wfa"]
    assert get_kernel("bsw").timing_line == "Overall SW cycles"
    assert get_kernel("wfa").timing_line == "Time.Alignment:"
    assert get_kernel("nn-base").timing_line == "> samples per second"
    assert get_kernel("chain").timing_line == "Time in kernel:"
    assert get_kernel("fast-chain").timing_line == "Time in kernel:"
    assert get_kernel("fmi").timing_line == "Computing time:"
    assert get_kernel("abea").timing_line == "Data processing time:"
    assert get_kernel("poa").timing_line == "Runtime:"
    assert get_kernel("kmer-cnt").timing_line == "Kernel time:"
    assert get_kernel("dbg").timing_line == "Kernel runtime:"
    assert get_kernel("pileup").timing_line == "Kernel runtime:"
    assert get_kernel("nn-variant").timing_line == \
        "VariantCalling execution time:"
    assert get_kernel("nn-variant").check_rule == "sorted"
    with pytest.raises(KeyError, match="unknown kernel"):
        get_kernel("nn-varient")


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


# ---------------------------------------------------------------------------
# regress: the device-count sweep through the scheduler harness
# ---------------------------------------------------------------------------

@pytest.fixture
def job_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("GENARCH_JOB_DIR", str(tmp_path / "jobs"))
    return tmp_path / "jobs"


def test_regress_sweep_and_golden(tmp_path, job_dir, capsys):
    """`--platform cpu --devices 1,2,8`: every job's output file held to
    the golden by bpm's sorted rule, and the three runs to each other."""
    inp = tmp_path / "pairs.txt"
    inp.write_text(gen_seqpair_dataset(np.random.default_rng(1), n_pairs=12,
                                       length=50, error_rate=0.1))
    golden = tmp_path / "golden.txt"
    assert cli.main(["run", "bpm", "-i", str(inp), "-o", str(golden)]) == 0
    rc = cli.main(["regress", "bpm", "--cmd", f"-i {inp} -o {{out}}/out.txt",
                   "--golden", str(golden), "--source", "file:out.txt",
                   "--devices", "1,2,8", "--platform", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Failed jobs: 0/3" in out
    for nd in (1, 2, 8):
        # the CPU shards take the plain version: no hand-kernel launch
        assert re.search(rf"^\[bpm devices={nd}\] OK wall=\d+\.\d\ds "
                         r"=> Time.Benchmark +\d+\.\d\d s "
                         r"launches bpm=0 bsw=0$", out, re.M)
        stage = next(job_dir.glob(f"*_bpm_d{nd}"))
        script = (stage / "job.sh").read_text()
        assert f"export GENARCH_DEVICES={nd}" in script
        assert "export GENARCH_DEVICE=cpu" in script
        assert "XLA_FLAGS" not in script
        assert f"export GENARCH_STAGE_DIR={stage}" in script
    assert re.search(r"^\[bpm\] scaling: 1dev \d+\.\d{3}s \| 2dev .*x, eff "
                     r".*\| 8dev ", out, re.M)


def test_regress_bsw_compares_its_score_lines(tmp_path, job_dir, capsys):
    """`regress bsw --source stderr` from the command line: the registry's
    output_lines keep the `score=` lines of both sides, so no other
    stderr line (a library's warning) is held to the golden."""
    inp = tmp_path / "pairs.txt"
    inp.write_text(gen_bsw_input(np.random.default_rng(5), n_pairs=20))
    assert cli.main(["run", "bsw", "-pairs", str(inp)]) == 0
    run = capsys.readouterr()
    assert "Overall SW cycles" in run.out
    err = run.err
    assert err.count("score=") == 20
    golden = tmp_path / "golden.err"
    golden.write_text("UserWarning: a line no run writes\n" + err)
    rc = cli.main(["regress", "bsw", "--cmd", f"-pairs {inp}",
                   "--golden", str(golden), "--source", "stderr",
                   "--devices", "1,2", "--platform", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "Failed jobs: 0/2" in out
    assert get_kernel("bsw").output_lines(
        ["[0] score=3", "Overall SW cycles = 0, 1.0 s", "warn"]) == \
        ["[0] score=3"]
    golden.write_text(err.replace("score=", "score=1", 1))
    rc = cli.main(["regress", "bsw", "--cmd", f"-pairs {inp}",
                   "--golden", str(golden), "--source", "stderr",
                   "--devices", "1", "--platform", "cpu"])
    assert rc == 1 and "CHECK FAIL" in capsys.readouterr().out


def test_regress_runner_code_names_only_the_port():
    code = cli._RUNNER_CODE
    assert "genarchbench_tpu_torch" in code
    assert "jax" not in code
    assert "genarchbench_tpu." not in code.replace(
        "genarchbench_tpu_torch.", "")


def test_regress_scaling_table(tmp_path, job_dir, capsys):
    """The sweep emits the scaling artifact: items/s per device count and
    parallel efficiency (wfa's items are its `Total.reads` pairs)."""
    inp = tmp_path / "pairs.txt"
    inp.write_text(gen_seqpair_dataset(np.random.default_rng(3), n_pairs=12,
                                       length=50, error_rate=0.1))
    rc = cli.cmd_regress("wfa", ["-i", str(inp), "-o",
                                 str(tmp_path / "o.txt")],
                         golden=None, devices=[1, 2], platform="cpu",
                         check_rule=None)
    out = capsys.readouterr().out
    assert rc == 0
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[wfa] scaling:"))
    assert "1dev" in line and "2dev" in line
    assert "pairs/s" in line and "eff" in line
    assert get_kernel("wfa").items_re and get_kernel("fmi").items_unit == \
        "reads"


def roi_format(module: str) -> str:
    """The timing-line format string of the module's `ROITimer(...)`."""
    path = pathlib.Path(importlib.util.find_spec(module).origin)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == \
                "ROITimer":
            return node.args[1].value
    raise LookupError(f"no ROITimer in {path}")


@pytest.mark.parametrize("name", [s.name for s in list_kernels()])
def test_regress_reads_each_kernels_time(name):
    """The time `regress` reads from the output each kernel's `run`
    prints, its timing line formatted from its own ROITimer format at
    t = 1.5 s among other numbered lines (nn-base prints no ROITimer
    line: `nn/basecall.py::run` writes the duration and the rate).  poa's
    line ends in 0.000 and nn-base's timing line is a rate, so a rule
    that took the last number, or the rate, would not read 1.5."""
    spec = get_kernel(name)
    if name == "nn-base":
        lines = ["> duration: 1.5s", "> samples per second 4.0E+04"]
    else:
        lines = [roi_format(spec.module).format(t=1.5)]
    text = "\n".join(["Number of input pairs: 12", *lines,
                      "numCellsComputed = 77"])
    assert spec.timing_line in text
    assert spec.read_time(text) == 1.5
    assert spec.read_time("no timing line here 3.0") is None


def test_regress_detects_mismatch(tmp_path, job_dir, capsys):
    inp = tmp_path / "pairs.txt"
    inp.write_text(gen_seqpair_dataset(np.random.default_rng(2), n_pairs=6,
                                       length=40, error_rate=0.1))
    golden = tmp_path / "bad_golden.txt"
    golden.write_text("this is wrong\n")
    rc = cli.cmd_regress("bpm", ["-i", str(inp), "-o", "{out}/o.txt"],
                         golden=str(golden), devices=[1], platform="cpu",
                         check_rule="exact", source="file:o.txt")
    assert rc == 1
    out = capsys.readouterr().out
    assert "CHECK FAIL" in out and "Failed jobs: 1/1" in out


def test_regress_gpu_job_without_cards_fails(tmp_path, job_dir, capsys):
    """`--platform gpu` on a host without enough cards: the job asks for
    them, fails with data_mesh's message and counts as failed; nothing
    falls back to the CPU."""
    inp = tmp_path / "pairs.txt"
    inp.write_text(gen_seqpair_dataset(np.random.default_rng(4), n_pairs=4,
                                       length=40))
    n = torch.cuda.device_count()
    rc = cli.cmd_regress("bpm", ["-i", str(inp)], golden=None,
                         devices=[n + 1], platform="gpu", check_rule=None)
    assert rc == 1
    assert "Failed jobs: 1/1" in capsys.readouterr().out
    stage = next(job_dir.glob(f"*_bpm_d{n + 1}"))
    assert "export GENARCH_DEVICE=cuda" in (stage / "job.sh").read_text()
    err = (stage / "stderr.txt").read_text()
    assert ("more cards than this host has" in err
            or "no CUDA card" in err), err[-500:]
    with pytest.raises(ValueError, match="platform 'tpu'"):
        cli.cmd_regress("bpm", ["-i", str(inp)], golden=None, devices=[1],
                        platform="tpu", check_rule=None)


def test_regress_small_without_dataset_skips(monkeypatch, job_dir, capsys):
    monkeypatch.delenv("GENARCH_BENCH_INPUTS_ROOT", raising=False)
    assert cli.main(["regress", "small", "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = [ln.split() for ln in out.splitlines() if "SKIP" in ln]
    assert sorted(r[0] for r in rows) == [s.name for s in list_kernels()]
    assert "0 passed, 0 failed, 13 skipped (of 13)" in out
    assert not job_dir.exists()
