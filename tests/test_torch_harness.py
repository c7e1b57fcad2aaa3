"""The port's job-scheduler runner and typed configuration, on the CPU:
the twins of tests/test_harness.py and tests/test_config.py.  A job
script exports GENARCH_DEVICE where the JAX package's exported
GENARCH_PLATFORM, and no XLA_FLAGS."""

import os

from genarchbench_tpu_torch.core.config import EnvConfig, load_kv_config
from genarchbench_tpu_torch.harness import dataset_regress
from genarchbench_tpu_torch.harness.scheduler import (
    Job, JobRunner, _job_script, detect_scheduler, read_energy_j)


def test_detect_scheduler_env_override(monkeypatch):
    monkeypatch.setenv("GENARCH_JOB_SCHEDULER", "PJM")
    assert detect_scheduler() == "PJM"
    monkeypatch.setenv("GENARCH_JOB_SCHEDULER", "NONE")
    assert detect_scheduler() == "NONE"


def test_job_script_slurm(tmp_path):
    job = Job(name="chain", command=["python", "-m", "x"], devices=4,
              hosts=2, nodes=2, device="cpu", env={"FOO": "a b"})
    script = _job_script(job, "SLURM", tmp_path)
    assert "#SBATCH --nodes=2" in script
    assert "#SBATCH --ntasks=2" in script
    assert "export GENARCH_DEVICES=4" in script
    assert "export GENARCH_HOSTS=2" in script
    assert "export GENARCH_DEVICE=cpu" in script
    assert "XLA_FLAGS" not in script and "GENARCH_PLATFORM" not in script
    assert "export FOO='a b'" in script
    assert script.rstrip().endswith("python -m x")


def test_job_script_pjm(tmp_path):
    job = Job(name="bsw", command=["true"], devices=1, device="cuda")
    script = _job_script(job, "PJM", tmp_path)
    assert "#PJM -L node=1" in script
    assert "#PJM -s" in script          # stats file => energy scrape
    assert "export GENARCH_DEVICE=cuda" in script
    assert "XLA_FLAGS" not in script
    # no device named: the job inherits GENARCH_DEVICE (the card default)
    bare = _job_script(Job(name="b", command=["true"]), "PJM", tmp_path)
    assert "GENARCH_DEVICE=" not in bare


def test_local_run_pass_fail_report(tmp_path, capsys):
    runner = JobRunner(scheduler="NONE", work_dir=str(tmp_path / "jobs"))
    seen = {}

    def check_ok(stage, res):
        seen["stdout"] = (stage / "stdout.txt").read_text()
        return True

    jobs = [
        Job(name="good", command=["echo", "hello"], after_run=check_ok),
        Job(name="bad", command=["bash", "-c", "exit 3"]),
    ]
    results = runner.run(jobs)
    assert results[0].ok and results[0].state == "COMPLETED"
    assert seen["stdout"].strip() == "hello"
    assert not results[1].ok and results[1].exit_code == 3
    err = capsys.readouterr().err
    assert "Failed jobs: 1/2" in err


def test_local_run_failed_check(tmp_path):
    runner = JobRunner(scheduler="NONE", work_dir=str(tmp_path / "jobs"),
                       quiet=True)
    job = Job(name="c", command=["echo", "x"], after_run=lambda s, r: False)
    res = runner.run([job])[0]
    assert res.state == "COMPLETED" and res.check_ok is False and not res.ok


def test_local_run_cwd_and_env(tmp_path):
    runner = JobRunner(scheduler="NONE", work_dir=str(tmp_path / "jobs"),
                       quiet=True)
    wd = tmp_path / "wd"
    wd.mkdir()
    job = Job(name="envtest",
              command=["bash", "-c",
                       "pwd; echo $GENARCH_DEVICES $GENARCH_DEVICE $MYVAR"],
              devices=2, device="cpu", workdir=str(wd),
              env={"MYVAR": "zz"})
    res = runner.run([job])[0]
    out = (res.stage_dir / "stdout.txt").read_text().split()
    assert out == [str(wd), "2", "cpu", "zz"]


def test_local_timeout(tmp_path, monkeypatch):
    monkeypatch.setenv("GENARCH_REGRESS_TIMEOUT", "1")
    runner = JobRunner(scheduler="NONE", work_dir=str(tmp_path / "jobs"),
                       quiet=True)
    res = runner.run([Job(name="slow", command=["sleep", "30"])])[0]
    assert res.state == "SIGNALED" and not res.ok


def test_read_energy_local_rapl_monotonic():
    # With no RAPL sysfs (containers), returns None; with one, a delta >= 0.
    e = read_energy_j("NONE", None, rapl_before=0)
    assert e is None or e >= 0


def test_regress_via_harness(tmp_path, monkeypatch):
    """End-to-end: cli.cmd_regress submits through the JobRunner."""
    import numpy as np
    from genarchbench_tpu_torch import cli
    from tests.synth import gen_seqpair_dataset

    rng = np.random.default_rng(5)
    inp = tmp_path / "pairs.txt"
    inp.write_text(gen_seqpair_dataset(rng, n_pairs=6, length=40,
                                       error_rate=0.1))
    monkeypatch.setenv("GENARCH_JOB_DIR", str(tmp_path / "jobs"))
    rc = cli.cmd_regress("bpm", ["-i", str(inp)], golden=None,
                         devices=[1], platform="cpu", check_rule=None)
    assert rc == 0


def test_dataset_table_binds_every_kernel():
    from genarchbench_tpu_torch.core.registry import list_kernels
    for size in ("small", "large"):
        rows = dataset_regress.table(size)
        assert sorted(r.kernel for r in rows) == sorted(
            s.name for s in list_kernels())
        args, golden, inputs = dataset_regress.resolve(rows[0], "/data",
                                                       "/stage")
        assert all(p.startswith("/data/") for p in inputs)
        assert "/stage/out.txt" in args
    lines = ["#h", "c\t5\t.\tA\tG\t30\tPASS\tX\tGT\t0/1",
             "c\t5\t.\tA\tG\t31\tPASS\tX\tGT\t0/1"]
    assert dataset_regress._vcf_body_cut(lines) == [
        "c\t5\t.\tA\tG\tPASS\tX\tGT"]


def test_env_config_defaults_and_parse():
    cfg = EnvConfig.from_env({})
    assert cfg.devices == 1 and cfg.inputs_root is None
    assert cfg.device is None
    cfg = EnvConfig.from_env({
        "GENARCH_BENCH_INPUTS_ROOT": "/data",
        "GENARCH_DEVICE": "cpu",
        "GENARCH_DEVICES": "8",
        "GENARCH_HOSTS": "2",
        "GENARCH_REGRESS_TIMEOUT": "60.5",
    })
    assert cfg.inputs_root == "/data" and cfg.device == "cpu"
    assert cfg.devices == 8 and cfg.hosts == 2
    assert cfg.regress_timeout_s == 60.5
    assert cfg.coordinator is None and cfg.process_id is None
    cfg = EnvConfig.from_env({"GENARCH_COORDINATOR": "host:1234",
                              "GENARCH_PROCESS_ID": "3"})
    assert cfg.coordinator == "host:1234" and cfg.process_id == 3
    # malformed ints fall back to defaults
    cfg = EnvConfig.from_env({"GENARCH_DEVICES": "lots",
                              "GENARCH_PROCESS_ID": "x"})
    assert cfg.devices == 1 and cfg.process_id is None
    assert EnvConfig.from_env().devices == max(1, int(
        os.environ.get("GENARCH_DEVICES", "1") or 1))


def test_env_config_is_the_reader(monkeypatch, tmp_path):
    """The device resolver, the mesh, the job harness and the ROI timer
    take the environment through EnvConfig."""
    from genarchbench_tpu_torch.core.backend import resolve_device
    from genarchbench_tpu_torch.core.roi import ROITimer
    from genarchbench_tpu_torch.sharding.mesh import devices_from_env
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    monkeypatch.setenv("GENARCH_DEVICES", "3")
    monkeypatch.setenv("GENARCH_JOB_DIR", str(tmp_path / "jobs"))
    monkeypatch.setenv("GENARCH_TRACE_DIR", str(tmp_path / "traces"))
    monkeypatch.setenv("GENARCH_REGRESS_TIMEOUT", "0.5")
    assert EnvConfig.from_env().device == "cpu"
    assert resolve_device().type == "cpu"
    assert devices_from_env() == 3
    assert JobRunner(scheduler="NONE").work_dir == tmp_path / "jobs"
    assert ROITimer("x").trace_dir == str(tmp_path / "traces")
    res = JobRunner(scheduler="NONE", quiet=True).run(
        [Job(name="sleep", command=["sleep", "5"], device="cpu")])[0]
    assert res.state == "SIGNALED" and res.wall_s < 5


def test_load_kv_config_include_and_comments(tmp_path):
    (tmp_path / "base.cfg").write_text(
        "kmer_size = 15\nshared = base\n")
    (tmp_path / "main.cfg").write_text(
        "# a comment\n"
        "%include base.cfg\n"
        "use_minimizers = 0   # trailing comment\n"
        "shared = main\n")
    cfg = load_kv_config(str(tmp_path / "main.cfg"))
    assert cfg["kmer_size"] == "15"
    assert cfg["use_minimizers"] == "0"
    assert cfg["shared"] == "main"        # later keys win


def test_kmer_parse_config_delegates(tmp_path):
    from genarchbench_tpu_torch.kernels.kmer import parse_config
    (tmp_path / "c.cfg").write_text("kmer_size=17\n")
    assert parse_config(str(tmp_path / "c.cfg"))["kmer_size"] == "17"
