"""Job-scheduler runner: the port's copy of the JAX package's
harness/scheduler.py, the equivalent of the reference's
benchmarks/run_wrapper.sh (detect :118-124, job generation :190-250,
submit :258-272, poll + energy scrape :300-386, after_run :389-404,
PASS/FAIL report :410-460).

Where the reference sweeps (MPI ranks x OMP threads) per command, this
runner sweeps device counts: each `Job` carries a `devices` count (CUDA
cards, or CPU shards for a CPU job) and an optional `hosts` count
(multi-process `torch.distributed` runs).  Everything else keeps
run_wrapper's shape:

  * one stage directory per (command x parallelism) combination holding
    the generated job script, stdout/stderr, and the check verdict;
  * submission via sbatch / pjsub when a scheduler is present, plain
    bash otherwise (the reference's `job_scheduler=NONE` degradation);
  * polling until a terminal state, scraping the scheduler's energy
    counter (SLURM ConsumedEnergyRaw, PJM node-energy from the .stats
    file) or, locally, the RAPL sysfs energy delta when readable;
  * a per-job `after_run` callback executed inside the stage dir, and a
    final `nfailed/njobs` report.

What differs from JAX: a job script exports GENARCH_DEVICE (the torch
device type the job runs on) where JAX exported GENARCH_PLATFORM, and
no XLA_FLAGS: a mesh of n devices is n cards, or n CPU shards under
GENARCH_DEVICE=cpu, with nothing to virtualize.  It also exports its
stage directory (GENARCH_STAGE_DIR), where the regress runner leaves
the job's hand-kernel launch counts.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import shlex
import shutil
import signal
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

from genarchbench_tpu_torch.core.config import EnvConfig

SCHEDULERS = ("SLURM", "PJM", "NONE")


def detect_scheduler() -> str:
    """run_wrapper.sh:118-124: prefer the env override, else probe CLIs."""
    env = (EnvConfig.from_env().job_scheduler or "").upper()
    if env in SCHEDULERS:
        return env
    if shutil.which("sbatch"):
        return "SLURM"
    if shutil.which("pjsub"):
        return "PJM"
    return "NONE"


def _rapl_energy_uj() -> Optional[int]:
    """Sum of RAPL package counters, if the sysfs nodes are readable.
    Stands in for the reference's RAPL_STOPWATCH backend
    (chain/src/main.cpp:112-122)."""
    root = pathlib.Path("/sys/class/powercap")
    total = 0
    found = False
    if not root.is_dir():
        return None
    for node in root.glob("intel-rapl:*"):
        f = node / "energy_uj"
        try:
            total += int(f.read_text())
            found = True
        except (OSError, ValueError):
            continue
    return total if found else None


def read_energy_j(scheduler: str, job_id: Optional[str],
                  rapl_before: Optional[int],
                  stage_dir: Optional[pathlib.Path] = None) -> Optional[float]:
    """Scheduler energy scrape (run_wrapper.sh:354 SLURM ConsumedEnergy,
    :374 PJM stats file), with a local RAPL delta as the NONE fallback."""
    if scheduler == "SLURM" and job_id:
        try:
            out = subprocess.run(
                ["sacct", "-j", job_id, "--noheader", "-X", "-P",
                 "--format=ConsumedEnergyRaw"],
                capture_output=True, text=True, timeout=30).stdout.strip()
            return float(out.splitlines()[0]) if out else None
        except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
            return None
    if scheduler == "PJM" and stage_dir:
        # pjsub -s writes <name>.<jobid>.stats with a "NODE ENERGY" line
        for stats in stage_dir.glob("*.stats"):
            try:
                for line in stats.read_text().splitlines():
                    if "ENERGY" in line.upper():
                        return float(line.split(":")[-1].split()[0])
            except (OSError, ValueError):
                continue
        return None
    if rapl_before is not None:
        after = _rapl_energy_uj()
        if after is not None and after >= rapl_before:
            return (after - rapl_before) / 1e6
    return None


@dataclasses.dataclass
class Job:
    """One (command x parallelism) combination (run_wrapper.sh:160-250)."""
    name: str
    command: Sequence[str]              # argv to run
    devices: int = 1                    # CUDA cards, or CPU shards
    hosts: int = 1                      # torch.distributed process count
    device: str = ""                    # GENARCH_DEVICE: "cuda" or "cpu"
    env: Optional[Dict[str, str]] = None
    nodes: int = 1                      # scheduler nodes (multi-host)
    time_limit: str = "00:30:00"
    workdir: Optional[str] = None       # cwd for the command (default: stage)
    after_run: Optional[Callable[[pathlib.Path, "JobResult"], bool]] = None


@dataclasses.dataclass
class JobResult:
    job: Job
    state: str = "PENDING"   # COMPLETED | FAILED | SIGNALED | LAUNCH-FAILED
    exit_code: Optional[int] = None
    term_signal: Optional[int] = None
    wall_s: float = 0.0
    energy_j: Optional[float] = None
    check_ok: Optional[bool] = None
    stage_dir: Optional[pathlib.Path] = None
    scheduler_id: Optional[str] = None

    @property
    def ok(self) -> bool:
        return (self.state == "COMPLETED" and self.exit_code == 0
                and self.check_ok is not False)


def _job_script(job: Job, scheduler: str, stage: pathlib.Path) -> str:
    """Generate the per-job script run_wrapper.sh writes (:190-250).
    Exports the device topology instead of MPI_RANKS/OMP_NUM_THREADS."""
    lines = ["#!/bin/bash"]
    if scheduler == "SLURM":
        lines += [f"#SBATCH --job-name={job.name}",
                  f"#SBATCH --nodes={job.nodes}",
                  f"#SBATCH --ntasks={job.hosts}",
                  f"#SBATCH --time={job.time_limit}",
                  "#SBATCH --output=stdout.txt",
                  "#SBATCH --error=stderr.txt",
                  "#SBATCH --acctg-freq=energy=1"]
    elif scheduler == "PJM":
        lines += [f"#PJM --name {job.name}",
                  f"#PJM -L node={job.nodes}",
                  f"#PJM --mpi proc={job.hosts}",
                  f"#PJM -L elapse={job.time_limit}",
                  "#PJM -o stdout.txt", "#PJM -e stderr.txt", "#PJM -s"]
    lines += [f"export GENARCH_DEVICES={job.devices}",
              f"export GENARCH_HOSTS={job.hosts}",
              f"export GENARCH_STAGE_DIR={shlex.quote(str(stage))}"]
    if job.device:
        lines.append(f"export GENARCH_DEVICE={shlex.quote(job.device)}")
    for k, v in (job.env or {}).items():
        lines.append(f"export {k}={shlex.quote(v)}")
    lines.append(f"cd {shlex.quote(str(job.workdir or stage))}")
    lines.append(" ".join(shlex.quote(str(c)) for c in job.command))
    return "\n".join(lines) + "\n"


class JobRunner:
    """Submit, poll, check, and report a list of Jobs
    (run_wrapper.sh's main loop)."""

    def __init__(self, scheduler: Optional[str] = None,
                 work_dir: Optional[str] = None, quiet: bool = False):
        self.scheduler = scheduler or detect_scheduler()
        self.work_dir = pathlib.Path(
            work_dir or EnvConfig.from_env().job_dir
            or ".genarch_jobs").resolve()
        self.quiet = quiet
        self._live: List[str] = []   # outstanding scheduler job ids

    def _log(self, msg: str) -> None:
        if not self.quiet:
            print(msg, file=sys.stderr, flush=True)

    def run(self, jobs: Sequence[Job]) -> List[JobResult]:
        results = []
        try:
            for i, job in enumerate(jobs):
                results.append(self._run_one(job, i))
        except KeyboardInterrupt:
            self.cancel_all()          # run_wrapper.sh trap :137-152
            raise
        nfailed = sum(not r.ok for r in results)
        self._log(f"Failed jobs: {nfailed}/{len(results)}")
        return results

    def cancel_all(self) -> None:
        cancel = {"SLURM": "scancel", "PJM": "pjdel"}.get(self.scheduler)
        for jid in self._live:
            if cancel:
                subprocess.run([cancel, jid], capture_output=True)
        self._live.clear()

    def _run_one(self, job: Job, index: int) -> JobResult:
        stage = self.work_dir / f"{index:03d}_{job.name}_d{job.devices}"
        if stage.exists():
            shutil.rmtree(stage)
        stage.mkdir(parents=True)
        script = stage / "job.sh"
        script.write_text(_job_script(job, self.scheduler, stage))
        script.chmod(0o755)
        res = JobResult(job=job, stage_dir=stage)
        rapl0 = _rapl_energy_uj() if self.scheduler == "NONE" else None
        t0 = time.perf_counter()

        if self.scheduler == "NONE":
            limit = EnvConfig.from_env().regress_timeout_s
            with open(stage / "stdout.txt", "w") as so, \
                    open(stage / "stderr.txt", "w") as se:
                try:
                    proc = subprocess.run(["bash", str(script)],
                                          stdout=so, stderr=se,
                                          timeout=limit)
                except OSError as e:
                    res.state = "LAUNCH-FAILED"
                    self._log(f"[{job.name}] LAUNCH-FAILED: {e}")
                    return res
                except subprocess.TimeoutExpired:
                    res.state = "SIGNALED"
                    res.term_signal = signal.SIGKILL
                    res.wall_s = time.perf_counter() - t0
                    self._log(f"[{job.name}] TIMEOUT after {limit:.0f}s")
                    return res
            res.exit_code = proc.returncode
            if proc.returncode < 0:
                res.state = "SIGNALED"
                res.term_signal = -proc.returncode
            else:
                res.state = "COMPLETED" if proc.returncode == 0 else "FAILED"
        else:
            jid = self._submit(script, stage)
            if jid is None:
                res.state = "LAUNCH-FAILED"
                return res
            res.scheduler_id = jid
            self._live.append(jid)
            res.state, res.exit_code, res.term_signal = self._poll(jid)
            self._live.remove(jid)

        res.wall_s = time.perf_counter() - t0
        res.energy_j = read_energy_j(self.scheduler, res.scheduler_id,
                                     rapl0, stage)
        if job.after_run is not None and res.state == "COMPLETED":
            cwd = os.getcwd()
            try:
                os.chdir(stage)            # run_wrapper.sh:389-404 semantics
                res.check_ok = bool(job.after_run(stage, res))
            finally:
                os.chdir(cwd)
        verdict = ("PASS" if res.ok else
                   f"FAIL ({res.state}"
                   f"{'' if res.term_signal is None else f' sig {res.term_signal}'}"
                   f"{'' if res.check_ok is not False else ' check failed'})")
        energy = (f" energy={res.energy_j:.1f}J"
                  if res.energy_j is not None else "")
        self._log(f"[{job.name} devices={job.devices} hosts={job.hosts}] "
                  f"{verdict} wall={res.wall_s:.2f}s{energy}")
        return res

    def _submit(self, script: pathlib.Path, stage: pathlib.Path) -> Optional[str]:
        if self.scheduler == "SLURM":
            out = subprocess.run(["sbatch", "--parsable", str(script)],
                                 capture_output=True, text=True, cwd=stage)
            return out.stdout.strip().split(";")[0] if out.returncode == 0 else None
        out = subprocess.run(["pjsub", str(script)],
                             capture_output=True, text=True, cwd=stage)
        if out.returncode != 0:
            return None
        for tok in out.stdout.split():    # "Job <id> submitted"
            if tok.isdigit():
                return tok
        return None

    def _poll(self, jid: str, interval: float = 5.0):
        """Poll sacct/pjstat until a terminal state (run_wrapper.sh:300-386)."""
        while True:
            time.sleep(interval)
            if self.scheduler == "SLURM":
                out = subprocess.run(
                    ["sacct", "-j", jid, "--noheader", "-X", "-P",
                     "--format=State,ExitCode"],
                    capture_output=True, text=True).stdout.strip()
                if not out:
                    continue
                state, exit_field = (out.splitlines()[0].split("|") + [""])[:2]
                state = state.split()[0] if state else ""
                if state in ("PENDING", "RUNNING", "REQUEUED", ""):
                    continue
                code, sig = (exit_field.split(":") + ["0"])[:2]
                if state == "COMPLETED":
                    return "COMPLETED", int(code or 0), None
                if int(sig or 0):
                    return "SIGNALED", None, int(sig)
                return "FAILED", int(code or 1), None
            out = subprocess.run(["pjstat", "--choose", "st", jid],
                                 capture_output=True, text=True).stdout
            if "END" in out or "ERR" in out or not out.strip():
                state = "COMPLETED" if "END" in out else "FAILED"
                return state, 0 if state == "COMPLETED" else 1, None
