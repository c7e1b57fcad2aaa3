"""Umbrella CLI of the PyTorch/CUDA port.

    python -m genarchbench_tpu_torch.cli list
    python -m genarchbench_tpu_torch.cli run <kernel> [kernel args...]
    python -m genarchbench_tpu_torch.cli regress <kernel> --cmd "<args>" \
        [--golden ref.txt] [--source stdout|stderr|file:<name>] \
        [--devices 1,2,8] [--platform gpu|cpu] [--check exact|sorted|...]
    python -m genarchbench_tpu_torch.cli regress {small,large} \
        [--kernels a,b] [--devices 1,2,8] [--platform gpu|cpu]

`run` dispatches to the kernel's own reference-compatible CLI (see the
registry, core/registry.py).  Kernels run on the CUDA card; set
GENARCH_DEVICE=cpu to run their plain PyTorch versions on the CPU.

`regress` re-runs the kernel at each device count (the reference's
1/2/4-OMP-thread sweep, SURVEY.md §4.5: run_wrapper.sh submits each
command x parallelism combination) as one job of the scheduler harness
(harness/scheduler.py), applies the kernel's golden check rule, and
prints each job's wall time, timing line and hand-kernel launches, a
scaling line (items/s, speed-up and efficiency against the fewest
devices) and run_wrapper's PASS/FAIL report.  A job runs on the
platform named: `gpu` (the default) on as many cards as its device
count, failing on a host that has fewer; `cpu` on that many CPU shards,
the determinism sweep `--platform cpu --devices 1,2,8`.  `regress {small,large}` sweeps every
kernel's dataset binding under GENARCH_BENCH_INPUTS_ROOT
(harness/dataset_regress.py); without it every kernel is a SKIP.
"""

from __future__ import annotations

import os
import re
import sys
from typing import List, Optional

from genarchbench_tpu_torch.core.check import (check_exact, check_scalar,
                                               check_sorted,
                                               check_tolerant_columns)
from genarchbench_tpu_torch.core.registry import (get_kernel, list_kernels,
                                                  load_runner)


def cmd_list() -> int:
    for spec in list_kernels():
        print(f"{spec.name:12s} {spec.check_rule:14s} {spec.description}")
    return 0


def cmd_run(name: str, args: List[str]) -> int:
    return load_runner(name)(args) or 0


# a job's program: the kernel's runner from the port alone; after it,
# the job's launches of each hand kernel go to its stage directory
_RUNNER_CODE = (
    "import sys, os\n"
    "sys.path.insert(0, os.environ.get('GENARCH_REPO', '.'))\n"
    "from genarchbench_tpu_torch.core.registry import load_runner\n"
    "from genarchbench_tpu_torch.kernels import bpm_cuda, bsw_cuda\n"
    "rc = load_runner(sys.argv[1])(sys.argv[2:]) or 0\n"
    "with open(os.path.join(os.environ['GENARCH_STAGE_DIR'],"
    " 'launches.txt'), 'w') as f:\n"
    "    f.write(f'bpm={bpm_cuda.LAUNCHES} bsw={bsw_cuda.LAUNCHES}')\n"
    "sys.exit(rc)\n")

PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}     # --platform -> GENARCH_DEVICE


def cmd_regress(name: str, cmd_args: List[str], golden: Optional[str],
                devices: List[int], platform: str,
                check_rule: Optional[str],
                scheduler: Optional[str] = "NONE",
                source: str = "stdout",
                line_filter=None) -> int:
    """Device-count sweep through the scheduler harness (the reference's
    regression_small.sh x run_wrapper.sh pair: each device count is one
    generated job, checked against the golden in its stage dir).

    `platform` ("gpu" or "cpu") is the device every job runs on.
    `source` selects where the kernel's comparable output lands
    ("stdout", "stderr", or "file:<name>" relative to the stage dir —
    args may use the {out} placeholder for that dir); `line_filter`
    pre-filters both sides like the reference's sed/grep after_run
    steps, by default the kernel's own `output_lines`."""
    from genarchbench_tpu_torch.harness.scheduler import Job, JobRunner

    if platform not in PLATFORMS:
        raise ValueError(f"platform {platform!r}; try {sorted(PLATFORMS)}")
    spec = get_kernel(name)
    rule = check_rule or spec.check_rule
    line_filter = line_filter or spec.output_lines
    golden_lines = None
    if golden:
        with open(golden) as f:
            golden_lines = f.read().splitlines()
        if line_filter:
            golden_lines = line_filter(golden_lines)

    in_stage = any("{out}" in a for a in cmd_args)
    cmd_args = [a.replace("{out}", ".") for a in cmd_args]

    def read_source(stage):
        fname = {"stdout": "stdout.txt", "stderr": "stderr.txt"}.get(
            source, source.split(":", 1)[-1])
        path = stage / fname
        if not path.exists():
            return None
        lines = path.read_text().splitlines()
        return line_filter(lines) if line_filter else lines

    def check(stage, res):
        if golden_lines is None:
            return True
        out_lines = read_source(stage)
        if out_lines is None:
            print(f"[{name} devices={res.job.devices}] CHECK FAIL "
                  f"(no output {source})")
            return False
        v = _apply_rule(rule, out_lines, golden_lines)
        if not v:
            print(f"[{name} devices={res.job.devices}] CHECK FAIL "
                  f"({v.detail})")
        return bool(v)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jobs = [Job(name=name,
                command=[sys.executable, "-c", _RUNNER_CODE, name, *cmd_args],
                devices=nd, device=PLATFORMS[platform],
                env={"GENARCH_REPO": repo},
                workdir=None if in_stage else os.getcwd(),
                after_run=check)
            for nd in devices]
    runner = JobRunner(scheduler=scheduler)
    results = runner.run(jobs)

    nfailed = sum(not r.ok for r in results)
    njobs = len(results)
    outputs = {}
    kernel_s, items_n = {}, {}
    for nd, r in zip(devices, results):
        alltext = ""
        if r.stage_dir:
            src = read_source(r.stage_dir)
            if src is not None:
                # timing lines legitimately differ per device count;
                # the determinism check below compares results only
                outputs[nd] = [ln for ln in src
                               if not ln.startswith(spec.timing_line)]
            alltext = "\n".join(
                (r.stage_dir / f).read_text()
                for f in ("stderr.txt", "stdout.txt")
                if (r.stage_dir / f).exists())
        # the timing line anywhere in a line (bpm's begins "=> "); the
        # time as the spec reads it (`KernelSpec.read_time`)
        timing = next((ln for ln in alltext.splitlines()
                       if spec.timing_line in ln), "").strip()
        t = spec.read_time(alltext)
        if t is not None:
            kernel_s[nd] = t
        if spec.items_re:
            mi = re.search(spec.items_re, alltext)
            if mi:
                items_n[nd] = int(mi.group(1))
        launches = (r.stage_dir / "launches.txt") if r.stage_dir else None
        launches = (f" launches {launches.read_text()}"
                    if launches and launches.exists() else "")
        print(f"[{name} devices={nd}] "
              f"{'OK' if r.ok else r.state} wall={r.wall_s:.2f}s "
              f"{timing}{launches}")

    # scaling table: throughput per device count + parallel efficiency
    # (the reference's analogue is the per-thread-count timing lines its
    # regressions collect, chain/scripts/regression_small.sh:87-105)
    if kernel_s:
        base_nd = min(kernel_s)
        base_t = kernel_s[base_nd]
        cols = []
        for nd in sorted(kernel_s):
            t = kernel_s[nd]
            cell = f"{nd}dev {t:.3f}s"
            if nd in items_n and t > 0:
                cell += f" {items_n[nd] / t:,.0f} {spec.items_unit}/s"
            if nd != base_nd and t > 0:
                sp = base_t / t
                cell += (f" ({sp:.2f}x, eff "
                         f"{100 * sp * base_nd / nd:.0f}%)")
            cols.append(cell)
        print(f"[{name}] scaling: " + " | ".join(cols))

    # determinism across device counts (the reference's thread sweep
    # doubles as this check)
    if len(devices) > 1 and all(nd in outputs for nd in devices):
        base = outputs[devices[0]]
        for nd in devices[1:]:
            res = _apply_rule(rule if rule != "scalar" else "sorted",
                              outputs[nd], base)
            if not res:
                nfailed += 1
                print(f"[{name}] NON-DETERMINISTIC across device counts "
                      f"({devices[0]} vs {nd}): {res.detail}")

    print(f"Failed jobs: {nfailed}/{njobs}")
    return 1 if nfailed else 0


def _apply_rule(rule: str, out_lines, ref_lines):
    if rule == "exact":
        return check_exact(out_lines, ref_lines)
    if rule == "sorted":
        return check_sorted(out_lines, ref_lines)
    if rule == "tolerant_abea":
        return check_tolerant_columns(out_lines, ref_lines)
    if rule == "scalar":
        pat = re.compile(r"Total k-mers (\d+)")
        a = next((pat.search(x) for x in out_lines if pat.search(x)), None)
        b = next((pat.search(x) for x in ref_lines if pat.search(x)), None)
        return check_scalar(a and int(a.group(1)), b and int(b.group(1)))
    raise ValueError(f"unknown rule {rule}")


def _scheduler(arg: str) -> Optional[str]:
    return None if arg == "auto" else arg


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import shlex
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv.pop(0)
    if cmd == "list":
        return cmd_list()
    if cmd == "run":
        if not argv:
            print("usage: run <kernel> [args...]", file=sys.stderr)
            return 1
        return cmd_run(argv[0], argv[1:])
    if cmd == "regress" and argv and argv[0] in ("small", "large"):
        p = argparse.ArgumentParser(prog="genarch regress {small,large}")
        p.add_argument("size", choices=["small", "large"])
        p.add_argument("--kernels", default=None,
                       help="comma-separated subset (default: all)")
        p.add_argument("--devices", default="1,2,8")
        p.add_argument("--platform", default="gpu", choices=sorted(PLATFORMS))
        p.add_argument("--scheduler", default="NONE",
                       choices=["auto", "NONE", "SLURM", "PJM"])
        a = p.parse_args(argv)
        from genarchbench_tpu_torch.harness.dataset_regress import run_sweep
        return run_sweep(a.size,
                         a.kernels.split(",") if a.kernels else None,
                         [int(x) for x in a.devices.split(",")],
                         a.platform, scheduler=_scheduler(a.scheduler))
    if cmd == "regress":
        p = argparse.ArgumentParser(prog="genarch regress")
        p.add_argument("kernel")
        p.add_argument("--cmd", required=True,
                       help="kernel CLI arguments (one quoted string)")
        p.add_argument("--golden", default=None)
        p.add_argument("--source", default="stdout",
                       help="stdout, stderr or file:<name> in the stage dir")
        p.add_argument("--devices", default="1,2,8")
        p.add_argument("--platform", default="gpu", choices=sorted(PLATFORMS))
        p.add_argument("--check", default=None)
        p.add_argument("--scheduler", default="NONE",
                       choices=["auto", "NONE", "SLURM", "PJM"],
                       help="job scheduler (auto = detect, like "
                            "run_wrapper.sh)")
        a = p.parse_args(argv)
        return cmd_regress(a.kernel, shlex.split(a.cmd), a.golden,
                           [int(x) for x in a.devices.split(",")],
                           a.platform, a.check,
                           scheduler=_scheduler(a.scheduler),
                           source=a.source)
    print(f"unknown command {cmd!r}; try list|run|regress", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
