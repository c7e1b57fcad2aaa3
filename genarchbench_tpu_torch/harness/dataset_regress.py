"""Dataset-bound regression entry points: `genarch regress {small,large}`,
the port's copy of the JAX package's harness/dataset_regress.py.

The reference suite binds each kernel's regression to fixed inputs and
golden outputs under $GENARCH_BENCH_INPUTS_ROOT (each benchmark's
scripts/regression_{small,large}.sh resolves `inputs_path=` under that
root and `after_run` diffs against the bundled reference file, e.g.
chain/scripts/regression_small.sh:87-105).  This module encodes that
whole table — input arguments, golden path, and the kernel's tolerance
rule — so ONE command sweeps every kernel across device counts and
prints the reference-shaped PASS/FAIL report.

Kernels whose dataset inputs are absent under the root are reported as
SKIP (the ~90 GB dataset is distributed separately, README.md:7-25).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Callable, List, Optional, Sequence

from genarchbench_tpu_torch.core.config import EnvConfig

REPO = pathlib.Path(__file__).resolve().parent.parent.parent


@dataclasses.dataclass
class DatasetReg:
    """One kernel x size regression binding (mirrors the reference's
    scripts/regression_{small,large}.sh variables)."""
    kernel: str
    args: List[str]              # {root} -> inputs root, {out} -> stage dir
    golden: Optional[str]        # golden path template (None: no check)
    rule: str                    # exact | sorted | tolerant_abea | scalar
    source: str = "stdout"       # stdout | stderr | file:<name>
    filter: Optional[Callable[[List[str]], List[str]]] = None
    inputs: Sequence[str] = ()   # existence-checked paths (beyond args)


def _fmi_skip6(lines: List[str]) -> List[str]:
    return lines[6:]             # sed -n 7~1p (fmi regression)


def _poa_strip_ticks(lines: List[str]) -> List[str]:
    return [ln for ln in lines
            if "workTicks" not in ln and "avgTicks" not in ln]


def _vcf_body_cut(lines: List[str]) -> List[str]:
    """nn-variant after_run: drop headers, keep fields 1-5,7-9,
    dedupe (diff of `grep -v ^# | sort -u -k2,2n | cut -f1-5,7-9`)."""
    out = []
    seen = set()
    for ln in lines:
        if ln.startswith("#") or not ln.strip():
            continue
        f = ln.split("\t")
        key = "\t".join(f[:5] + f[6:9])
        if key not in seen:
            seen.add(key)
            out.append(key)
    return out


def table(size: str) -> List[DatasetReg]:
    """The per-kernel binding table for `small` or `large` (source
    regression scripts cited per row)."""
    small = size == "small"
    chain_in = ("{root}/chain/small/in-1k.txt" if small
                else "{root}/chain/large/c_elegans_40x.10k.in")
    rows = [
        # chain/scripts/regression_{small,large}.sh
        DatasetReg("chain",
                   ["-i", chain_in, "-o", "{out}/out.txt", "-t", "1"],
                   "{root}/chain/%s/out-reference.txt"
                   % ("small" if small else "large"),
                   "exact", "file:out.txt"),
        # fast-chain/scripts/regression_*.sh (same input, own golden)
        DatasetReg("fast-chain",
                   ["-i", chain_in, "-o", "{out}/out.txt", "-t", "1"],
                   "{root}/chain/%s/out-reference-no-heuristics-32b.txt"
                   % ("small" if small else "large"),
                   "exact", "file:out.txt"),
        # bsw/scripts/regression_*.sh (stderr score= lines, the
        # registry's output_lines)
        DatasetReg("bsw",
                   ["-pairs",
                    "{root}/bsw/%s/bandedSWA_SRR7733443_%s_input.txt"
                    % (size, "100k" if small else "10m"),
                    "-t", "1", "-b", "512"],
                   "{root}/bsw/%s/output-reference.file" % size,
                   "exact", "stderr"),
        # bpm/scripts/regression_*.sh (sorted checksum diff)
        DatasetReg("bpm",
                   ["-a", "bpm-edit", "-i",
                    "{root}/bpm/%s/BPM_SRR7733443_%s_input.txt"
                    % (size, "100k" if small else "10m"),
                    "-o", "{out}/checksum.file", "-t", "1"],
                   "{root}/bpm/%s/output-reference.file" % size,
                   "sorted", "file:checksum.file"),
        # wfa/scripts/regression_*.sh
        DatasetReg("wfa",
                   ["-i",
                    "{root}/wfa/%s/WFA_SRR7733443_%s_input.txt"
                    % (size, "100k" if small else "1m"),
                    "-o", "{out}/checksum.file", "-t", "1"],
                   "{root}/wfa/%s/output-reference.file" % size,
                   "sorted", "file:checksum.file"),
        # fmi/scripts/regression_*.sh (skip 6 header lines both sides)
        DatasetReg("fmi",
                   ["{root}/fmi/broad",
                    "{root}/fmi/%s/SRR7733443_%s_1.fastq"
                    % (size, "1m" if small else "10m"),
                    "512", "19", "1"],
                   "{root}/fmi/%s/out-reference.txt" % size,
                   "exact", "stdout", _fmi_skip6),
        # kmer-cnt/scripts/regression_*.sh (scalar Total k-mers)
        DatasetReg("kmer-cnt",
                   ["--reads",
                    "{root}/kmer-cnt/%s/Loman_E.coli_MAP006-1_2D_50x%s.fasta"
                    % (size, "_1000" if small else ""),
                    "--config", str(REPO / "tests" / "data" /
                                    "asm_raw_reads.cfg"),
                    "--debug", "--threads", "1"],
                   "{root}/kmer-cnt/%s/output-reference.txt" % size,
                   "scalar", "stderr"),
        # dbg/scripts/regression_*.sh (check only wired for small)
        DatasetReg("dbg",
                   ["{root}/dbg/large/ERR194147-mem2-chr22.bam",
                    "chr22:16000000-16500000" if small
                    else "chr22:0-50818468",
                    "{root}/dbg/large/Homo_sapiens_assembly38.fasta",
                    "1", "1" if small else "0"],
                   "{root}/dbg/small/reference.out" if small else None,
                   "sorted", "stdout"),
        # pileup/scripts/regression_*.sh
        DatasetReg("pileup",
                   ["{root}/pileup/small/saureus.bam",
                    "tig00000061:1-1499707", "1"] if small else
                   ["{root}/pileup/large/"
                    "HG002_prom_R941_guppy360_2_GRCh38_ch20.bam",
                    "chr20:1-14128271", "1"],
                   "{root}/pileup/%s/out-reference.txt" % size,
                   "exact", "stdout"),
        # poa/scripts/regression_*.sh (timing lines filtered)
        DatasetReg("poa",
                   ["-s",
                    "{root}/poa/%s/input%s.fasta"
                    % (size, "-1000" if small else ""),
                    "-t", "1"],
                   "{root}/poa/%s/out-reference.fasta" % size,
                   "exact", "stdout", _poa_strip_ticks),
        # abea/scripts/regression_*.sh (tolerant <=10 row diffs on
        # reference_kmer+model_kmer columns)
        DatasetReg("abea",
                   ["-b", "{root}/abea/%s/%sreads.bam"
                    % (size, "1000" if small else "10000"),
                    "-g", "{root}/abea/humangenome.fa",
                    "-r", "{root}/abea/%sreads.fastq"
                    % ("1000" if small else "10000"),
                    "--kmer-model", str(REPO / ".refbuild" /
                                        "r94_model.txt"),
                    "-o", "{out}/events.tsv", "-t", "1"],
                   "{root}/abea/%s-reference.tsv" % size,
                   "tolerant_abea", "file:events.tsv"),
        # nn-base/scripts/regression_{small,large}.sh: bonito-model
        # basecall over the dataset reads dir; out.fastq diffed exactly
        # (the model tar ships with the benchmark tree, bound here
        # under the same root)
        DatasetReg("nn-base",
                   ["{root}/nn-base/models/bonito_dna_r941",
                    "{root}/nn-base/%s/reads" % size,
                    "--chunksize", "3000", "--fastq"],
                   "{root}/nn-base/%s/reference.out.fastq" % size,
                   "exact", "stdout"),
        # nn-variant/scripts/regression_{small,large}.sh: Clair3 VCF
        # body fields 1-5,7-9, deduped + sorted (after_run diff shape)
        DatasetReg("nn-variant",
                   ["--bam", "{root}/nn-variant/HG002_GRCh38_ONT-UL_"
                    "GIAB_20200122_chr20_0_10000000.phased.bam",
                    "--ref", "{root}/nn-variant/hg38_chr20.fa",
                    "--region",
                    "chr20:100000-200000" if small
                    else "chr20:10000-9990000",
                    "--output", "{out}/out.vcf"],
                   "{root}/nn-variant/HG002_chr20_%s_reference.vcf"
                   % ("100000_200000" if small else "10000_9990000"),
                   "sorted", "file:out.vcf", _vcf_body_cut),
    ]
    return rows


def resolve(reg: DatasetReg, root: str, out_dir: str):
    """Substitute {root}/{out} and collect the input paths to check."""
    args = [a.replace("{root}", root).replace("{out}", out_dir)
            for a in reg.args]
    golden = (reg.golden.replace("{root}", root) if reg.golden else None)
    inputs = [a for a in args
              if a.startswith(root) and "/" in a]
    return args, golden, inputs


def run_sweep(size: str, kernels: Optional[List[str]], devices: List[int],
              platform: str, scheduler: Optional[str] = "NONE") -> int:
    """Sweep every (available) kernel's dataset regression: the
    one-command equivalent of running all 13 reference
    regression_{small,large}.sh scripts (run_wrapper.sh report shape).
    `platform` is cli.cmd_regress's: "gpu" or "cpu"."""
    from genarchbench_tpu_torch.cli import cmd_regress

    root = EnvConfig.from_env().inputs_root or ""
    rows = table(size)
    if kernels:
        rows = [r for r in rows if r.kernel in kernels]
    report = []
    rc = 0
    for reg in rows:
        args, golden, inputs = resolve(reg, root or "<unset>", "{out}")
        missing = [p for p in inputs + ([golden] if golden else [])
                   if p and "{out}" not in p and not os.path.exists(p)]
        if not root:
            report.append((reg.kernel, "SKIP", "GENARCH_BENCH_INPUTS_ROOT"
                           " not set"))
            continue
        if missing:
            report.append((reg.kernel, "SKIP",
                           f"missing {os.path.basename(missing[0])}"))
            continue
        code = cmd_regress(reg.kernel, args, golden, devices, platform,
                           reg.rule, scheduler=scheduler,
                           source=reg.source, line_filter=reg.filter)
        report.append((reg.kernel, "PASS" if code == 0 else "FAIL", ""))
        rc |= code
    print(f"\n=== regress {size} ===")
    for kernel, state, why in report:
        print(f"  {kernel:10s} {state}{('  (' + why + ')') if why else ''}")
    npass = sum(1 for _, s, _ in report if s == "PASS")
    nfail = sum(1 for _, s, _ in report if s == "FAIL")
    nskip = sum(1 for _, s, _ in report if s == "SKIP")
    print(f"  {npass} passed, {nfail} failed, {nskip} skipped "
          f"(of {len(report)})")
    return rc
