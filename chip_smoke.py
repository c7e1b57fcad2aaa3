#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit (nvidia-smi), the kernels' build
     and the host helpers' (the C helpers' library and the readers'
     library, BGZF and FASTA, which links zlib);
  2. bpm: the reference-sized input (4096 pairs of 480 bases, 12% error,
     bench.py's seed) through `cli run bpm`; the kernel must have been
     launched, agree exactly with its plain PyTorch version on the card
     for every pair, and the output file must match by the sorted rule;
  3. bsw: 16384 pairs, ref 192-383 / query 10-191 (bench.py's seed),
     through `cli run bsw`, all six outputs exact against the plain
     version, the score lines by the exact rule; then the same for an
     `-i8` input (16-pair groups);
  4. edge shapes: bpm at every word count W = 1..32 (the wavefront
     kernel, text lengths 0..70 mixed in a warp) and W = 33 (the generic
     kernel); bsw with ambiguous bases, 16-pair batches, 16-pair groups,
     groups whose first row is all zero, K = 8 register rows and rows
     wider than 256 columns (the wide-row variant);
  5. wfa (torch ops, no hand kernel): `cli run wfa` at the JAX bench's
     input (8192 pairs of 96 bases, 10% error, seed 104), a 0.45-error
     input that resumes the score cap and an adaptive-reduction input,
     each checked by the sorted rule against the port's own CPU run;
     then a warm run's split (forward, backtrace, CIGARs), its kernel
     launches per score step (torch.profiler's cudaLaunch* calls inside
     the `wfa.forward` spans), its device activity, and the host ms per
     score step at 64, 512 and 4096 pairs;
  6. nn-base at DEFAULT_CONFIG, all under cuDNN with TF32 off: the
     bench batch (32 x 6000 samples, seed 110) timed by CUDA events, the
     card's log-probs against the CPU's on 2 chunks (max |diff| <= 1e-3,
     argmax equal where the CPU's top-two margin exceeds 1e-3), and
     `cli run nn-base default` on 4 reads of 30000 samples with the beam
     and the `--fastq` decoders, one record a read;
  7. chain (torch ops, no hand kernel): `cli run chain` at the JAX
     bench's input (16384 records of up to 511 anchors, seed 102), its
     output held exactly to the port's C scalar DP over every record,
     then six small inputs each held to it the same way (two segments,
     the skip-break stress input, an input whose window spans the
     padded row, a deferral input, low words straddling 2^31 and 2^32,
     ties); a warm run's split (host preparation, copies, anchor loop,
     C deferrals), its kernel launches per anchor step (torch.profiler's
     cudaLaunch* calls inside the `chain.loop` span) and the card's busy
     share;
  8. fast-chain: `cli run fast-chain` on the same input, the first 1024
     records held exactly to the port's CPU run (and three small inputs
     whole), then the same split and launch counts by tile, far pass
     and near pass.  A busy share is the card's activity in one run
     under torch.profiler over that run's own wall time;
  9. fmi (torch ops, no hand kernel): the JAX bench's input (2 Mbp
     reference, 250,000 reads of 100 bases, seed 106) through `cli run
     fmi` twice, first from the fasta (the index built on the fly), then
     from the `.bwt.2bit.64` the port's `save_bwt2bit64` writes beside
     it, with equal SMEM lines; the first 2048 reads' lines held exactly
     to the port's CPU run, then four small inputs whole (N and
     reverse-complement reads, minSeedLen 10, tandem repeats that retry
     at the 64-wide and full tiers, the int64-row path under
     GENARCH_FMI_FORCE_WIDE=1); a warm run's split from
     `search_reads(stats=)`, launches in each `fmi.*` span per loop step,
     the busy share, peak memory, reads/s and SMEMs/s over the CLI's
     `Computing time`, and the index build's time;
 10. abea (torch ops replayed in CUDA graphs, no hand kernel): the JAX
     bench's input (256 reads of 2000 bases, seed 109) over a seeded
     synthetic pore model, laid end to end on one contig, through `cli
     run abea` (the .npy route), its TSV byte for byte equal to the
     port's CPU run (the whole input when the CPU takes at most 15 s for
     its first 64 reads, else those 64); the bench's warm pipeline
     (get_events and align_batch, bench.py:412-419) in reads/s and band
     cells/s; the graphed band scan and backtrace held bit for bit to
     the same blocks run eagerly on the card, both timed, and the graphed
     loops at blocks of 32, 64 and 128 steps (three rounds in rotating
     order, medians); small inputs against the
     CPU (mixed lengths of 10-2000 bases, a QC failure, a tie-heavy
     input, a block longer than NB); a warm run's `stats=` split, the
     kernel and graph launches in the `abea.band` / `abea.backtrace`
     spans per step (and an eager run's), the busy share, peak memory
     and bound;
 11. poa (torch ops replayed in CUDA graphs, no hand kernel): the JAX
     bench's input (256 windows of 10 reads of a 250-base draw, 3%
     substitutions, insertions and deletions, seed 105) through `cli run
     poa`, its consensus lines equal to the port's CPU run (the whole
     input when the CPU's first 32 windows project to at most 30 s for
     all, else those 32); every round's walks of the graphed DP and walk
     held bit for bit to the same blocks run eagerly on the card, both
     timed, and the graphed runs at blocks of 4 and 8 (four rounds in
     rotating order, medians); the DP's planes and start rows and the
     walks, card against
     CPU, on random rounds at P = 1, 2, 4, 8 in the closed-form and the
     general-scan regime and at blocks of 7 and longer than the graph;
     small CLI inputs (the general scan, identical reads, uneven windows
     with empty reads) against the CPU; a warm run's `stats=` split, the
     kernel and graph launches in the `poa.dp` / `poa.walk` spans per DP
     row and walk step (and an eager run's), the busy share, peak memory,
     cells/s and bound;
 12. kmer-cnt (torch ops, no hand kernel): bench.py's input (120 reads of
     20000 +- 2000 bases, seed 4242, k = 17, --min-ovlp 5000) and ten
     times its reads (1200, about 24 Mbp) through `cli run kmer-cnt`,
     each `Total k-mers` equal to the port's CPU run; the minimizer route
     (use_minimizers = 1, window 5) on the bench input equal to the CPU
     run; per size a warm run's split (host packing, copy, codes, sort
     and count), launches in the `kmer.codes` / `kmer.count` spans, busy
     share, peak memory, the codes and the count by CUDA events and the
     count against torch.unique;
 13. dbg (torch ops, no hand kernel): bench.py's input (500 kb reference,
     25,000 reads of 150 bases, seed 108): the card's admissibility
     masks equal to the CPU's for every read, the mask by CUDA events
     against a max-pool running minimum; `cli run dbg` over the whole
     region at verbose 0 (its timing line), and the sub-region
     DBG_SUBREGION at verbose 1 (4 windows, about 40 MB of lines) sorted-
     equal to the CPU run; launches in the `dbg.mask` span, busy share;
 14. pileup (torch ops, no hand kernel): bench.py's input (60,000 reads
     of 300 bases over 500 kb, seed 107, five 100 kb chunks) through `cli
     run pileup`, its stdout byte for byte equal to the port's CPU run; a
     warm run's split (C walk, layout, copies, scatter, copy back),
     launches in the `pileup.scatter` spans, busy share, peak memory, the
     scatter by CUDA events against torch.bincount;
 15. nn-variant (torch ops: cuDNN models, the SSW sweep in CUDA graphs;
     no hand kernel), under cuDNN and cuBLAS with TF32 off: input A
     (tests/torch_variant_inputs.py::ont_case: a 500 kb contig, het SNPs
     about one per 1,000 bases and hom about one per 3,000, 5,000 reads
     of 3,000 +- 1,000 bases at 30x, half reverse, 2% substitutions, 1%
     insertions, 1.5% deletions) through `cli run nn-variant` on the
     whole contig, then `--full-alignment --fa-qual 100` on
     VARIANT_FA_REGION; input B (`ilmn_case`: 3 kb, 800 reads of 150
     bases at 40x, two het and two hom SNPs, a 2-base deletion whose
     reads are written all-M) with `--full-alignment --fa-qual 100
     --realign`; each VCF held to the port's CPU run by the reference's
     projection (rows sorted, fields 1-5 and 7-9 equal, QUAL within
     0.02) and one timing line each, the CPU runs' stage splits beside
     them.  Weights: seeded Keras-scheme npz files through --model and
     --fa-model.  Then each run again, warm, under torch.profiler: its
     split (read, model load, pileup and selection, tensors, Clair3P,
     phasing, FA model load, realign, FA tensors, Clair3F, write),
     launches, device time and busy share, each run's bound, and the
     peak memory; Clair3P at 4,096 tensors and Clair3F at
     1,024 tensors of 89 rows by CUDA events (warm, mean of 20), device
     time and launches, the card against the CPU on 8 tensors within
     1e-4; the SSW forward sweep over input B's realigned reads graphed
     against the same blocks run eagerly (bit for bit, both timed,
     launches a column step), align_batch graphed, eager and on the CPU;
 16. multi-device runs and the regression harness (`mesh_phase`, after
     every other phase, whose inputs and goldens it reads): `cli regress
     bpm` and `regress bsw` on the card at phases 2-3's inputs, one job
     each (`--devices 1`), each job's output held to the file those
     phases held to the plain versions, its hand-kernel launches read
     from its stage directory, its wall time against its timing line;
     bpm_batch and bsw_batch on a mesh of two shards of the one card
     (`Mesh((cuda:0, cuda:0))`: the machine has one card, and NCCL
     refuses two ranks on one), exactly equal to the one-device run
     with twice its launches, the kernels on each shard held to the
     plain version and timed beside the one-shard call (rows
     `bpm-mesh2`, `bsw-mesh2`); wfa, chain, fast-chain, abea and fmi on
     small inputs and fmi with sharded tables on 16,384 bench reads, each
     on that mesh and equal to its one-device run; the sharded k-mer
     count at the kmer-cnt bench input equal to `count_distinct`;
     `regress small` without a dataset root, every kernel a SKIP (the
     CPU determinism sweep, `regress --platform cpu --devices 1,2,8`,
     runs in tests/test_torch_cli.py, not here: its jobs are CPU work);
 17. the nn-base training step (`train_phase`, after the mesh phase; no
     hand kernel: cuDNN convolutions, torch's CTC and AdamW, TF32 off):
     `entry.dryrun_multichip(2)` on two shards of the one card (tp 2),
     its loss, gradients, new parameters and running statistics held to
     the port's one-shard step on the CPU from the same seeded weights;
     DEFAULT_CONFIG with every dropout 0.0, one step at 2 x 3000 samples
     on the card held to the same step on the CPU (the loss, each
     parameter's gradient over its norm), then 3 warm steps at 16 x 3000
     (labels of 250-350 random bases, padded) by CUDA events, their
     launches, device time by kernel, peak memory and bound;
 18. a `{"paths": [...]}` line for the torch-op paths, a
     `{"kernels": [...]}` line with each kernel's launches, error, times
     and bound, then the result line.  `ms` is the wrapper's call
     between CUDA events (warm, mean of 20), `device_ms` the kernels'
     own device time over 20 more such calls (torch.profiler), `plain_ms`
     one warm call of the plain version.

Bounds: bytes over 3.35 TB/s (H100 SXM HBM3) against integer operations
over 1.67e13 int32 op/s (132 SMs x 64 INT32 lanes x 1.98 GHz boost: the
data sheet's 67 TFLOP/s fp32 counts an FMA as two operations on 128
lanes an SM).  Operations are counted from each kernel's inner step:
22 per bpm word-step (bpm.py:90-107), 24 per evaluated bsw band cell
(bsw.py:186-247), 44 per chain window cell and 29 per fast-chain window
cell (the reference's inner loops, native/chain.c::chain_dp_scalar and
fast-chain/src/host_kernel.cpp:819-850, loads not counted), over the
window cells the input has (the sum of i - st(i) over all anchors);
fmi counts 60 per live backwardExt extension (FMI_search.cpp:1268-1298:
for each of the 4 chars, k + s, two GET_OCC of a shift, a mask, an AND
with the one-hot mask, a popcount and an add, and the new k and s; then
the sentinel test, 4, and the l chain, 4), over the extensions of passes
1-3 (`search_reads(stats=)`' ext_pass*), against the bytes of the reads
(one a base) and the SMEMs (3 int32 each).
nn-base's bound is its convolutions' float32 operations (two a
multiply-add) over 67e12 FLOP/s, and its training step's three times
the forward's (the forward, and the backward's input and weight
gradients); wfa's the bytes of its backtrace
stores and mismatch tables over 3.35 TB/s.  abea's is the larger of its
(NB, B, 100) bands and traces (5 bytes a cell, written once) with its
inputs over 3.35 TB/s, and 15 float64 operations a band cell (the
emission's subtract, divide, two multiplies and add, the three scores'
five adds, two maxima and two compares, the band-range tests) over the
data sheet's 34e12 FP64 FLOP/s outside the tensor cores.  poa's is the
larger of its DP's traffic, each rank x query cell of the live windows
writing its H, F and O and its two code planes (20 bytes) and reading the
H, F and O of each of its rank's predecessors (12 bytes each), over
3.35 TB/s, and its integer operations over 1.67e13 op/s: 36 a cell (the
match score and the diagonal, 2; the row's maximum, 2; H's two offset
rows, prefix maxima, gap terms and maxima, 8; E's and Q's, 6; the six
left-move tests with their adds, 12; the packing, 6) and 19 a cell and
predecessor (the F and O candidates, 4 adds and 2 maxima; their running
maxima and the diagonal's, 3; the diagonal's add; the nine traceback
tests), counted from `kernels/poa.py::_dp_step`.  kmer-cnt's is the
bytes of its codes through the sort (the bases read, each 8-byte code
written, read and written by the sort and read by the count, 32 bytes
a code) against 4k int32 operations a code (two int64 adds a base);
dbg's mask the bytes of its inputs (is-N, int32 qualities, lengths)
and its bool output against 6 operations a cell; pileup's the bytes of
its events (two int32 each), the positions' first columns and the
int32 count matrix written once, against 4 operations an event.
nn-variant's models are bound by their float32 operations over 67e12
FLOP/s: two a multiply-add of each LSTM step (4 gates x units x (inputs
+ units) a direction and position), Linear and Conv2d product, from the
layers' shapes in one forward (`model_flops`).  The SSW sweep's is the
larger of the bytes of its maxColumn output (int32, B x (Lref + 1)) and
its sequences (one byte a base) over 3.35 TB/s, and 21 integer
operations a cell over 1.67e13 op/s, counted from `nn/ssw.py::
_sweep_step` (the diagonal shift, the profile gather and add, the E
maximum, the clamp and the validity select: 6; the running-maximum
term, the scan and its shift, the F offset, clamp, maximum and select:
7; E's two subtractions, maximum and clamp: 4; the column maximum and
the three carry selects: 4), over the forward pass's cells, each read
against the whole window.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 1.67e13
BPM_OPS_PER_WORD_STEP = 22
BSW_OPS_PER_CELL = 24
CHAIN_OPS_PER_CELL = 44
FAST_CHAIN_OPS_PER_CELL = 29
FMI_OPS_PER_EXT = 60
ABEA_OPS_PER_CELL = 15
ABEA_BLOCKS = (32, 64, 128)
ABEA_BLOCK_ROUNDS = 3
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
KERNEL_REPS = 20


def input_module(name: str):
    """A numpy-only input module of tests/, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"genarch_{name}", REPO / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synth():
    """tests/synth.py, the input generators."""
    return input_module("synth")


def ptxas_summary(path: pathlib.Path):
    """One line per kernel from nvcc's -Xptxas -v log: registers, spills."""
    name, spill = None, ""
    for ln in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        elif "spill" in ln:
            spill = ln.split(":", 1)[-1].strip()
        elif "Used" in ln and name:
            yield f"{name}: {ln.split(':', 1)[-1].strip()}; {spill}"
            name, spill = None, ""


def kernel_name(mangled: str) -> str:
    """A kernel's readable name, with its template parameter."""
    tmpl = re.search(r"(bpm_wavefront|bsw_rows_kernel)ILi(\d+)E", mangled)
    if tmpl:
        return (f"bpm_wavefront<S={tmpl.group(2)}>"
                if tmpl.group(1) == "bpm_wavefront"
                else f"bsw_rows<K={tmpl.group(2)}>")
    for short in ("bpm_pack_codes", "bpm_generic", "bsw_wide_kernel"):
        if short in mangled:
            return short
    return mangled


def sass_loops(lib: pathlib.Path):
    """One line per kernel from `cuobjdump -sass`: its instruction count
    and that of its longest loop (the widest backward branch), the
    instructions a warp executes per DP row (bsw) or per iteration (bpm)
    where the loop body has no branch skipped."""
    exe = pathlib.Path("/usr/local/cuda/bin/cuobjdump")
    if not exe.is_file():
        yield "sass: no cuobjdump in /usr/local/cuda/bin"
        return
    r = subprocess.run([str(exe), "-sass", str(lib)], capture_output=True,
                       text=True, timeout=300)
    for fn in r.stdout.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        count = len(re.findall(r"/\*[0-9a-f]{4,}\*/", fn))
        branches = re.findall(r"/\*([0-9a-f]{4,})\*/[^\n]*\bBRA\b[^\n]*?0x([0-9a-f]+)",
                              fn)
        loop = max([(int(at, 16) - int(to, 16)) // 16 + 1
                    for at, to in branches if int(to, 16) <= int(at, 16)],
                   default=0)
        yield f"{kernel_name(name)}: {count} instructions, loop {loop}"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` warm calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, kernel_names, reps: int):
    """Mean device time of the named kernels per call of `fn` over `reps`
    warm calls, from torch.profiler's CUDA activity; None when the
    profiler records none of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                if any(n in e.key for n in kernel_names))
    return total / reps / 1e3 if total else None


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_cli(argv, stderr_path: pathlib.Path) -> str:
    """cli.main(argv) with its stderr sent to a file; returns stdout."""
    from genarchbench_tpu_torch import cli
    out = io.StringIO()
    with open(stderr_path, "w") as err, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"cli {' '.join(argv)} returned {rc}")
    return out.getvalue()


def reset_launch_counts() -> None:
    """Every kernel wrapper's launch count to 0, before a path is driven."""
    from genarchbench_tpu_torch.kernels import bpm_cuda, bsw_cuda
    bpm_cuda.LAUNCHES = 0
    bsw_cuda.LAUNCHES = 0


def timing_line(text: str, prefix: str) -> str:
    return next((ln for ln in text.splitlines() if prefix in ln), "")


def bpm_phase(card: str):
    import numpy as np
    import torch
    from genarchbench_tpu_torch.core.check import check_sorted
    from genarchbench_tpu_torch.io.seqpair_io import read_seqpairs
    from genarchbench_tpu_torch.kernels import bpm, bpm_cuda

    inp, outp, errp = (WORK / "bpm_pairs.txt", WORK / "bpm.out",
                       WORK / "bpm.err")
    inp.write_text(synth().gen_seqpair_dataset(np.random.default_rng(101),
                                       n_pairs=4096, length=480,
                                       error_rate=0.12))
    reset_launch_counts()
    run_cli(["run", "bpm", "-i", str(inp), "-o", str(outp)], errp)
    launches = bpm_cuda.LAUNCHES
    err_text = errp.read_text()
    print("bpm cli:", timing_line(err_text, "Time.Benchmark").strip(), "|",
          timing_line(err_text, "CellUpdates").strip())
    if launches < 1:
        fail("bpm: the CLI run launched no bpm kernel")

    pairs = read_seqpairs(str(inp), swap_longer_first=True)
    groups = [(idx, [torch.from_numpy(a).cuda() for a in arrays])
              for idx, arrays in bpm.kernel_inputs(pairs)]
    plain = np.zeros(len(pairs), np.int64)
    max_err = 0
    for idx, args in groups:
        k = bpm_cuda.bpm_distance(*args)
        p = bpm_cuda.bpm_distance_plain(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, int((k.long() - p.long()).abs().max()))
        plain[idx] = p.cpu().numpy()
    np.save(WORK / "bpm_plain.npy", plain)      # the mesh phase's reference
    want = [f"[{i}] score={-s}" for i, s in enumerate(plain)]
    res = check_sorted(outp.read_text().splitlines(), want)
    if max_err != 0 or not res:
        fail(f"bpm: kernel vs plain max |diff| {max_err}; "
             f"output file vs plain: {res.detail}")

    def kernels():
        for _, args in groups:
            bpm_cuda.bpm_distance(*args)

    def plains():
        for _, args in groups:
            bpm_cuda.bpm_distance_plain(*args)

    ms = event_ms(kernels, KERNEL_REPS)
    dev_ms = device_ms(kernels, ("bpm_wavefront", "bpm_pack_codes",
                                 "bpm_generic"), KERNEL_REPS)
    plain_ms = event_ms(plains, 1)
    word_steps = sum(args[0].shape[0] * int(args[3].long().sum())
                     for _, args in groups)
    nbytes = sum(tensor_bytes(args) + 4 * args[0].shape[2]
                 for _, args in groups)
    b_ms, b_by = bound_ms(nbytes, BPM_OPS_PER_WORD_STEP * word_steps)
    cells = bpm.cell_updates(pairs)
    variants = [f"W={a[0].shape[0]}:S={bpm_cuda.segment_width(a[0].shape[0])}"
                for _, a in groups]
    return dict(name="bpm", route="cuda",
                source="genarchbench_tpu_torch/csrc/bpm.cu",
                replaces="genarchbench_tpu/kernels/bpm_pallas.py:98",
                launches=launches, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, pairs=len(pairs), max_abs_diff=max_err,
                kernel_ms=ms, device_ms=dev_ms, cells_per_s=cells / (ms / 1e3),
                variants=variants, card=card)


def bsw_phase(card: str, name: str, gen_args: dict, cli_extra: list,
              lanes: int):
    import numpy as np
    import torch
    from genarchbench_tpu_torch.core.check import check_exact
    from genarchbench_tpu_torch.io.bsw_io import read_bsw_pairs
    from genarchbench_tpu_torch.kernels import bsw, bsw_cuda

    inp, errp = WORK / f"{name}_pairs.txt", WORK / f"{name}.err"
    inp.write_text(synth().gen_bsw_input(np.random.default_rng(gen_args["seed"]),
                                 n_pairs=gen_args["n"],
                                 ref_len=gen_args["ref_len"],
                                 query_len=gen_args["query_len"]))
    reset_launch_counts()
    stdout = run_cli(["run", "bsw", "-pairs", str(inp), *cli_extra], errp)
    launches = bsw_cuda.LAUNCHES
    print(f"{name} cli:", timing_line(stdout, "Overall SW").strip(), "|",
          timing_line(stdout, "numCellsComputed").strip())
    if launches < 1:
        fail(f"{name}: the CLI run launched no bsw kernel")

    pairs = read_bsw_pairs(str(inp))
    sc = dict(match=1, mismatch=-4, ambig=-1, o_del=6, e_del=1, o_ins=6,
              e_ins=1, zdrop=100, w=100)
    src, arrays = bsw.kernel_inputs(pairs, 0, lanes, match=1, end_bonus=5,
                                    o_ins=6, e_ins=1, o_del=6, e_del=1,
                                    w=100)
    args = [torch.from_numpy(a).cuda() for a in arrays]
    k = bsw_cuda.bsw_scores(*args, **sc)
    p, band_cells = bsw_cuda.bsw_scores_plain(*args, **sc, return_cells=True)
    torch.cuda.synchronize()
    max_err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(k, p))
    # the six outputs, the mesh phase's reference
    np.save(WORK / f"{name}_plain.npy", torch.stack(p).cpu().numpy())
    valid = src >= 0
    plain = np.zeros(len(pairs), np.int64)
    plain[src[valid]] = p[0].cpu().numpy()[valid]
    got = [ln for ln in errp.read_text().splitlines()
           if re.match(r"\[\d+\] score=", ln)]
    res = check_exact(got, [f"[{i}] score={s}" for i, s in enumerate(plain)])
    if max_err != 0 or not res:
        bad = [f"{nm}: {int((a != b).sum())} lanes" for nm, a, b in
               zip(("score", "tle", "qle", "max_off", "gscore", "gtle"), k, p)]
        diff = torch.stack([a != b for a, b in zip(k, p)]).any(0)
        g, lane = diff.nonzero()[0].tolist() if diff.any() else (0, 0)
        fail(f"{name}: kernel vs plain max |diff| {max_err} over the six "
             f"outputs ({', '.join(bad)}; first at group {g} lane {lane}: "
             f"kernel {[int(a[g, lane]) for a in k]} plain "
             f"{[int(b[g, lane]) for b in p]}); score lines vs plain: "
             f"{res.detail}")

    ms = event_ms(lambda: bsw_cuda.bsw_scores(*args, **sc), KERNEL_REPS)
    dev_ms = device_ms(lambda: bsw_cuda.bsw_scores(*args, **sc),
                       ("bsw_rows_kernel", "bsw_wide_kernel"), KERNEL_REPS)
    plain_ms = event_ms(lambda: bsw_cuda.bsw_scores_plain(*args, **sc), 1)
    nbytes = tensor_bytes(args) + 6 * args[2].numel() * 4
    b_ms, b_by = bound_ms(nbytes, BSW_OPS_PER_CELL * band_cells)
    cells = bsw.cell_updates(pairs)
    K, _ = bsw_cuda.kernel_variant(lanes, args[1].shape[2], 1 << 30)
    return dict(name=name, route="cuda",
                source="genarchbench_tpu_torch/csrc/bsw.cu",
                replaces="genarchbench_tpu/kernels/bsw_pallas.py:98",
                launches=launches, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, pairs=len(pairs), max_abs_diff=max_err,
                kernel_ms=ms, device_ms=dev_ms, cells_per_s=cells / (ms / 1e3),
                band_cells=band_cells,
                variant=f"rows K={K}" if K else "wide", card=card)


def edge_phase():
    """Shapes the bench input does not reach, kernel against plain."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch.io.bsw_io import BswPairs
    from genarchbench_tpu_torch.io.seqpair_io import SeqPairs
    from genarchbench_tpu_torch.kernels import bpm, bpm_cuda, bsw, bsw_cuda

    # bpm: every word count W = 1..32 (the wavefront kernel at each
    # segment width) and W = 33 (the generic kernel); 37 pairs a W, so
    # the last warp is part-filled, with text lengths 0..70 mixed inside
    # each segment-packed warp, and patterns ending on bit 31 of a word
    rng = np.random.default_rng(7)
    plens = [int(n) for W in range(1, 34) for n in
             np.r_[32 * W, rng.integers(32 * (W - 1) + 1, 32 * W + 1, 36)]]
    pats = [rng.integers(0, 5, n).astype(np.uint8) for n in plens]
    tlens = rng.integers(0, 71, len(plens))
    tlens[::5] = 0
    txts = [rng.integers(0, 5, int(m)).astype(np.uint8) for m in tlens]
    widths = []
    for idx, arrays in bpm.kernel_inputs(SeqPairs(pats, txts)):
        args = [torch.from_numpy(a).cuda() for a in arrays]
        k = bpm_cuda.bpm_distance(*args)
        p = bpm_cuda.bpm_distance_plain(*args)
        W = args[0].shape[0]
        if not torch.equal(k, p):
            bad = (k != p).nonzero()[:, 0].tolist()
            fail(f"bpm edge: W={W} S={bpm_cuda.segment_width(W)} kernel != "
                 f"plain at {len(bad)} pairs, first {bad[:5]}: kernel "
                 f"{k[bad[:5]].tolist()} plain {p[bad[:5]].tolist()}")
        widths.append(W)
    if widths != list(range(1, 34)):
        fail(f"bpm edge: word counts {widths}, not 1..33")

    sc = dict(match=1, mismatch=-4, ambig=-1, o_del=6, e_del=1, o_ins=6,
              e_ins=1, zdrop=100, w=100)

    def bsw_pairs(n, rmax, qmin, qmax, h0):
        refs = [np.where(rng.random(m) < 0.05, 0xFFFF, rng.integers(0, 4, m))
                .astype(np.int32) for m in rng.integers(1, rmax, n)]
        quers = [np.where(rng.random(m) < 0.05, 0xFFFF,
                          rng.integers(0, 4, m)).astype(np.int32)
                 for m in rng.integers(qmin, qmax, n)]
        return BswPairs(h0(refs).astype(np.int32), refs, quers)

    def rand_h0(refs):
        return rng.integers(0, 60, len(refs))

    def zero_short_h0(refs):
        # h0 = 0 for every reference under 120 bases: the groups of those
        # pairs have a whole zero first row and stop there
        return np.array([0 if len(r) < 120 else 30 + len(r) % 20
                         for r in refs])

    cases = [("ambiguous, 16-pair batches", bsw_pairs(512, 300, 1, 150,
                                                      rand_h0), 16, 8),
             ("ambiguous, 16-lane groups", bsw_pairs(512, 300, 1, 150,
                                                     rand_h0), 0, 16),
             ("zero first rows", bsw_pairs(512, 300, 1, 150,
                                           zero_short_h0), 0, 8),
             ("K = 8 rows", bsw_pairs(256, 400, 150, 255, rand_h0), 0, 8),
             ("wide rows", bsw_pairs(256, 400, 200, 300, rand_h0), 0, 8)]
    seen = []
    for what, pairs, batch, lanes in cases:
        src, arrays = bsw.kernel_inputs(pairs, batch, lanes, match=1,
                                        end_bonus=5, o_ins=6, e_ins=1,
                                        o_del=6, e_del=1, w=100)
        args = [torch.from_numpy(a).cuda() for a in arrays]
        C2 = args[1].shape[2]
        K, _ = bsw_cuda.kernel_variant(lanes, C2, 1 << 30)
        k = bsw_cuda.bsw_scores(*args, **sc)
        p = bsw_cuda.bsw_scores_plain(*args, **sc)
        if not all(torch.equal(a, b) for a, b in zip(k, p)):
            diff = torch.stack([a != b for a, b in zip(k, p)]).any(0)
            g, lane = diff.nonzero()[0].tolist()
            fail(f"bsw edge ({what}, C2={C2}, K={K}): kernel != plain at "
                 f"{int(diff.sum())} lanes, first group {g} lane {lane}: "
                 f"kernel {[int(a[g, lane]) for a in k]} plain "
                 f"{[int(b[g, lane]) for b in p]}")
        if what == "zero first rows" and not (arrays[4] == 0).all(1).any():
            fail("bsw edge: no group has a whole zero first row")
        seen.append(f"{what} (C2={C2}, {f'K={K}' if K else 'wide'})")
    print("edge shapes agree: bpm W=1..33; bsw " + "; ".join(seen))


def launches_in_spans(prof, span: str) -> int:
    """CUDA kernel launches (the runtime's cudaLaunch* calls, on the host's
    clock) inside every `record_function(span)` range of a profile.  Only
    the host's ranges count: the profiler mirrors each range on the
    card's timeline, where it ends later, while the host already
    launches the next span's kernels."""
    import torch
    evs = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end) for e in evs
             if e.name == span
             and e.device_type == torch.autograd.DeviceType.CPU]
    return sum(1 for e in evs if e.name.startswith("cudaLaunch")
               and any(a <= e.time_range.start <= b for a, b in spans))


def profiled(fn):
    """Run fn once under torch.profiler (host and card activity), the card
    synchronized at its end: (the profile, the run's wall ms inside the
    profiler, the denominator of a busy share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return prof, ms


def wfa_phase(card: str) -> dict:
    """wfa through `cli run wfa` at the JAX bench's input and two small
    ones, each checked by the sorted rule against the port's own CPU run;
    then a warm run's split and its kernel launches per step."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch.core.check import check_sorted
    from genarchbench_tpu_torch.io.seqpair_io import SeqPairs, read_seqpairs
    from genarchbench_tpu_torch.kernels import wfa

    adaptive = ["--minimum-wavefront-length", "10",
                "--maximum-difference-distance", "25"]
    # (name, generator args, CLI flags, pairs checked against the CPU)
    cases = [("bench", (104, 8192, 96, 0.10), [], 1024),
             ("scap-retry", (9, 64, 120, 0.45), [], 64),
             ("adaptive", (6, 256, 150, 0.20), adaptive, 256)]
    for name, (seed, n, length, err), extra, n_check in cases:
        inp, outp, errp = (WORK / f"wfa_{name}.txt", WORK / f"wfa_{name}.out",
                           WORK / f"wfa_{name}.err")
        inp.write_text(synth().gen_seqpair_dataset(
            np.random.default_rng(seed), n_pairs=n, length=length,
            error_rate=err))
        stdout = run_cli(["run", "wfa", "-i", str(inp), "-o", str(outp),
                          *extra], errp)
        print(f"wfa {name} cli:", timing_line(stdout, "Time.Alignment"), "|",
              timing_line(errp.read_text(), "CellUpdates").strip())
        pairs = read_seqpairs(str(inp))
        sub = SeqPairs(pairs.patterns[:n_check], pairs.texts[:n_check])
        red = dict(red_len=10, red_dist=25) if extra else {}
        want = [f"id={i} {c}" for i, c in
                enumerate(wfa.wfa_batch(sub, device="cpu", **red))]
        res = check_sorted(outp.read_text().splitlines()[:n_check], want)
        if not res:
            fail(f"wfa {name}: the card's CIGARs vs the CPU run's on the "
                 f"first {n_check} pairs: {res.detail}")
        if name == "bench":
            bench = pairs
            roi_s = float(timing_line(stdout, "Time.Alignment").split()[1])

    wfa.wfa_batch(bench)                          # warm
    torch.cuda.synchronize()
    stats = {}
    t0 = time.perf_counter()
    wfa.wfa_batch(bench, stats=stats)
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof, prof_ms = profiled(lambda: wfa.wfa_batch(bench))
    fwd = launches_in_spans(prof, "wfa.forward")
    bt = launches_in_spans(prof, "wfa.backtrace")
    # device activity by name, [count, us]; the record_function spans
    # also appear on the device's timeline and are left out
    device = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not e.name.startswith("wfa."):
            c = device.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us()
    kernel_us = sum(us for _, us in device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:6]
    # host ms per score step against the chunk's width: flat when the
    # loop is bound by its launches, rising with B when by the card
    per_step = {}
    for n in (64, 512, 4096):
        sub = SeqPairs(bench.patterns[:n], bench.texts[:n])
        wfa.wfa_batch(sub)
        st = {}
        wfa.wfa_batch(sub, stats=st)
        per_step[n] = st["forward_s"] * 1e3 / st["score_steps"]
    b_ms, b_by = bound_ms(stats["forward_bytes"], 0)
    row = dict(name="wfa", ms=wall_ms, steps=stats["score_steps"],
               bt_steps=stats["bt_steps"], resumes=stats["resumes"],
               chunks=stats["chunks"], pairs=len(bench),
               forward_ms=stats["forward_s"] * 1e3,
               backtrace_ms=stats["backtrace_s"] * 1e3,
               cigar_ms=stats["cigar_s"] * 1e3,
               launches_forward=fwd, launches_backtrace=bt,
               launches_per_score_step=fwd / stats["score_steps"],
               launches_per_bt_step=bt / max(stats["bt_steps"], 1),
               profiled_device_ms=kernel_us / 1e3, profiled_ms=prof_ms,
               device_busy_share=kernel_us / 1e3 / prof_ms,
               device_events=sum(c for c, _ in device.values()),
               forward_ms_per_step_by_pairs=per_step, cli_roi_s=roi_s,
               cells_per_s=wfa.cell_updates(bench) / (wall_ms / 1e3),
               bound_ms=b_ms, bound_by=b_by,
               forward_bytes=stats["forward_bytes"], card=card)
    print(f"wfa warm: {wall_ms:.1f} ms for {len(bench)} pairs "
          f"({stats['chunks']} chunks, {stats['score_steps']} score steps, "
          f"{stats['resumes']} resumes, {stats['bt_steps']} backtrace "
          f"steps): forward {row['forward_ms']:.1f} ms, backtrace "
          f"{row['backtrace_ms']:.1f} ms, CIGARs {row['cigar_ms']:.1f} ms; "
          f"{fwd} launches in the forward passes "
          f"({row['launches_per_score_step']:.1f} a score step), {bt} in "
          f"the backtraces; CPU parity on bench[:1024], scap-retry, "
          f"adaptive: sorted rule ok")
    print("wfa forward ms per score step by chunk width: " + ", ".join(
        f"{n} pairs {v:.3f}" for n, v in per_step.items()))
    print(f"wfa profiled run: {row['device_events']} device events, "
          f"{kernel_us / 1e3:.1f} ms of device activity, "
          f"{row['device_busy_share']:.1%} of the profiled run's "
          f"{prof_ms:.1f} ms; "
          f"top by time:")
    for name, (c, us) in top:
        print(f"  {us / 1e3:9.2f} ms {c:6d} x {us / c:8.2f} us  {name[:90]}")
    return row


def conv_flops(model, x) -> int:
    """Float32 operations of the model's convolutions on input x, two a
    multiply-add, from each Conv1d's output shape in one forward."""
    import torch
    total = [0]

    def hook(mod, _inp, out):
        total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) \
            * mod.kernel_size[0]

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv1d)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def nn_phase(card: str) -> dict:
    """nn-base at DEFAULT_CONFIG: the bench batch's warm forward, the
    card's log-probs against the CPU's on the same weights, and both CLI
    decoders, all with cuDNN's TF32 off."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch.nn import basecall as bc

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        caller = bc.Basecaller.init(seed=0, chunksize=6000)
        x = np.random.default_rng(110).standard_normal(
            (32, 6000, 1)).astype(np.float32)
        xt = torch.from_numpy(x).cuda().transpose(1, 2)

        def forward():
            with torch.no_grad():
                caller.model(xt)

        ms = event_ms(forward, 10)
        flops = conv_flops(caller.model, xt)
        caller.forward(x)
        t0 = time.perf_counter()
        caller.forward(x)
        wall_ms = (time.perf_counter() - t0) * 1e3

        cpu_model = bc.BasecallModel(bc.DEFAULT_CONFIG)
        cpu_model.load_state_dict(caller.model.state_dict())
        cpu = bc.Basecaller(bc.DEFAULT_CONFIG, cpu_model, device="cpu")
        on_card, on_cpu = caller.forward(x[:2]), cpu.forward(x[:2])
        max_err = float(np.abs(on_card - on_cpu).max())
        top2 = np.sort(on_cpu, axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) > 1e-3
        flips = int(((on_card.argmax(-1) != on_cpu.argmax(-1))
                     & decided).sum())
        if not np.isfinite(on_card).all() or max_err > 1e-3 or flips:
            fail(f"nn-base: card vs CPU log-probs max |diff| {max_err} "
                 f"(limit 1e-3), {flips} argmax flips on frames with a "
                 f"top-two margin > 1e-3")

        reads = WORK / "nn_reads"
        reads.mkdir(exist_ok=True)
        rng = np.random.default_rng(111)
        for i in range(4):
            levels = np.repeat(rng.normal(400, 80, 30000 // 8), 8)
            np.save(reads / f"read_{i}.npy",
                    (levels + rng.normal(0, 10, 30000)).astype(np.int16))
        argv = ["run", "nn-base", "default", str(reads), "--chunksize",
                "6000", "--overlap", "600"]
        cli_lines = []
        for extra, head, per in (([], ">", 2), (["--fastq"], "@", 4)):
            errp = WORK / f"nn{'_fastq' if extra else ''}.err"
            out = run_cli(argv + extra, errp).splitlines()
            names = [ln[1:] for ln in out[::per]]
            if names != [f"read_{i}" for i in range(4)] or \
                    not all(ln.startswith(head) for ln in out[::per]):
                fail(f"nn-base cli {' '.join(extra) or 'beam'}: records "
                     f"{names}, not one per read")
            cli_lines.append(timing_line(errp.read_text(),
                                         "samples per second").strip())
    n_frames = int(decided.size)
    print(f"nn-base (cuDNN TF32 off): forward 32 x 6000 {ms:.3f} ms "
          f"(CUDA events, mean of 10), Basecaller.forward {wall_ms:.1f} ms "
          f"with copies; card vs CPU on 2 chunks: max |dlogp| {max_err:.2e}, "
          f"argmax equal on every frame with margin > 1e-3 "
          f"({n_frames - int(decided.sum())} of {n_frames} frames excluded); "
          f"cli beam: {cli_lines[0]}; cli --fastq: {cli_lines[1]}")
    return dict(name="nn-base", ms=ms, samples=32 * 6000,
                samples_per_s=32 * 6000 / (ms / 1e3), wall_ms=wall_ms,
                max_abs_err=max_err, frames_excluded=n_frames
                - int(decided.sum()), tf32=False, flops=flops,
                bound_ms=flops / PEAK_FP32_FLOPS * 1e3, bound_by="operations",
                card=card)


def device_activity(prof, skip: str):
    """(events, ms) of the card's activity in a profile, leaving out the
    record_function spans (named `skip`...) mirrored on its timeline."""
    import torch
    count, us = 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not e.name.startswith(skip):
            count += 1
            us += e.time_range.elapsed_us()
    return count, us / 1e3


def chain_lines(results) -> list:
    """Chain-format output lines of [(scores, parents, ...)]."""
    from genarchbench_tpu_torch.io import chain_io
    out = io.StringIO()
    chain_io.write_returns(out, [(r[0], r[1]) for r in results])
    return out.getvalue().splitlines()


def chain_phase(card: str, bench_path: pathlib.Path):
    """chain through `cli run chain` at the JAX bench's input and six
    small ones, each output held exactly to the port's C scalar DP; then
    a warm run's split, its launches per anchor step and the card's busy
    share.  Returns (row, the bench's records)."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch.core.check import check_exact
    from genarchbench_tpu_torch.io import chain_io
    from genarchbench_tpu_torch.kernels import chain

    ci = input_module("torch_chain_inputs")
    cases = [("bench", None),
             ("two-segments", synth().gen_chain_input(
                 np.random.default_rng(31), n_records=256, max_anchors=400,
                 n_segs=2)),
             ("skip-break", ci.skip_break_text()), ("dense", ci.dense_text()),
             ("deferral", ci.deferral_text()), ("u32-wrap", ci.wrap_text()),
             ("ties", ci.tie_text())]
    for name, text in cases:
        inp = bench_path if text is None else WORK / f"chain_{name}.txt"
        if text is not None:
            inp.write_text(text)
        outp, errp = WORK / f"chain_{name}.out", WORK / f"chain_{name}.err"
        torch.cuda.reset_peak_memory_stats()
        run_cli(["run", "chain", "-i", str(inp), "-o", str(outp)], errp)
        line = timing_line(errp.read_text(), "Time in kernel")
        recs = chain_io.read_records_path(str(inp))
        ws = chain_io.window_starts_all(recs, chain.MAX_ITER)
        t0 = time.perf_counter()
        want = chain_lines(chain.scalar_dp(recs, ws))
        scalar_ms = (time.perf_counter() - t0) * 1e3
        res = check_exact(outp.read_text().splitlines(), want)
        if not res:
            fail(f"chain {name}: the card's output vs the C scalar DP: "
                 f"{res.detail}")
        st = {}
        chain.chain_batch(recs, stats=st)
        route = {"dense": all(W == N for W, N in st["widths"]),
                 "deferral": st["deferred"] > 0}.get(name, True)
        if not route:
            fail(f"chain {name}: the input missed its path: {st}")
        print(f"chain {name} cli: {line.strip()} | {len(recs)} records, "
              f"{st['plans']} plans, (W, N) {st['widths']}, "
              f"{st['deferred']} deferred: exact vs the C scalar DP")
        if name == "bench":
            records, bench_ws = recs, ws
            roi_s = float(line.split()[3])
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            c_ms = scalar_ms

    n_anchors = sum(r.n for r in records)
    cells = sum(r.n * (r.n - 1) // 2 - int(w.sum(dtype=np.int64))
                for r, w in zip(records, bench_ws))
    chain.chain_batch(records)                      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain.chain_batch(records)
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = {}
    chain.chain_batch(records, stats=stats)
    prof, prof_ms = profiled(lambda: chain.chain_batch(records))
    loop = launches_in_spans(prof, "chain.loop")
    events, dev_ms = device_activity(prof, "chain.")
    # anchor planes read once (x low word, qi, st: 4 bytes; span, sid: 1)
    # and scores, parents, peaks written once
    b_ms, b_by = bound_ms(26 * n_anchors, CHAIN_OPS_PER_CELL * cells)
    row = dict(name="chain", ms=wall_ms, records=len(records),
               anchors=n_anchors, window_cells=cells, plans=stats["plans"],
               widths=stats["widths"], steps=stats["steps"], deferred=stats["deferred"],
               prep_ms=stats["prep_s"] * 1e3, h2d_ms=stats["h2d_s"] * 1e3,
               loop_ms=stats["loop_s"] * 1e3, d2h_ms=stats["d2h_s"] * 1e3,
               scalar_ms=stats["scalar_s"] * 1e3, launches_loop=loop,
               launches_per_anchor_step=loop / stats["steps"],
               profiled_device_ms=dev_ms, device_events=events,
               profiled_ms=prof_ms, device_busy_share=dev_ms / prof_ms,
               cli_roi_s=roi_s, cells_per_s_roi=cells / roi_s,
               cells_per_s=cells / (wall_ms / 1e3), peak_gb=peak_gb,
               c_scalar_all_ms=c_ms, bound_ms=b_ms, bound_by=b_by, card=card)
    print(f"chain warm: {wall_ms:.1f} ms for {len(records)} records, "
          f"{n_anchors} anchors, {cells} window cells ({stats['plans']} "
          f"plans, (W, N) {stats['widths']}, {stats['steps']} anchor "
          f"steps, {stats['deferred']} deferred); with a sync at each boundary: prep "
          f"{row['prep_ms']:.1f} ms, h2d {row['h2d_ms']:.1f}, loop "
          f"{row['loop_ms']:.1f}, d2h {row['d2h_ms']:.1f}, C deferrals "
          f"{row['scalar_ms']:.1f}; {loop} launches in the loop "
          f"({row['launches_per_anchor_step']:.1f} an anchor step); "
          f"{dev_ms:.1f} ms of device activity in a profiled run, "
          f"{row['device_busy_share']:.1%} of its {prof_ms:.1f} ms; "
          f"{row['cells_per_s_roi']:.3e} cells/s over the CLI's ROI; "
          f"bound {b_ms:.4f} ms ({b_by}); the C oracle (scalar DP and its "
          f"output lines) over all records {c_ms:.1f} ms; peak "
          f"{peak_gb:.2f} GB")
    return row, records


def fast_chain_phase(card: str, bench_path: pathlib.Path, records):
    """fast-chain through `cli run fast-chain` at the bench input, its
    first 1024 records held exactly to the port's CPU run, and three
    small inputs whole; then a warm run's split and its launches by tile,
    far pass and near pass."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch.core.check import check_exact
    from genarchbench_tpu_torch.io import chain_io
    from genarchbench_tpu_torch.kernels import fast_chain

    ci = input_module("torch_chain_inputs")
    cases = [("bench", None, 1024), ("ties", ci.tie_text(), None),
             ("u32-wrap", ci.wrap_text(), None),
             ("dense", ci.dense_text(), None)]
    for name, text, n_check in cases:
        inp = bench_path if text is None else WORK / f"fc_{name}.txt"
        if text is not None:
            inp.write_text(text)
        outp, errp = WORK / f"fc_{name}.out", WORK / f"fc_{name}.err"
        torch.cuda.reset_peak_memory_stats()
        run_cli(["run", "fast-chain", "-i", str(inp), "-o", str(outp)], errp)
        line = timing_line(errp.read_text(), "Time in kernel")
        recs = records if text is None else \
            chain_io.read_records_path(str(inp))
        sub = recs[:n_check] if n_check else recs
        want = chain_lines(fast_chain.fast_chain_batch(sub, device="cpu"))
        got = outp.read_text().splitlines()[:len(want)]
        res = check_exact(got, want)
        if not res:
            fail(f"fast-chain {name}: the card's output vs the CPU run on "
                 f"{len(sub)} records: {res.detail}")
        print(f"fast-chain {name} cli: {line.strip()} | exact vs the CPU "
              f"run on {len(sub)} of {len(recs)} records")
        if name == "bench":
            roi_s = float(line.split()[3])
            peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_anchors = sum(r.n for r in records)
    ws = chain_io.window_starts_all(records)
    cells = sum(r.n * (r.n - 1) // 2 - int(w.sum(dtype=np.int64))
                for r, w in zip(records, ws))
    fast_chain.fast_chain_batch(records)            # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast_chain.fast_chain_batch(records)
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = {}
    fast_chain.fast_chain_batch(records, stats=stats)
    prof, prof_ms = profiled(lambda: fast_chain.fast_chain_batch(records))
    far = launches_in_spans(prof, "fast_chain.far")
    near = launches_in_spans(prof, "fast_chain.near")
    events, dev_ms = device_activity(prof, "fast_chain.")
    # x low word, qi, st read once (4 bytes), span (1); scores and
    # parents written once
    b_ms, b_by = bound_ms(21 * n_anchors, FAST_CHAIN_OPS_PER_CELL * cells)
    tiles = stats["tiles"]
    row = dict(name="fast-chain", ms=wall_ms, records=len(records),
               anchors=n_anchors, window_cells=cells, plans=stats["plans"],
               tiles=tiles, far_chunks=stats["far_chunks"],
               near_steps=stats["near_steps"],
               prep_ms=stats["prep_s"] * 1e3, h2d_ms=stats["h2d_s"] * 1e3,
               far_ms=stats["far_s"] * 1e3, near_ms=stats["near_s"] * 1e3,
               d2h_ms=stats["d2h_s"] * 1e3, launches_far=far,
               launches_near=near, launches_far_per_tile=far / tiles,
               launches_near_per_tile=near / tiles,
               launches_per_far_chunk=far / max(stats["far_chunks"], 1),
               launches_per_near_step=near / stats["near_steps"],
               profiled_device_ms=dev_ms, device_events=events,
               profiled_ms=prof_ms, device_busy_share=dev_ms / prof_ms,
               cli_roi_s=roi_s, cells_per_s_roi=cells / roi_s,
               cells_per_s=cells / (wall_ms / 1e3), peak_gb=peak_gb,
               bound_ms=b_ms, bound_by=b_by, card=card)
    print(f"fast-chain warm: {wall_ms:.1f} ms ({stats['plans']} plans, "
          f"{tiles} tiles, {stats['far_chunks']} far chunks, "
          f"{stats['near_steps']} near steps); with a sync at each "
          f"boundary: prep {row['prep_ms']:.1f} ms, h2d "
          f"{row['h2d_ms']:.1f}, far {row['far_ms']:.1f}, near "
          f"{row['near_ms']:.1f}, d2h {row['d2h_ms']:.1f}; launches: far "
          f"{far} ({row['launches_far_per_tile']:.1f} a tile, "
          f"{row['launches_per_far_chunk']:.1f} a chunk), near {near} "
          f"({row['launches_near_per_tile']:.1f} a tile, "
          f"{row['launches_per_near_step']:.1f} a step); {dev_ms:.1f} ms "
          f"of device activity in a profiled run, "
          f"{row['device_busy_share']:.1%} of its {prof_ms:.1f} ms; "
          f"{row['cells_per_s_roi']:.3e} cells/s over the CLI's ROI; "
          f"bound {b_ms:.4f} ms ({b_by}); peak {peak_gb:.2f} GB")
    return row


@contextlib.contextmanager
def environ(env: dict):
    """The process environment with env set, restored on exit."""
    import os
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fmi_cli(argv, name: str, env=None):
    """`cli run fmi argv` on the card, with env set around it: (its SMEM
    lines, its stdout)."""
    with environ(env or {}):
        out = run_cli(["run", "fmi", *map(str, argv)], WORK / f"{name}.err")
    return fmi_lines(out), out


def fmi_lines(text: str) -> list:
    return [ln for ln in text.splitlines()
            if ln.endswith(":") and ln[:-1].isdigit() or ln.startswith("[")]


def fmi_cpu_lines(fa, fq, batch: int, seed: int, n=None) -> list:
    """The port's CPU run's SMEM lines on the first n reads of fq."""
    from genarchbench_tpu_torch.kernels import fmi
    reads = fmi.read_queries(str(fq))[:n]
    cpu = fmi.FMISearch(fmi.load_index(str(fa)), device="cpu")
    return fmi_lines(fmi.smem_text(fmi.search_reads(cpu, reads, batch, seed)))


def fmi_phase(card: str) -> dict:
    """fmi through `cli run fmi` at the JAX bench's input, from the fasta
    and from the `.bwt.2bit.64` beside it, the first 2048 reads held to
    the port's CPU run, then four small inputs whole; then a warm run's
    split, its launches per loop step and the card's busy share."""
    import torch
    import numpy as np
    from genarchbench_tpu_torch.kernels import fmi

    fi = input_module("torch_fmi_inputs")
    bench_dir = WORK / "fmi_bench"
    bench_dir.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    fa, fq = fi.bench_input(bench_dir)
    gen_s = time.perf_counter() - t0
    bwt = pathlib.Path(str(fa) + ".bwt.2bit.64")
    bwt.unlink(missing_ok=True)          # the first run builds the index
    argv = [fa, fq, 512, 19, 1]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lines, out = fmi_cli(argv, "fmi_fasta")
    cli_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    roi_s = [float(timing_line(out, "Computing time").split()[2])]
    t0 = time.perf_counter()
    index, sa = fmi.build_index_artifacts(fmi.read_fasta_codes(str(fa)))
    build_s = time.perf_counter() - t0
    fmi.save_bwt2bit64(index, sa, str(bwt))
    lines2, out2 = fmi_cli(argv, "fmi_bwt")
    roi_s.append(float(timing_line(out2, "Computing time").split()[2]))
    if lines2 != lines:
        fail(f"fmi: the .bwt.2bit.64 route's {len(lines2)} SMEM lines differ "
             f"from the fasta route's {len(lines)}")
    t0 = time.perf_counter()
    want = fmi_cpu_lines(fa, fq, 512, 19, 2048)
    cpu_s = time.perf_counter() - t0
    if lines[:len(want)] != want:
        bad = next(i for i, (a, b) in enumerate(zip(lines, want)) if a != b)
        fail(f"fmi bench: the card's SMEM lines of the first 2048 reads vs "
             f"the CPU run's: first difference at line {bad}: "
             f"{lines[bad]!r} vs {want[bad]!r}")
    print(f"fmi bench cli: {timing_line(out, 'Computing time')} and "
          f"{timing_line(out2, 'Computing time')} (fasta, .bwt.2bit.64 "
          f"routes, equal), {timing_line(out, 'totalSmems')}; the first "
          f"2048 reads exact vs the CPU run ({len(want)} lines)")

    # small inputs whole, each on the card against the CPU run
    rng = np.random.default_rng
    small = [("n-rc", lambda d: fi.gen_case(d, rng(3), n_reads=64, err=0.08,
                                            with_n=True), 8, 19, {}),
             ("seed10", lambda d: fi.gen_case(d, rng(2), n_reads=64,
                                              err=0.02), 4, 10, {}),
             ("tandem", lambda d: fi.tandem_case(d, rng(5)), 8, 19, {}),
             ("wide", lambda d: fi.gen_case(d, rng(3), n_reads=64, err=0.08,
                                            with_n=True), 8, 19,
              {"GENARCH_FMI_FORCE_WIDE": "1"})]
    for name, make, batch, seed, env in small:
        d = WORK / f"fmi_{name}"
        d.mkdir(exist_ok=True)
        s_fa, s_fq = make(d)
        got, _ = fmi_cli([s_fa, s_fq, batch, seed, 1], f"fmi_{name}", env)
        want = fmi_cpu_lines(s_fa, s_fq, batch, seed)
        if got != want or not want:
            fail(f"fmi {name}: the card's {len(got)} SMEM lines vs the CPU "
                 f"run's {len(want)}")
        if name == "tandem":
            st = {}
            fmi.search_reads(fmi.FMISearch(fmi.load_index(str(s_fa))),
                             fmi.read_queries(str(s_fq)), batch, seed,
                             stats=st)
            retries = st["pass1_retries"]
            if not (retries.get(64) and retries.get(128)):
                fail(f"fmi tandem: the input missed the wide tiers: {st}")
        if name == "wide":
            with environ(env):
                wide = fmi.FMISearch(fmi.load_index(str(s_fa))).wide
            if not wide:
                fail("fmi wide: GENARCH_FMI_FORCE_WIDE=1 did not take the "
                     "int64-row path")
        print(f"fmi {name} cli: {len(got)} SMEM lines, exact vs the CPU run"
              + (f"; tier retries {retries}" if name == "tandem" else ""))

    # a warm run's numbers
    reads = fmi.read_queries(str(fq))
    gpu = fmi.FMISearch(index)
    fmi.search_reads(gpu, reads, 512, 19)                # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fmi.search_reads(gpu, reads, 512, 19)
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = {}
    fmi.search_reads(gpu, reads, 512, 19, stats=stats)
    prof, prof_ms = profiled(lambda: fmi.search_reads(gpu, reads, 512, 19))
    spans = ("restart", "pass1", "pass2", "pass3")
    launches = {sp: launches_in_spans(prof, f"fmi.{sp}") for sp in spans}
    steps = {"restart": stats["restart_steps"],
             "pass1": stats["pass1_fwd_steps"] + stats["pass1_bwd_steps"],
             "pass2": stats["pass2_fwd_steps"] + stats["pass2_bwd_steps"],
             "pass3": stats["pass3_steps"]}
    events, dev_ms = device_activity(prof, "fmi.")
    span_dev_ms, top = fmi_device_split(prof, spans)
    ext = stats["ext_pass1"] + stats["ext_pass2"] + stats["ext_pass3"]
    nbytes = sum(len(r) for r in reads) + 12 * stats["smems"]
    b_ms, b_by = bound_ms(nbytes, FMI_OPS_PER_EXT * ext)
    split = {k: stats[k] * 1e3 for k in ("prep_s", "h2d_s", "restart_s",
                                         "pass1_s", "pass2_s", "pass3_s",
                                         "sort_s")}
    row = dict(name="fmi", ms=wall_ms, reads=len(reads), smems=stats["smems"],
               items_pass1=stats["items_pass1"],
               items_pass2=stats["items_pass2"],
               hits_pass3=stats["hits_pass3"],
               retries_pass1=stats["pass1_retries"],
               retries_pass2=stats["pass2_retries"],
               chunks_pass1=stats["pass1_chunks"],
               chunks_pass2=stats["pass2_chunks"],
               restart_calls=stats["restart_calls"],
               seed_calls=stats["seed_calls"],
               steps=steps, fwd_bwd_steps={
                   p: (stats[f"{p}_fwd_steps"], stats[f"{p}_bwd_steps"])
                   for p in ("pass1", "pass2")},
               split_ms=split, launches=launches,
               launches_per_step={sp: launches[sp] / max(steps[sp], 1)
                                  for sp in spans},
               launches_total=sum(launches.values()),
               profiled_device_ms=dev_ms, device_events=events,
               profiled_ms=prof_ms, device_busy_share=dev_ms / prof_ms,
               device_ms_by_span=span_dev_ms, top_device_kernels=top,
               cli_roi_s=roi_s,
               reads_per_s=[len(reads) / t for t in roi_s],
               smems_per_s=[stats["smems"] / t for t in roi_s],
               extensions=ext, ext_restart=stats["ext_restart"],
               bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
               peak_gb=peak_gb, index_build_s=build_s,
               bench_input_s=gen_s, cli_fasta_wall_s=cli_s,
               cpu_2048_reads_s=cpu_s, card=card)
    print(f"fmi warm: {wall_ms:.1f} ms for {len(reads)} reads "
          f"({stats['items_pass1']} pass-1 items, {stats['items_pass2']} "
          f"pass-2 items, {stats['hits_pass3']} pass-3 hits, "
          f"{stats['smems']} SMEMs; retries pass 1 {stats['pass1_retries']}, "
          f"pass 2 {stats['pass2_retries']}; chunks {stats['pass1_chunks']} "
          f"+ {stats['pass2_chunks']}); with a sync at each boundary: "
          + ", ".join(f"{k[:-2]} {v:.1f}" for k, v in split.items())
          + " ms; launches (a loop step): "
          + ", ".join(f"{sp} {launches[sp]} ({row['launches_per_step'][sp]:.1f}"
                      f", {steps[sp]} steps)" for sp in spans)
          + f"; {dev_ms:.1f} ms of device activity in a profiled run, "
          f"{row['device_busy_share']:.1%} of its {prof_ms:.1f} ms; "
          f"{row['reads_per_s'][0]:.4e} reads/s, {row['smems_per_s'][0]:.4e} "
          f"SMEMs/s over the CLI's Computing time; bound {b_ms:.4f} ms "
          f"({b_by}: {ext} extensions); index build {build_s:.2f} s; peak "
          f"{peak_gb:.2f} GB")
    print("fmi device ms by span: " + ", ".join(
        f"{sp} {v:.1f}" for sp, v in span_dev_ms.items())
          + "; top kernels by device time:")
    for name, c, ms in top:
        print(f"  {ms:9.2f} ms {c:6d} x {ms * 1e3 / c:8.2f} us  {name[:90]}")
    return row


def fmi_device_split(prof, spans):
    """The card's kernel time in each `fmi.<span>` range of a profile (the
    ranges the profiler mirrors on the card's timeline) and the eight
    kernels with the most device time: ({span: ms}, [(name, count, ms)])."""
    import torch
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    ranges = {sp: [(e.time_range.start, e.time_range.end) for e in cuda
                   if e.name == f"fmi.{sp}"] for sp in spans}
    by_span = dict.fromkeys(spans, 0.0)
    by_name = {}
    for e in cuda:
        if e.name.startswith("fmi."):
            continue
        t, us = e.time_range.start, e.time_range.elapsed_us()
        for sp, rs in ranges.items():
            if any(a <= t <= b for a, b in rs):
                by_span[sp] += us / 1e3
        c = by_name.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return by_span, [(n, c, ms) for n, (c, ms) in top]


def kineto_summary(prof, prefix: str):
    """From a profile's raw kineto events (a long run has too many to
    build the profiler's event tree in time): for each host range whose
    name starts with prefix, (the cudaLaunch* calls, the cudaGraphLaunch
    calls) in it, and the card's activity outside those ranges' mirrors
    on its timeline, (events, ms)."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    spans, calls, dev_n, dev_ns = {}, [], 0, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cpu:
            if name.startswith(prefix):
                spans.setdefault(name, []).append((e.start_ns(), e.end_ns()))
            elif name.startswith("cudaLaunch") or name == "cudaGraphLaunch":
                calls.append((name == "cudaGraphLaunch", e.start_ns()))
        elif not name.startswith(prefix):
            dev_n += 1
            dev_ns += e.duration_ns()
    counts = {}
    for sp, ranges in spans.items():
        inside = [g for g, t in calls if any(a <= t <= b for a, b in ranges)]
        counts[sp] = (len(inside) - sum(inside), sum(inside))
    return counts, dev_n, dev_ns / 1e6


ABEA_ARGS = ("ranks", "ev_mean", "n_ev", "n_km", "shifts", "scales", "lm",
             "lsd", "llsd")


def abea_cli(paths, name: str, cpu: bool = False):
    """`cli run abea` over a case of tests/torch_abea_inputs.py (the .npy
    route), on the card or with GENARCH_DEVICE=cpu: (the TSV, the
    `Data processing time` seconds)."""
    out, errp = WORK / f"{name}.tsv", WORK / f"{name}.err"
    with environ({"GENARCH_DEVICE": "cpu"} if cpu else {}):
        run_cli(["run", "abea", "-b", str(paths["bam"]), "-g",
                 str(paths["ref"]), "-r", str(paths["npy"]), "--kmer-model",
                 str(paths["model"]), "-o", str(out)], errp)
    line = timing_line(errp.read_text(), "Data processing time")
    return out.read_text(), float(line.split()[3])


def abea_device_run(host, NB, graphed: bool, block: int):
    """abea's two device loops on the card over align_batch's host arrays
    (graphed, or the same blocks run eagerly): (the band scan's padded
    outputs, the pair lists, band ms, backtrace ms with the copy back)."""
    import torch
    from genarchbench_tpu_torch.kernels import abea
    d = abea._to_device(host, torch.device("cuda"))
    args = [d[k] for k in ABEA_ARGS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    band = abea._band_scan(*args, *d["lps"], NB, block, graphed)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = abea._to_host(abea._backtrace(*band, *args, d["lps"][3], NB, NB,
                                        block, graphed))
    t2 = time.perf_counter()
    return band, abea._pairs(*out, host["n_km"]), (t1 - t0) * 1e3, \
        (t2 - t1) * 1e3


def abea_small_inputs(model) -> list:
    """Small inputs on the card against the CPU: pair lists of mixed
    lengths (10-2000 bases) and of a batch with a QC failure; band scan
    and backtrace outputs, bit for bit, on a tie-heavy input and with a
    block longer than NB."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch.kernels import abea
    ai = input_module("torch_abea_inputs")
    rng = np.random.default_rng(21)
    mixed = [ai.random_seq(rng, n) for n in (10, 37, 150, 700, 2000, 1200)]
    mixed_ets = [abea.get_events(ai.synth_signal(rng, model, s))
                 for s in mixed]
    qc = [ai.random_seq(rng, n) for n in (220, 260, 180)]
    qc_ets = [abea.get_events(ai.synth_signal(rng, model, s)) for s in qc]
    qc_ets[1] = abea.get_events(ai.synth_signal(
        rng, model, ai.random_seq(rng, 260)))
    done = []
    for name, seqs, ets in (("mixed 10-2000", mixed, mixed_ets),
                            ("QC failure", qc, qc_ets)):
        card = abea.align_batch(seqs, ets, model)
        cpu = abea.align_batch(seqs, ets, model, device="cpu")
        if card != cpu or (name == "QC failure") != (not all(cpu)):
            fail(f"abea {name}: the card's pair lists differ from the CPU's "
                 f"(lengths {[len(p) for p in card]} vs "
                 f"{[len(p) for p in cpu]})")
        done.append(f"{name} ({[len(p) for p in card]} pairs)")
    for name, lengths, ties, block in (("ties", [90, 200, 150, 31], True, 64),
                                       ("block > NB", [20, 35], False, 128)):
        host, NB, NE, NK = ai.dyadic_host(np.random.default_rng(7), lengths,
                                          ties)
        outs = []
        for dev, blk in (("cuda", block), ("cpu", abea.BLOCK)):
            t = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            args = [t[k] for k in ABEA_ARGS]
            band = abea._band_scan(*args, *t["lps"], NB, blk, dev == "cuda")
            bt = abea._backtrace(*band, *args, t["lps"][3], NB, NB, blk,
                                 dev == "cuda")
            outs.append([x[:NB].cpu() if i < 3 else x.cpu()
                         for i, x in enumerate((*band, *bt))])
        if block > NB and abea.padded_bands(NB, block) - 2 != block:
            fail(f"abea {name}: NB {NB} is not below one block")
        bad = [i for i, (a, b) in enumerate(zip(*outs))
               if a.numpy().tobytes() != b.numpy().tobytes()]
        if bad:
            fail(f"abea {name}: outputs {bad} of (bands, traces, blls, "
                 f"fr_out, e0, n_al, sum_em, mgap, k_last) differ between "
                 f"the card and the CPU")
        done.append(f"{name} (NB {NB}, block {block})")
    return done


def abea_phase(card: str) -> dict:
    """abea through `cli run abea` at the JAX bench's input, its TSV held
    to the port's CPU run; the bench's warm pipeline; the graphed loops
    held bit for bit to the same blocks run eagerly, both timed, at
    blocks of 32, 64 and 128 (medians of rotating rounds); small inputs
    against the CPU; a warm run's split, launches a step, busy share,
    peak memory and bound."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch.io import bam_io
    from genarchbench_tpu_torch.kernels import abea

    ai = input_module("torch_abea_inputs")
    model = ai.synth_model(0)
    t0 = time.perf_counter()
    seqs, sigs = ai.bench_input(model)
    bench = WORK / "abea_bench"
    bench.mkdir(exist_ok=True)
    paths = ai.write_cli_case(bench, model, seqs, sigs, bam_io)
    gen_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    tsv, roi_s = abea_cli(paths, "abea_bench")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first = WORK / "abea_first64"
    first.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    cpu64, cpu64_roi = abea_cli(
        ai.write_cli_case(first, model, seqs[:64], sigs[:64], bam_io),
        "abea_cpu64", cpu=True)
    cpu64_s = time.perf_counter() - t0
    cpu_s = cpu_roi = None
    if cpu64_s * 4 <= 60:           # the whole input on the CPU too
        t0 = time.perf_counter()
        want, cpu_roi = abea_cli(paths, "abea_cpu", cpu=True)
        cpu_s = time.perf_counter() - t0
        got, compared = tsv, len(seqs)
    else:
        got = "".join(ln for i, ln in enumerate(tsv.splitlines(True))
                      if i == 0 or int(ln.split("\t")[3]) < 64)
        want, compared = cpu64, 64
    if got != want:
        a, b = got.splitlines(), want.splitlines()
        bad = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   min(len(a), len(b)))
        fail(f"abea bench: the card's TSV vs the CPU run's on {compared} "
             f"reads: {len(a)} vs {len(b)} lines, first difference at line "
             f"{bad}")
    n_rows = tsv.count("\n") - 1
    print(f"abea bench cli: Data processing time {roi_s:.3f} s, {n_rows} "
          f"rows; TSV byte for byte equal to the CPU run's on {compared} "
          f"reads (CPU: 64 reads {cpu64_s:.1f} s"
          + (f", 256 reads {cpu_s:.1f} s" if cpu_s else "") + ")")

    def pipeline():                 # bench.py:412-419
        ets = [abea.get_events(s) for s in sigs]
        return ets, abea.align_batch(seqs, ets, model)

    pipeline()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ets, pairs = pipeline()
    pipe_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ets = [abea.get_events(s) for s in sigs]
    events_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    abea.align_batch(seqs, ets, model)
    align_ms = (time.perf_counter() - t0) * 1e3
    stats = {}
    abea.align_batch(seqs, ets, model, stats=stats)
    t0 = time.perf_counter()
    sink = io.StringIO()
    for i, (sq, et, pr) in enumerate(zip(seqs, ets, pairs)):
        sh, sc = abea.estimate_scalings(sq, et, model)
        abea.write_eventalign(sink, "tig1", 2000 * i, sq, pr, et, model, sh,
                              sc, i)
    emit_ms = (time.perf_counter() - t0) * 1e3
    cells = sum((len(e) + len(s) - abea.KMER + 1) * abea.BANDWIDTH
                for s, e in zip(seqs, ets))

    # the graphed loops against the same blocks run eagerly on the card
    host, NB, NE, NK = abea._host_inputs(seqs, ets, model)
    graphed = abea_device_run(host, NB, True, abea.BLOCK)
    eager = abea_device_run(host, NB, False, abea.BLOCK)
    for name, g, e in zip(("bands", "traces", "blls"), graphed[0], eager[0]):
        if g[:NB].cpu().numpy().tobytes() != e[:NB].cpu().numpy().tobytes():
            fail(f"abea: the graphed {name} differ from the eager blocks'")
    if not graphed[1] == eager[1] == pairs:
        fail("abea: the graphed, eager and align_batch pair lists differ")
    e_band_ms, e_bt_ms = eager[2], eager[3]
    del eager
    # the block lengths in rotating order, so that each runs first, second
    # and third in as many rounds: per length the median band and
    # backtrace ms, and the rounds in which it beat abea.BLOCK
    runs = {block: [] for block in ABEA_BLOCKS}
    for r in range(ABEA_BLOCK_ROUNDS):
        for block in ABEA_BLOCKS[r % 3:] + ABEA_BLOCKS[:r % 3]:
            _, p, band_ms, bt_ms = abea_device_run(host, NB, True, block)
            if p != pairs:
                fail(f"abea: blocks of {block} give other pair lists")
            runs[block].append((band_ms, bt_ms))
    by_block = {block: [statistics.median(x) for x in zip(*v)]
                for block, v in runs.items()}
    wins = {block: sum(sum(a) < sum(b) for a, b in zip(v, runs[abea.BLOCK]))
            for block, v in runs.items() if block != abea.BLOCK}

    small = abea_small_inputs(model)

    # launches a step: the graphed bench run, and an eager run of 4 reads
    t0 = time.perf_counter()
    prof, prof_ms = profiled(lambda: abea.align_batch(seqs, ets, model))
    calls, events, dev_ms = kineto_summary(prof, "abea.")
    prof_wall_s = time.perf_counter() - t0
    del prof
    kernels = {sp: calls.get(f"abea.{sp}", (0, 0))[0]
               for sp in ("band", "backtrace")}
    graphs = {sp: calls.get(f"abea.{sp}", (0, 0))[1]
              for sp in ("band", "backtrace")}
    rng = np.random.default_rng(22)
    few = [ai.random_seq(rng, 300) for _ in range(4)]
    few_ets = [abea.get_events(ai.synth_signal(rng, model, s)) for s in few]
    few_stats = {}
    eprof, _ = profiled(lambda: abea._align(
        few, few_ets, model, torch.device("cuda"), few_stats, graphed=False))
    ecalls = kineto_summary(eprof, "abea.")[0]
    eager_launches = {sp: sum(ecalls.get(f"abea.{sp}", (0, 0)))
                      for sp in ("band", "backtrace")}
    del eprof
    # steps run: the band scan's padding steps count, as they launch
    steps = {"band": stats["band_blocks"] * stats["block"],
             "backtrace": stats["bt_steps"]}
    few_steps = {"band": few_stats["band_blocks"] * few_stats["block"],
                 "backtrace": few_stats["bt_steps"]}

    B = len(seqs)
    nbytes = NB * B * abea.BANDWIDTH * 5 + sum(a.nbytes for a in host.values())
    ops = (NB - 2) * B * abea.BANDWIDTH * ABEA_OPS_PER_CELL
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP64_FLOPS
    b_ms, b_by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                             else "operations")
    split = {k: stats[k] * 1e3 for k in ("prep_s", "h2d_s", "band_s",
                                         "backtrace_s", "d2h_s", "pairs_s")}
    row = dict(name="abea", route="torch ops replayed in CUDA graphs",
               reads=B, bases=sum(len(s) for s in seqs), nb=NB, ne=NE, nk=NK,
               events=sum(len(e) for e in ets), rows=n_rows,
               band_steps=stats["band_steps"], bt_steps=stats["bt_steps"],
               band_blocks=stats["band_blocks"],
               bt_blocks=stats["bt_blocks"], block=abea.BLOCK,
               ms=graphed[2] + graphed[3], plain_ms=e_band_ms + e_bt_ms,
               library_ms=None, graphed_band_ms=graphed[2],
               graphed_backtrace_ms=graphed[3], eager_band_ms=e_band_ms,
               eager_backtrace_ms=e_bt_ms,
               align_ms=align_ms, split_ms=split, emit_ms=emit_ms,
               events_s=events_s, pipeline_s=pipe_s,
               reads_per_s=B / pipe_s, band_cells=cells,
               band_cells_per_s=cells / pipe_s, cli_roi_s=roi_s,
               cli_band_cells_per_s=cells / roi_s, cpu_cli_64_s=cpu64_s,
               cpu_cli_64_roi_s=cpu64_roi, cpu_cli_256_s=cpu_s,
               cpu_cli_256_roi_s=cpu_roi, tsv_reads_compared=compared,
               by_block_ms=by_block, by_block_runs_ms=runs,
               by_block_wins=wins, kernel_launches=kernels,
               graph_launches=graphs,
               launches_per_step={sp: (kernels[sp] + graphs[sp]) / steps[sp]
                                  for sp in steps},
               eager_launches_per_step={
                   sp: eager_launches[sp] / few_steps[sp] for sp in steps},
               profiled_device_ms=dev_ms, device_events=events,
               profiled_ms=prof_ms, device_busy_share=dev_ms / prof_ms,
               profile_wall_s=prof_wall_s, peak_gb=peak_gb, bound_ms=b_ms,
               bound_by=b_by, bound_bytes=nbytes, bound_f64_ops=ops,
               bench_input_s=gen_s, small_inputs=small, card=card)
    print(f"abea bench pipeline (get_events + align_batch, warm): "
          f"{pipe_s:.3f} s, {row['reads_per_s']:.2f} reads/s, "
          f"{row['band_cells_per_s']:.4e} band cells/s ({cells} cells); "
          f"get_events {events_s:.3f} s, align_batch {align_ms:.1f} ms; "
          f"with a sync at each boundary: "
          + ", ".join(f"{k[:-2]} {v:.1f}" for k, v in split.items())
          + f" ms; NB {NB} ({stats['band_steps']} band steps in "
          f"{stats['band_blocks']} blocks, {stats['bt_steps']} backtrace "
          f"steps in {stats['bt_blocks']}); eventalign rows "
          f"{emit_ms:.1f} ms for {n_rows}")
    print(f"abea graphed vs eager blocks on the card (bands, traces, blls "
          f"and pairs bit for bit equal): band {graphed[2]:.1f} vs "
          f"{e_band_ms:.1f} ms, backtrace {graphed[3]:.1f} vs {e_bt_ms:.1f} "
          f"ms; graphed by block length (median of {ABEA_BLOCK_ROUNDS} "
          f"rotating rounds): " + ", ".join(
              f"{k}: {a:.1f} + {b:.1f} ms" for k, (a, b) in by_block.items())
          + f"; rounds faster than {abea.BLOCK} in all: " + ", ".join(
              f"{k}: {w} of {ABEA_BLOCK_ROUNDS}" for k, w in wins.items()))
    print(f"abea launches: graphed run {kernels} kernel launches and "
          f"{graphs} graph launches in the spans, "
          + ", ".join(f"{sp} {v:.2f} a step" for sp, v in
                      row["launches_per_step"].items())
          + "; eager blocks " + ", ".join(
              f"{sp} {v:.1f} a step" for sp, v in
              row["eager_launches_per_step"].items())
          + f"; {dev_ms:.1f} ms of device activity ({events} events) in a "
          f"profiled run, {row['device_busy_share']:.1%} of its "
          f"{prof_ms:.1f} ms (profile read in {prof_wall_s:.1f} s); bound "
          f"{b_ms:.4f} ms ({b_by}); peak {peak_gb:.2f} GB; small inputs "
          f"equal to the CPU: " + "; ".join(small))
    return row


POA_CLOSED = (2, -4, -6, -2, -28, -1)      # m, n, g, e, q, c: the defaults
POA_GENERAL = (2, -4, -6, -4, -2, -1)      # -o 2,1 -e 4,1: the max-plus scan
POA_OPS_PER_CELL = 36
POA_OPS_PER_PRED_CELL = 19
POA_CPU_WINDOWS = 32
POA_BLOCKS = (4, 8)
POA_BLOCK_ROUNDS = 4


def poa_cli(path: pathlib.Path, name: str, cpu: bool = False, flags=()):
    """`cli run poa -s path` on the card or with GENARCH_DEVICE=cpu: (the
    stdout, the `Runtime:` seconds)."""
    with environ({"GENARCH_DEVICE": "cpu"} if cpu else {}):
        out = run_cli(["run", "poa", "-s", str(path), *flags],
                      WORK / f"{name}.err")
    line = timing_line((WORK / f"{name}.err").read_text(), "Runtime:")
    return out, float(line.split()[1].rstrip(","))


def poa_rounds(batches, engine, stats=None):
    """consensus_for_batches' rounds, keeping each round's raw walks:
    (the walks by round, the consensus strings)."""
    from genarchbench_tpu_torch.kernels import poa
    graphs = [poa.new_graph() for _ in batches]
    walks = []
    for s in range(max(len(b) for b in batches)):
        idx = [w for w, b in enumerate(batches) if s < len(b)]
        got = engine.align_many([batches[w][s] for w in idx],
                                [graphs[w] for w in idx], stats)
        walks.append(got)
        for k, w in enumerate(idx):
            graphs[w].add_walk(got[k], batches[w][s])
    return walks, [g.generate_consensus() for g in graphs]


def same_walks(a, b) -> bool:
    """Two runs' walks by round, bit for bit."""
    import numpy as np
    return all((x is None and y is None) or (
        x is not None and y is not None
        and all(np.array_equal(u, v) for u, v in zip(x, y)))
        for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def poa_small_inputs() -> list:
    """The DP's planes and start rows and the walks, card (graphed) against
    CPU, bit for bit, on random rounds at P = 1, 2, 4, 8 in both regimes
    and at blocks of 7 and longer than the graph; `cli run poa` on small
    inputs (the general scan, identical reads, uneven windows with empty
    reads) against the CPU run."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch.kernels import poa
    pi = input_module("torch_poa_inputs")
    done = []
    for pen, regime in ((POA_CLOSED, "closed"), (POA_GENERAL, "general")):
        for P, block in ((1, poa.BLOCK), (2, 7), (4, poa.BLOCK),
                         (8, 128)):
            arrays, nrows = pi.random_round(np.random.default_rng(P), 16,
                                            120, 100, P, pen)
            outs = []
            for dev, blk in (("cuda", block), ("cpu", poa.BLOCK)):
                t = [torch.from_numpy(arrays[k]).to(dev) for k in pi.ROUND]
                planes, start = poa._convex_dp_rows(*t, nrows, pen, blk)
                wi, wj = poa._poa_walk(planes, start, t[-1],
                                       120 + t[1].shape[1] + 4, blk)
                outs.append([x.cpu().numpy() for x in (
                    planes[:, :nrows + 1, 0], planes[:, :nrows + 1, 1],
                    start, wi, wj)])
            bad = [i for i, (a, b) in enumerate(zip(*outs))
                   if a.tobytes() != b.tobytes()]
            if bad:
                fail(f"poa {regime} P={P} block {block}: outputs {bad} of "
                     f"(plane1, plane2, start_i, outi, outj) differ between "
                     f"the card and the CPU")
            done.append(f"{regime} P={P} block {block}")
    rng = np.random.default_rng(31)
    for name, text, flags in (
            ("general scan", pi.batches_text(rng, (6, 8, 5), 90, 0.12),
             ["-o", "2,1", "-e", "4,1"]),
            ("identical reads",
             "s0_0\nACGTACGTGG\ns1_1\nACGTACGTGG\ns1_2\nACGTACGTGG\n", []),
            ("uneven windows", pi.batches_text(
                rng, (3, 7, 1, 5), 60, 0.1, empty={(1, 2), (3, 0)}), [])):
        path = WORK / f"poa_small_{len(done)}.fa"
        path.write_text(text)
        card, _ = poa_cli(path, "poa_small", flags=flags)
        cpu, _ = poa_cli(path, "poa_small_cpu", cpu=True, flags=flags)
        if card != cpu:
            fail(f"poa {name}: the card's consensus lines differ from the "
                 f"CPU run's")
        done.append(name)
    return done


def poa_phase(card: str) -> dict:
    """poa through `cli run poa` at the JAX bench's input, its consensus
    lines held exactly to the port's CPU run; the graphed DP and walk held
    bit for bit to the same blocks run eagerly on the card, both timed,
    and timed at each of POA_BLOCKS; small inputs against the CPU; a warm run's split, launches a DP row
    and a walk step, busy share, peak memory, cells/s and bound."""
    import torch
    from genarchbench_tpu_torch.kernels import poa

    phase_t0 = time.perf_counter()
    pi = input_module("torch_poa_inputs")
    t0 = time.perf_counter()
    text = pi.bench_input()
    bench = WORK / "poa_bench.fa"
    bench.write_text(text)
    gen_s = time.perf_counter() - t0
    batches = poa.read_batches(str(bench))

    torch.cuda.reset_peak_memory_stats()
    out, roi_s = poa_cli(bench, "poa_bench")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cons = out.splitlines()[1::2]
    first = WORK / "poa_first.fa"
    first.write_text("".join(text.splitlines(True)[:POA_CPU_WINDOWS * 20]))
    t0 = time.perf_counter()
    cpu_first, cpu_first_roi = poa_cli(first, "poa_cpu_first", cpu=True)
    cpu_first_s = time.perf_counter() - t0
    cpu_s = cpu_roi = None
    if cpu_first_s * len(batches) / POA_CPU_WINDOWS <= 30:
        t0 = time.perf_counter()
        want, cpu_roi = poa_cli(bench, "poa_cpu", cpu=True)
        cpu_s = time.perf_counter() - t0
        got, compared = out, len(batches)
    else:
        got, want = "".join(out.splitlines(True)[:POA_CPU_WINDOWS * 2]), \
            cpu_first
        compared = POA_CPU_WINDOWS
    if got != want or len(cons) != len(batches):
        fail(f"poa bench: the card's consensus lines vs the CPU run's on "
             f"{compared} windows differ ({len(cons)} windows)")
    print(f"poa bench cli: Runtime {roi_s:.3f} s, {len(cons)} consensus "
          f"lines of {min(map(len, cons))}-{max(map(len, cons))} bases, "
          f"equal to the CPU run's on {compared} windows (CPU: "
          f"{POA_CPU_WINDOWS} windows {cpu_first_s:.1f} s"
          + (f", {len(batches)} windows {cpu_s:.1f} s" if cpu_s else "")
          + ")")

    # a warm run's split, then the graphed rounds against eager blocks
    stats = {}
    t0 = time.perf_counter()
    warm = poa.consensus_for_batches(batches, poa.ConvexNWEngine(), stats)
    warm_s = time.perf_counter() - t0
    if warm != cons:
        fail("poa: a warm consensus_for_batches differs from the CLI's")
    g_stats, e_stats = {}, {}
    graphed, g_cons = poa_rounds(batches, poa.ConvexNWEngine(), g_stats)
    eager_engine = poa.ConvexNWEngine()
    eager_engine.graphed = False
    eager, e_cons = poa_rounds(batches, eager_engine, e_stats)
    if not same_walks(graphed, eager) or g_cons != e_cons or g_cons != cons:
        fail("poa: the graphed DP and walk give other walks than the same "
             "blocks run eagerly on the card")
    g_ms = {k: g_stats[k] * 1e3 for k in ("dp_s", "walk_s")}
    e_ms = {k: e_stats[k] * 1e3 for k in ("dp_s", "walk_s")}
    del graphed, eager
    # the block lengths in rotating order, so that each runs first as
    # often: per length the median DP and walk ms, and the rounds in
    # which it beat poa.BLOCK
    default = poa.BLOCK
    runs = {block: [] for block in POA_BLOCKS}
    try:
        for r in range(POA_BLOCK_ROUNDS):
            k = r % len(POA_BLOCKS)
            for block in POA_BLOCKS[k:] + POA_BLOCKS[:k]:
                poa.BLOCK = block
                b_stats = {}
                if poa.consensus_for_batches(batches, poa.ConvexNWEngine(),
                                             b_stats) != cons:
                    fail(f"poa: blocks of {block} give other consensus "
                         f"lines")
                runs[block].append((b_stats["dp_s"] * 1e3,
                                    b_stats["walk_s"] * 1e3))
    finally:
        poa.BLOCK = default
    by_block = {block: [statistics.median(x) for x in zip(*v)]
                for block, v in runs.items()}
    wins = {block: sum(sum(a) < sum(b) for a, b in zip(v, runs[default]))
            for block, v in runs.items() if block != default}

    small = poa_small_inputs()

    # launches a DP row and a walk step: the graphed bench run, and an
    # eager run of 2 windows of 3 reads
    t0 = time.perf_counter()
    prof, prof_ms = profiled(lambda: poa.consensus_for_batches(
        batches, poa.ConvexNWEngine()))
    calls, events, dev_ms = kineto_summary(prof, "poa.")
    prof_wall_s = time.perf_counter() - t0
    del prof
    spans = ("dp", "walk")
    kernels = {sp: calls.get(f"poa.{sp}", (0, 0))[0] for sp in spans}
    graphs = {sp: calls.get(f"poa.{sp}", (0, 0))[1] for sp in spans}
    few_stats = {}
    eprof, _ = profiled(lambda: poa.consensus_for_batches(
        [b[:3] for b in batches[:2]], eager_engine, few_stats))
    ecalls = kineto_summary(eprof, "poa.")[0]
    del eprof
    eager_launches = {sp: sum(ecalls.get(f"poa.{sp}", (0, 0))) for sp in spans}
    steps = {"dp": stats["dp_rows"], "walk": stats["walk_steps"]}
    few_steps = {"dp": few_stats["dp_rows"], "walk": few_stats["walk_steps"]}

    nbytes = stats["cells"] * 20 + stats["pred_cells"] * 12
    ops = (stats["cells"] * POA_OPS_PER_CELL
           + stats["pred_cells"] * POA_OPS_PER_PRED_CELL)
    b_ms, b_by = bound_ms(nbytes, ops)
    split = {k: stats[k] * 1e3 for k in (
        "export_s", "prep_s", "h2d_s", "dp_s", "walk_s", "d2h_s", "update_s",
        "consensus_s")}
    phase_s = time.perf_counter() - phase_t0
    row = dict(name="poa", route="torch ops replayed in CUDA graphs",
               windows=len(batches), reads=sum(map(len, batches)),
               rounds=stats["rounds"], dispatches=stats["dispatches"],
               dp_rows=stats["dp_rows"], dp_blocks=stats["dp_blocks"],
               walk_steps=stats["walk_steps"],
               walk_blocks=stats["walk_blocks"], block=poa.BLOCK,
               ms=g_ms["dp_s"] + g_ms["walk_s"],
               plain_ms=e_ms["dp_s"] + e_ms["walk_s"], library_ms=None,
               graphed_dp_ms=g_ms["dp_s"], graphed_walk_ms=g_ms["walk_s"],
               eager_dp_ms=e_ms["dp_s"], eager_walk_ms=e_ms["walk_s"],
               by_block_ms=by_block, by_block_runs_ms=runs,
               by_block_wins=wins,
               cli_roi_s=roi_s, warm_s=warm_s, split_ms=split,
               cells=stats["cells"], pred_cells=stats["pred_cells"],
               dp_cells=stats["dp_cells"], cells_per_s=stats["cells"] / warm_s,
               cli_cells_per_s=stats["cells"] / roi_s,
               cpu_first_windows=POA_CPU_WINDOWS, cpu_first_s=cpu_first_s,
               cpu_first_roi_s=cpu_first_roi, cpu_all_s=cpu_s,
               cpu_all_roi_s=cpu_roi, windows_compared=compared,
               kernel_launches=kernels, graph_launches=graphs,
               launches_per_step={sp: (kernels[sp] + graphs[sp]) / steps[sp]
                                  for sp in spans},
               eager_launches_per_step={
                   sp: eager_launches[sp] / few_steps[sp] for sp in spans},
               profiled_device_ms=dev_ms, device_events=events,
               profiled_ms=prof_ms, device_busy_share=dev_ms / prof_ms,
               profile_wall_s=prof_wall_s, peak_gb=peak_gb, bound_ms=b_ms,
               bound_by=b_by, bound_bytes=nbytes, bound_int32_ops=ops,
               bench_input_s=gen_s, phase_s=phase_s, small_inputs=small,
               card=card)
    print(f"poa warm consensus_for_batches: {warm_s:.3f} s, "
          f"{row['cells_per_s']:.4e} cells/s ({stats['cells']} rank x query "
          f"cells, {stats['dp_cells']} run); with a sync at each boundary: "
          + ", ".join(f"{k[:-2]} {v:.1f}" for k, v in split.items())
          + f" ms; {stats['rounds']} rounds, {stats['dispatches']} "
          f"dispatches, {stats['dp_rows']} DP rows in {stats['dp_blocks']} "
          f"blocks, {stats['walk_steps']} walk steps in "
          f"{stats['walk_blocks']}")
    print(f"poa graphed vs eager blocks on the card (every round's walks "
          f"and the consensus equal): DP {g_ms['dp_s']:.1f} vs "
          f"{e_ms['dp_s']:.1f} ms, walk {g_ms['walk_s']:.1f} vs "
          f"{e_ms['walk_s']:.1f} ms; graphed by block length (median of "
          f"{POA_BLOCK_ROUNDS} rotating rounds): " + ", ".join(
              f"{k}: {a:.1f} + {b:.1f} ms" for k, (a, b) in by_block.items())
          + f"; rounds faster than {default} in all: " + ", ".join(
              f"{k}: {w} of {POA_BLOCK_ROUNDS}" for k, w in wins.items()))
    print(f"poa launches: graphed run {kernels} kernel launches and "
          f"{graphs} graph launches in the spans, "
          + ", ".join(f"{sp} {v:.2f} a step" for sp, v in
                      row["launches_per_step"].items())
          + "; eager blocks " + ", ".join(
              f"{sp} {v:.1f} a step" for sp, v in
              row["eager_launches_per_step"].items())
          + f"; {dev_ms:.1f} ms of device activity ({events} events) in a "
          f"profiled run, {row['device_busy_share']:.1%} of its "
          f"{prof_ms:.1f} ms (profile read in {prof_wall_s:.1f} s); bound "
          f"{b_ms:.4f} ms ({b_by}: {nbytes} bytes, {ops} int32 operations); "
          f"peak {peak_gb:.2f} GB; small inputs equal to the CPU: "
          + "; ".join(small) + f"; phase {phase_s:.1f} s")
    return row


KMER_K = 17
KMER_BIG_READS = 1200          # bench.py's BENCH_KMER_READS x 10
KMER_REPS = 5
DBG_SUBREGION = "tig1:100001-103000"     # 4 windows of about 10 MB each
PILEUP_REPS = 20


def kmer_cli(reads, cfg, name: str, cpu: bool = False):
    """`cli run kmer-cnt` at --min-ovlp 5000 on the card or with
    GENARCH_DEVICE=cpu: (the `Total k-mers` count, the `Minimizers` line,
    the `Kernel time` seconds)."""
    with environ({"GENARCH_DEVICE": "cpu"} if cpu else {}):
        run_cli(["run", "kmer-cnt", "--reads", str(reads), "--config",
                 str(cfg)], WORK / f"{name}.err")
    err = (WORK / f"{name}.err").read_text()
    return (int(timing_line(err, "Total k-mers").split()[-1]),
            timing_line(err, "Minimizers"),
            float(timing_line(err, "Kernel time:").split()[2]))


def kmer_size(path, cfg, name: str) -> dict:
    """One read set through `cli run kmer-cnt`, card against CPU; a warm
    run's split, launches in the `kmer.codes` / `kmer.count` spans, busy
    share; the codes and the count timed by CUDA events, the count
    against torch.unique; peak memory and bound."""
    import torch
    from genarchbench_tpu_torch.io.fasta_io import read_fasta
    from genarchbench_tpu_torch.kernels import kmer

    torch.cuda.reset_peak_memory_stats()
    total, _, roi_s = kmer_cli(path, cfg, f"kmer_{name}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    cpu_total, _, cpu_roi_s = kmer_cli(path, cfg, f"kmer_{name}_cpu",
                                       cpu=True)
    cpu_s = time.perf_counter() - t0
    if total != cpu_total:
        fail(f"kmer-cnt {name}: Total k-mers {total} on the card, "
             f"{cpu_total} on the CPU")

    reads = read_fasta(str(path), min_len=5000)
    stats = {}
    t0 = time.perf_counter()
    if kmer.count_distinct(reads, KMER_K, stats=stats) != total:
        fail(f"kmer-cnt {name}: a warm count_distinct differs from the CLI")
    warm_s = time.perf_counter() - t0
    cpu_stats = {}
    kmer.count_distinct(reads, KMER_K, device="cpu", stats=cpu_stats)
    prof, prof_ms = profiled(lambda: kmer.count_distinct(reads, KMER_K))
    calls, events, dev_ms = kineto_summary(prof, "kmer.")
    del prof
    launches = {sp: calls.get(f"kmer.{sp}", (0, 0))[0]
                for sp in ("codes", "count")}

    batches = [(torch.from_numpy(a).cuda(), torch.from_numpy(n).cuda())
               for a, n in kmer._batches(reads, KMER_K, 1 << 25)]
    codes = torch.cat([kmer._codes_device(a, n, KMER_K).reshape(-1)
                       for a, n in batches])

    def library():
        u, c = torch.unique(codes, return_counts=True)
        return ((c + 255) // 256)[u < kmer.SENTINEL].sum()

    if int(library()) != total:
        fail(f"kmer-cnt {name}: torch.unique's count differs")
    codes_ms = event_ms(lambda: [kmer._codes_device(a, n, KMER_K)
                                 for a, n in batches], KMER_REPS)
    count_ms = event_ms(lambda: kmer._distinct_count_device(codes),
                        KMER_REPS)
    library_ms = event_ms(library, KMER_REPS)
    N = codes.numel()
    nbytes = sum(a.numel() for a, _ in batches) + 32 * N
    b_ms, b_by = bound_ms(nbytes, 4 * KMER_K * N)
    del batches, codes
    row = dict(total=total, reads=len(reads), bases=sum(map(len, reads.seqs)),
               codes=N, batches=stats["batches"], cli_roi_s=roi_s,
               cpu_roi_s=cpu_roi_s, cpu_cli_s=cpu_s, warm_s=warm_s,
               split_ms={k: stats[k] * 1e3 for k in (
                   "pack_s", "h2d_s", "codes_s", "count_s")},
               cpu_split_ms={k: cpu_stats[k] * 1e3 for k in (
                   "pack_s", "h2d_s", "codes_s", "count_s")},
               codes_ms=codes_ms, count_ms=count_ms, library_ms=library_ms,
               ms=codes_ms + count_ms,
               plain_ms=(cpu_stats["codes_s"] + cpu_stats["count_s"]) * 1e3,
               launches=launches, profiled_device_ms=dev_ms,
               device_events=events, profiled_ms=prof_ms,
               device_busy_share=dev_ms / prof_ms, peak_gb=peak_gb,
               bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
               bound_int32_ops=4 * KMER_K * N)
    print(f"kmer-cnt {name} ({len(reads)} reads, {row['bases']} bases): "
          f"Total k-mers {total} on the card and the CPU; Kernel time "
          f"{roi_s:.3f} s (CPU {cpu_roi_s:.3f} s); warm {warm_s * 1e3:.1f} "
          f"ms: " + ", ".join(f"{k[:-2]} {v:.1f}" for k, v in
                              row["split_ms"].items())
          + f" ms ({stats['batches']} batches, {N} codes); CUDA events: "
          f"codes {codes_ms:.3f} ms, count {count_ms:.3f} ms, torch.unique "
          f"{library_ms:.3f} ms; launches {launches}; {dev_ms:.1f} ms of "
          f"device activity ({events} events), busy "
          f"{row['device_busy_share']:.1%} of {prof_ms:.1f} ms; peak "
          f"{peak_gb:.2f} GB; bound {b_ms:.4f} ms ({b_by})")
    return row


def kmer_phase(card: str) -> dict:
    """kmer-cnt through `cli run kmer-cnt` at bench.py's input (120 reads of
    20000 +- 2000 bases, k = 17, --min-ovlp 5000) and at ten times its
    reads, each count equal to the port's CPU run; the minimizer route
    (use_minimizers = 1, window 5) equal to the CPU run; each size's
    split, launches, busy share, peak memory and bound."""
    phase_t0 = time.perf_counter()
    ki = input_module("torch_kmer_inputs")
    t0 = time.perf_counter()
    bench, big = WORK / "kmer_bench.fa", WORK / "kmer_bench10.fa"
    ki.bench_fasta(bench)
    ki.bench_fasta(big, n_reads=KMER_BIG_READS)
    cfg, mcfg = WORK / "kmer.cfg", WORK / "kmer_min.cfg"
    ki.write_config(cfg, k=KMER_K)
    ki.write_config(mcfg, k=KMER_K, use_minimizers=1, window=5)
    gen_s = time.perf_counter() - t0
    sizes = {"bench": kmer_size(bench, cfg, "bench"),
             "bench10": kmer_size(big, cfg, "bench10")}
    m_total, m_line, m_roi = kmer_cli(bench, mcfg, "kmer_min")
    c_total, c_line, c_roi = kmer_cli(bench, mcfg, "kmer_min_cpu", cpu=True)
    if not m_line or (m_total, m_line) != (c_total, c_line):
        fail(f"kmer-cnt minimizers: {m_line!r} on the card, {c_line!r} on "
             f"the CPU")
    phase_s = time.perf_counter() - phase_t0
    b = sizes["bench"]
    print(f"kmer-cnt minimizers: {m_line.strip()}, equal to the CPU run; "
          f"Kernel time {m_roi:.3f} s (CPU {c_roi:.3f} s, host-only route); "
          f"inputs written in {gen_s:.1f} s; phase {phase_s:.1f} s")
    return dict(name="kmer-cnt", route="torch ops", ms=b["ms"],
                plain_ms=b["plain_ms"], library_ms=b["library_ms"],
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                launches=b["launches"], sizes=sizes,
                minimizers=dict(line=m_line.strip(), roi_s=m_roi,
                                cpu_roi_s=c_roi),
                bench_input_s=gen_s, phase_s=phase_s, card=card)


def dbg_phase(card: str) -> dict:
    """dbg at bench.py's input (500 kb reference, 25,000 reads of 150
    bases, seed 108): the card's admissibility masks equal to the CPU's
    for every read, the mask timed by CUDA events against its plain
    version and a max-pool; `cli run dbg` over the whole region at
    verbose 0 for the timing line; a sub-region at verbose 1 sorted-equal
    to the CPU run; launches, busy share, bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from genarchbench_tpu_torch.io import bam_io
    from genarchbench_tpu_torch.kernels import dbg

    phase_t0 = time.perf_counter()
    di = input_module("torch_dbg_inputs")
    d = WORK / "dbg"
    d.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    bam, fa = di.bench_case(d, bam_io)
    gen_s = time.perf_counter() - t0

    _, records = bam_io.read_bam(str(bam))
    seqs = [r.seq for r in records]
    quals = [r.qual for r in records]
    t0 = time.perf_counter()
    card_m = dbg._window_min_mask(seqs, quals)
    mask_s = time.perf_counter() - t0
    cpu_m = dbg._window_min_mask(seqs, quals, device="cpu")
    if not all(np.array_equal(a, b) for x, y in zip(card_m, cpu_m)
               for a, b in zip(x, y)):
        fail("dbg: the card's admissibility masks differ from the CPU's")
    isn, q, _, lens = dbg._mask_inputs(seqs, quals)
    args = [torch.from_numpy(a).cuda() for a in (isn, q, lens)]
    ms = event_ms(lambda: dbg._admissible_device(*args, dbg.KMER), 20)
    cpu_args = [a.cpu() for a in args]
    t0 = time.perf_counter()
    dbg._admissible_device(*cpu_args, dbg.KMER)
    plain_ms = (time.perf_counter() - t0) * 1e3
    m = torch.where(args[0], -1, args[1]).float()

    def library():
        run_min = -F.max_pool1d(-m[:, None], dbg.KMER + 1, 1)[:, 0]
        return torch.cat([run_min, m.new_full((m.shape[0], dbg.KMER),
                                              dbg.QUAL_PAD)], 1)

    want = dbg._admissible_device(*args, dbg.KMER)
    pos = torch.arange(m.shape[1], device=m.device)
    got = (library() >= dbg.MIN_QUAL) & (pos < args[2][:, None] - dbg.KMER)
    if not torch.equal(got, want):
        fail("dbg: the max-pool running minimum differs from the mask")
    library_ms = event_ms(library, 20)
    prof, prof_ms = profiled(lambda: dbg._window_min_mask(seqs, quals))
    calls, events, dev_ms = kineto_summary(prof, "dbg.")
    del prof
    launches = calls.get("dbg.mask", (0, 0))[0]
    nbytes = isn.nbytes + q.nbytes + lens.nbytes + isn.size
    b_ms, b_by = bound_ms(nbytes, 6 * isn.size)

    torch.cuda.reset_peak_memory_stats()
    argv = ["run", "dbg", str(bam), di.BENCH_REGION, str(fa), "1"]
    if run_cli(argv + ["0"], WORK / "dbg_bench.err"):
        fail("dbg: verbose 0 printed graph lines")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    roi_s = float(timing_line((WORK / "dbg_bench.err").read_text(),
                              "Kernel runtime:").split()[2])
    sub = argv[:3] + [DBG_SUBREGION] + argv[4:] + ["1"]
    t0 = time.perf_counter()
    card_out = run_cli(sub, WORK / "dbg_sub.err")
    sub_s = time.perf_counter() - t0
    with environ({"GENARCH_DEVICE": "cpu"}):
        cpu_out = run_cli(sub, WORK / "dbg_sub_cpu.err")
    lines = card_out.splitlines()
    if not lines or sorted(lines) != sorted(cpu_out.splitlines()):
        fail(f"dbg {DBG_SUBREGION}: the card's lines differ from the CPU "
             f"run's")
    phase_s = time.perf_counter() - phase_t0
    row = dict(name="dbg", route="torch ops", reads=len(seqs),
               cells=int(isn.size), ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, launches=launches,
               bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
               mask_wall_ms=mask_s * 1e3, cli_roi_s=roi_s,
               profiled_device_ms=dev_ms, device_events=events,
               profiled_ms=prof_ms, device_busy_share=dev_ms / prof_ms,
               peak_gb=peak_gb, subregion=DBG_SUBREGION,
               subregion_lines=len(lines), subregion_bytes=len(card_out),
               subregion_cli_s=sub_s, bench_input_s=gen_s, phase_s=phase_s,
               card=card)
    print(f"dbg bench ({len(seqs)} reads): masks equal to the CPU's for "
          f"every read; mask {ms:.3f} ms by CUDA events (plain on the CPU "
          f"{plain_ms:.1f} ms, max-pool {library_ms:.3f} ms), "
          f"_window_min_mask {mask_s * 1e3:.1f} ms of wall, {launches} "
          f"launches, {dev_ms:.2f} ms of device activity ({events} events), "
          f"busy {row['device_busy_share']:.1%} of {prof_ms:.1f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}); `cli run dbg` verbose 0: Kernel "
          f"runtime {roi_s:.2f} s, peak {peak_gb:.3f} GB; {DBG_SUBREGION} "
          f"verbose 1: {len(lines)} lines, {len(card_out)} bytes, sorted-"
          f"equal to the CPU run ({sub_s:.1f} s on the card's CLI); input "
          f"written in {gen_s:.1f} s; phase {phase_s:.1f} s")
    return row


def pileup_phase(card: str) -> dict:
    """pileup at bench.py's input (60,000 reads of 300 bases over 500 kb,
    seed 107, five 100 kb chunks) through `cli run pileup`, its stdout
    byte for byte equal to the port's CPU run; a warm run's split (C walk,
    layout, copies, scatter, copy back), launches in the `pileup.scatter`
    spans, busy share, peak memory; the scatter timed by CUDA events
    against its plain version and torch.bincount; bound."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch import native
    from genarchbench_tpu_torch.io import bam_io
    from genarchbench_tpu_torch.kernels import pileup

    phase_t0 = time.perf_counter()
    pi = input_module("torch_pileup_inputs")
    bam = WORK / "pileup_bench.bam"
    t0 = time.perf_counter()
    pi.bench_bam(bam, bam_io)
    gen_s = time.perf_counter() - t0
    argv = ["run", "pileup", str(bam), pi.BENCH_REGION, "1"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run_cli(argv, WORK / "pileup_bench.err")
    cli_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    roi_s = float(timing_line((WORK / "pileup_bench.err").read_text(),
                              "Kernel runtime:").split()[2])
    with environ({"GENARCH_DEVICE": "cpu"}):
        cpu_out = run_cli(argv, WORK / "pileup_cpu.err")
    cpu_roi_s = float(timing_line((WORK / "pileup_cpu.err").read_text(),
                                  "Kernel runtime:").split()[2])
    if out != cpu_out:
        fail("pileup bench: the card's stdout differs from the CPU run's")

    _, records = bam_io.read_bam(str(bam))
    end = 500_000
    chunks = [(max(s - 1, 0), min(s + pileup.CHUNK_LEN, end))
              for s in range(0, end, pileup.CHUNK_LEN)]

    def chunked(stats=None):
        return [pileup.calculate_pileup(records, 0, s, e, device_out=True,
                                        stats=stats) for s, e in chunks]

    chunked()
    stats = {}
    t0 = time.perf_counter()
    mats = chunked(stats)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [m[2].cpu().numpy() for m in mats]
    d2h_ms = (time.perf_counter() - t0) * 1e3
    prof, prof_ms = profiled(chunked)
    calls, events, dev_ms = kineto_summary(prof, "pileup.")
    del prof
    launches = calls.get("pileup.scatter", (0, 0))[0]

    flat = pileup._flatten_records(records)
    inputs, lib_inputs, nbytes = [], [], 0
    for s, e in chunks:
        cov, present, p, j, f = native.pileup_events(
            flat, 0, s, e, pileup.FILTER_FLAGS, pileup.NUM2COUNTBASE)
        colof, ncols = pileup._column_layout(cov, present, s, e)[2:4]
        a = (torch.from_numpy(colof.astype(np.int32)).cuda(),
             torch.from_numpy(p).cuda(),
             torch.from_numpy(j * pileup.WIDTH + f).cuda(), ncols)
        inputs.append(a)
        lib_inputs.append(((a[0][a[1].long()] * pileup.WIDTH + a[2]).long(),
                           ncols * pileup.WIDTH))
        nbytes += 8 * len(p) + 4 * len(colof) + 4 * ncols * pileup.WIDTH
    ms = event_ms(lambda: [pileup._scatter_counts(*a) for a in inputs],
                  PILEUP_REPS)
    cpu_inputs = [tuple(x.cpu() if torch.is_tensor(x) else x for x in a)
                  for a in inputs]
    t0 = time.perf_counter()
    for a, h in zip(cpu_inputs, host):
        if not np.array_equal(pileup._scatter_counts(*a).numpy(), h):
            fail("pileup: the CPU scatter differs from the card's matrix")
    plain_ms = (time.perf_counter() - t0) * 1e3
    for (idx, size), h in zip(lib_inputs, host):
        if not np.array_equal(torch.bincount(idx, minlength=size)
                              .cpu().numpy(), h.ravel()):
            fail("pileup: torch.bincount differs from the scatter")
    library_ms = event_ms(lambda: [torch.bincount(idx, minlength=size)
                                   for idx, size in lib_inputs], PILEUP_REPS)
    b_ms, b_by = bound_ms(nbytes, 4 * stats["events"])
    phase_s = time.perf_counter() - phase_t0
    split = {k: stats[k] * 1e3 for k in ("walk_s", "layout_s", "h2d_s",
                                         "scatter_s")}
    split["d2h_s"] = d2h_ms
    row = dict(name="pileup", route="torch ops", chunks=len(chunks),
               events=stats["events"], cols=stats["cols"], ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, launches=launches,
               bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
               cli_roi_s=roi_s, cpu_roi_s=cpu_roi_s, cli_s=cli_s,
               stdout_bytes=len(out), warm_s=warm_s, split_ms=split,
               profiled_device_ms=dev_ms, device_events=events,
               profiled_ms=prof_ms, device_busy_share=dev_ms / prof_ms,
               peak_gb=peak_gb, bench_input_s=gen_s, phase_s=phase_s,
               card=card)
    print(f"pileup bench: stdout ({len(out)} bytes) equal to the CPU run's "
          f"byte for byte; Kernel runtime {roi_s:.2f} s (CPU {cpu_roi_s:.2f} "
          f"s); warm 5 chunks {warm_s * 1e3:.1f} ms: "
          + ", ".join(f"{k[:-2]} {v:.1f}" for k, v in split.items())
          + f" ms; {stats['events']} events, {stats['cols']} columns; "
          f"scatter {ms:.3f} ms by CUDA events (CPU {plain_ms:.1f} ms, "
          f"torch.bincount {library_ms:.3f} ms); {launches} launches in the "
          f"scatter spans; {dev_ms:.2f} ms of device activity ({events} "
          f"events), busy {row['device_busy_share']:.1%} of {prof_ms:.1f} "
          f"ms; peak {peak_gb:.3f} GB; bound {b_ms:.4f} ms ({b_by}); input "
          f"written in {gen_s:.1f} s; phase {phase_s:.1f} s")
    return row


VARIANT_P_BATCH = 4096
VARIANT_F_BATCH = 1024
VARIANT_REPS = 20
VARIANT_MODEL_TOL = 1e-4
VARIANT_QUAL_TOL = 0.02
VARIANT_FA_REGION = "ctg:1-100000"
SSW_OPS_PER_CELL = 21
SSW_REPS = 3


def vcf_check(got: str, want: str, what: str):
    """The reference's projection of two VCFs (harness/dataset_regress.py:
    54): the rows sorted, fields 1-5 and 7-9 equal, QUAL within
    VARIANT_QUAL_TOL.  Returns (rows, max |QUAL diff|, rows whose GT
    differs)."""
    def rows(text):
        return sorted((ln.split("\t") for ln in text.splitlines()
                       if ln and not ln.startswith("#")),
                      key=lambda f: (f[0], int(f[1])))

    g, w = rows(got), rows(want)
    if [f[:5] + f[6:9] for f in g] != [f[:5] + f[6:9] for f in w]:
        fail(f"nn-variant {what}: the card's VCF rows differ from the CPU "
             f"run's in fields 1-5, 7-9 ({len(g)} against {len(w)} rows)")
    dq = max((abs(float(a[5]) - float(b[5])) for a, b in zip(g, w)),
             default=0.0)
    if dq > VARIANT_QUAL_TOL:
        fail(f"nn-variant {what}: QUAL differs by {dq} (limit "
             f"{VARIANT_QUAL_TOL})")
    return len(g), dq, sum(a[9:] != b[9:] for a, b in zip(g, w))


def variant_cli(argv, name: str, cpu_stats=None):
    """`cli run nn-variant` on the card, or with cpu_stats (a dict) the
    runner with GENARCH_DEVICE=cpu and its stage split: (the VCF, the
    stderr, wall seconds)."""
    from genarchbench_tpu_torch.nn import variant
    out, errp = WORK / f"{name}.vcf", WORK / f"{name}.err"
    argv = [*argv, "--output", str(out)]
    t0 = time.perf_counter()
    if cpu_stats is None:
        run_cli(["run", "nn-variant", *argv], errp)
    else:
        with environ({"GENARCH_DEVICE": "cpu"}), open(errp, "w") as err, \
                contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            if variant.run(argv, stats=cpu_stats) != 0:
                fail(f"nn-variant {name} returned non-zero")
    return out.read_text(), errp.read_text(), time.perf_counter() - t0


def model_flops(model, x) -> int:
    """Float32 operations (two a multiply-add) of a model's LSTM, Linear
    and Conv2d products in one forward on x, from each layer's shapes."""
    import torch
    from torch import nn
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, nn.LSTM):
            B, T_ = inp[0].shape[:2]
            dirs = 2 if mod.bidirectional else 1
            total[0] += 2 * B * T_ * dirs * 4 * mod.hidden_size * (
                mod.input_size + mod.hidden_size)
        elif isinstance(mod, nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features
        else:
            total[0] += 2 * out.numel() * mod.in_channels * \
                mod.kernel_size[0] * mod.kernel_size[1] // mod.groups

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (nn.LSTM, nn.Linear, nn.Conv2d))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def spans_profile(fn, reps: int, span: str):
    """fn() `reps` times under torch.profiler, each call inside
    record_function(span): (kernel launches, graph launches, device ms)
    per call and the profile's busy share of its wall time."""
    import torch
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            with torch.profiler.record_function(span):
                fn()

    prof, prof_ms = profiled(calls)
    counts, _, dev_ms = kineto_summary(prof, span)
    kl, gl = counts.get(span, (0, 0))
    return kl / reps, gl / reps, dev_ms / reps, dev_ms / prof_ms


def variant_model_row(card: str, name: str, caller, cpu_caller, x):
    """One model's forward at the bench batch: CUDA events, device time,
    launches, bound; the card's probabilities against the CPU's on the
    first 8 tensors."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch.nn import variant

    xt = torch.from_numpy(x).cuda()

    def forward():
        with variant._fp32():
            caller.model(xt)

    with variant._fp32():
        flops = model_flops(caller.model, xt)
        ms = event_ms(forward, VARIANT_REPS)
    launches, graphs, dev_ms, _ = spans_profile(forward, VARIANT_REPS,
                                                f"variant.{name}")
    plain = torch.from_numpy(x[:8])
    t0 = time.perf_counter()
    with variant._fp32():
        want = cpu_caller.model(plain).numpy()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = caller.predict(x[:8])
    err = float(np.abs(got - want).max())
    if not np.isfinite(got).all() or err > VARIANT_MODEL_TOL:
        fail(f"nn-variant {name}: card vs CPU probabilities max |diff| "
             f"{err} (limit {VARIANT_MODEL_TOL})")
    b_ms = flops / PEAK_FP32_FLOPS * 1e3
    print(f"nn-variant {name} (TF32 off) at {x.shape}: {ms:.3f} ms by CUDA "
          f"events (mean of {VARIANT_REPS}), {dev_ms:.3f} ms device, "
          f"{launches:.0f} kernel launches a forward; {flops / 1e9:.1f} "
          f"GFLOP, bound {b_ms:.3f} ms (float32 operations); card vs CPU "
          f"on 8 tensors max |dp| {err:.2e}; CPU 8 tensors {plain_ms:.1f} ms")
    return dict(name=f"nn-variant {name}", route="torch ops (cuDNN)",
                shape=list(x.shape), ms=ms, device_ms=dev_ms,
                launches=launches, graph_launches=graphs,
                plain_ms_8=plain_ms, max_abs_err=err, flops=flops,
                bound_ms=b_ms, bound_by="operations", library_ms=ms,
                tf32=False, card=card)


def ssw_sweep_row(card: str, reads, window: str) -> dict:
    """The realigner's SSW sweeps over input B's pairs (its reads against
    the re-examined window): graphed blocks held bit for bit to the same
    blocks run eagerly on the card, both timed; launches a column step;
    bound."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch.nn import ssw

    al = ssw.SswAligner()
    B = len(reads)
    rd = [ssw._ENC[np.frombuffer(s.encode(), np.uint8)] for s in reads]
    rf = ssw._ENC[np.frombuffer(window.encode(), np.uint8)]
    Lread, Lref = ssw._pow2(max(map(len, rd))), ssw._pow2(len(rf))
    reads_a = np.full((B, Lread), 4, np.int8)
    for b, s in enumerate(rd):
        reads_a[b, :len(s)] = s
    refs_a = np.full((B, Lref), 4, np.int8)
    refs_a[:, :len(rf)] = rf
    dev = [torch.from_numpy(a).cuda() for a in (
        refs_a, reads_a, np.full(B, len(rf), np.int32),
        np.array([len(s) for s in rd], np.int32), np.zeros(B, np.int32))]
    mat = torch.from_numpy(al.mat).cuda()

    def sweep(graphed, counts=None):
        return ssw._sweep(*dev[:4], mat, dev[4], Lref, Lread, al.gapO,
                          al.gapE, False, graphed=graphed, counts=counts)

    g_counts, e_counts = {}, {}
    g, e = sweep(True, g_counts), sweep(False, e_counts)
    if not all(torch.equal(a, b) for a, b in zip(g, e)):
        fail("ssw: the graphed forward sweep differs from the same blocks "
             "run eagerly on the card")
    g_al = al.align_batch(reads, [window] * B, graphed=True)
    stats = {}
    e_al = al.align_batch(reads, [window] * B, graphed=False, stats=stats)
    if [ssw_fields(a) for a in g_al] != \
            [ssw_fields(a) for a in e_al]:
        fail("ssw: graphed align_batch differs from eager blocks")
    n_cpu = min(64, B)
    cpu = ssw.SswAligner(device="cpu").align_batch(reads[:n_cpu],
                                                   [window] * n_cpu)
    if [ssw_fields(a) for a in cpu] != \
            [ssw_fields(a) for a in g_al[:len(cpu)]]:
        fail("ssw: the card's alignments differ from the CPU's")
    g_ms = event_ms(lambda: sweep(True), SSW_REPS)
    e_ms = event_ms(lambda: sweep(False), SSW_REPS)
    steps = g_counts["steps"]
    kl, gl, dev_ms, _ = spans_profile(lambda: sweep(True), 1, "ssw.graphed")
    ekl, _, e_dev_ms, _ = spans_profile(lambda: sweep(False), 1, "ssw.eager")
    best, best_i, end_read = (t.cpu().numpy() for t in g[:3])
    rdl = np.array([len(s) for s in rd])
    cells = int(len(rf) * rdl.sum())
    rev_cells = sum((a.ref_end1 - a.ref_begin1 + 1)
                    * (a.read_end1 + 1) for a in g_al if a.score1 > 0)
    nbytes = B * (Lref + 1) * 4 + refs_a.nbytes + reads_a.nbytes
    b_ms, b_by = bound_ms(nbytes, SSW_OPS_PER_CELL * cells)
    print(f"ssw sweep ({B} pairs, Lref {Lref}, Lread {Lread}, {steps} "
          f"steps): graphed forward {g_ms:.2f} ms against eager blocks "
          f"{e_ms:.2f} ms (CUDA events, mean of {SSW_REPS}), bit for bit "
          f"equal, "
          f"align_batch equal graphed, eager and (first 64) CPU; "
          f"{(kl + gl) / steps:.2f} launches a column step graphed "
          f"({kl:.0f} kernels + {gl:.0f} graphs a sweep), {ekl / steps:.1f} "
          f"eager; device {dev_ms:.2f} ms graphed, {e_dev_ms:.2f} ms eager; "
          f"reverse pass {stats['rev_steps']} of {stats['fwd_steps']} steps; "
          f"bound {b_ms:.4f} ms ({b_by}) over {cells} forward cells")
    return dict(name="nn-variant ssw sweep", route="torch ops in CUDA graphs",
                pairs=B, Lref=Lref, Lread=Lread, steps=steps, ms=g_ms,
                eager_ms=e_ms, device_ms=dev_ms, eager_device_ms=e_dev_ms,
                launches_per_step=(kl + gl) / steps,
                eager_launches_per_step=ekl / steps, fwd_cells=cells,
                rev_cells=rev_cells, rev_steps=stats["rev_steps"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None, card=card)


def ssw_fields(a) -> tuple:
    return (a.score1, a.score2, a.ref_begin1, a.ref_end1, a.read_begin1,
            a.read_end1, a.ref_end2, tuple(a.cigar))


def variant_phase(card: str) -> dict:
    """nn-variant: input A (ONT-like, 500 kb, 30x of 3 kb reads) through
    `cli run nn-variant` on the whole contig and `--full-alignment
    --fa-qual 100` on VARIANT_FA_REGION; input B (Illumina-like, 3 kb at
    40x of 150-base reads) with `--full-alignment --fa-qual 100
    --realign`; each VCF held to the port's CPU run by the reference's
    projection.  Then the two models at the bench batches against the
    CPU, the SSW sweep graphed against eager, warm runs' splits, the busy
    share, peak memory and the timing lines."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch.io import bam_io
    from genarchbench_tpu_torch.nn import variant

    phase_t0 = time.perf_counter()
    vi = input_module("torch_variant_inputs")
    d_a, d_b = WORK / "variant_ont", WORK / "variant_ilmn"
    d_a.mkdir(exist_ok=True)
    d_b.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    case_a = vi.ont_case(d_a, bam_io)
    gen_a_s = time.perf_counter() - t0
    case_b = vi.ilmn_case(d_b, bam_io)
    p_npz, f_npz = WORK / "variant_p.npz", WORK / "variant_f.npz"
    vi.save_npz(p_npz, vi.keras_weights_p(4))
    vi.save_npz(f_npz, vi.keras_weights_f(2))
    gen_s = time.perf_counter() - t0

    def argv(case, region, *extra):
        return ["--bam", str(case["bam"]), "--ref", str(case["ref"]),
                "--region", region, "--model", str(p_npz), "--fa-model",
                str(f_npz), *extra]

    fa = ("--full-alignment", "--fa-qual", "100")
    runs = [("pileup", argv(case_a, case_a["region"])),
            ("full-alignment", argv(case_a, VARIANT_FA_REGION, *fa)),
            ("realign", argv(case_b, case_b["region"], *fa, "--realign"))]
    checks, lines = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, a in runs:
        got, err, card_s = variant_cli(a, f"variant_{name}")
        cpu_split = {}
        want, cpu_err, cpu_s = variant_cli(a, f"variant_{name}_cpu",
                                           cpu_split)
        n, dq, gt = vcf_check(got, want, name)
        if not n or (name != "pileup" and "full-alignment re-called" not in
                     err):
            fail(f"nn-variant {name}: {n} VCF rows, no full-alignment stage")
        tl = [ln for ln in err.splitlines()
              if ln.startswith("VariantCalling execution time:")]
        if len(tl) != 1:
            fail(f"nn-variant {name}: {len(tl)} timing lines")
        info = [ln for ln in err.splitlines() if ln.startswith("[INFO]")]
        checks[name] = dict(rows=n, max_qual_diff=dq, gt_diffs=gt,
                            cpu_split=cpu_split,
                            card_s=card_s, cpu_s=cpu_s, info=info,
                            roi_s=float(tl[0].split()[3]),
                            cpu_roi_s=float(timing_line(
                                cpu_err, "VariantCalling execution time:")
                                .split()[3]))
        lines[name] = tl[0]
        print(f"nn-variant {name}: {n} VCF rows equal to the CPU run's "
              f"(fields 1-5, 7-9; max |dQUAL| {dq:.3f}; {gt} GT differ); "
              f"{tl[0]} (CPU {checks[name]['cpu_roi_s']:.2f} s: " + ", ".join(
                  f"{k[:-2]} {v * 1e3:.1f}" for k, v in cpu_split.items()
                  if k.endswith("_s") and k != "roi_s") + " ms); "
              + "; ".join(info))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # each run once more, warm, under torch.profiler: its split (a sync
    # at each stage), launches, device time and busy share
    splits, profs = {}, {}
    for name, a in runs:
        stats = {}

        def warm():
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()), \
                    torch.profiler.record_function("variant.run"):
                variant.run(a + ["--output", str(WORK / "variant_warm.vcf")],
                            stats=stats)

        prof, prof_ms = profiled(warm)
        calls, events, dev_ms = kineto_summary(prof, "variant.run")
        ssw_calls = kineto_summary(prof, "ssw.")[0].get("ssw.sweep", (0, 0))
        del prof
        splits[name] = stats
        profs[name] = dict(profiled_ms=prof_ms, device_ms=dev_ms,
                           device_events=events,
                           launches=calls["variant.run"],
                           ssw_launches=ssw_calls,
                           busy_share=dev_ms / prof_ms)
        print(f"nn-variant {name} warm split (profiled): " + ", ".join(
            f"{k[:-2]} {v * 1e3:.1f}" for k, v in stats.items()
            if k.endswith("_s")) + f" ms; {stats['candidates']} candidates, "
            f"{stats.get('fa_sites', 0)} FA sites of rows "
            f"{sorted(set(stats.get('fa_rows', [])))}; launches "
            f"{calls['variant.run']} (kernels, graphs), ssw {ssw_calls}; "
            f"device {dev_ms:.2f} ms ({events} events), busy "
            f"{dev_ms / prof_ms:.1%} of {prof_ms:.1f} ms")

    # the models at the bench batches, card against CPU
    rng = np.random.default_rng(117)
    pc = variant.PileupCaller(variant.convert_keras_weights(
        dict(np.load(p_npz))))
    pc_cpu = variant.PileupCaller(variant.convert_keras_weights(
        dict(np.load(p_npz))), device="cpu")
    xp = rng.integers(-30, 31, (VARIANT_P_BATCH, 33, 18)).astype(np.float32)
    fc = variant.FullAlignmentCaller(variant.convert_keras_weights_full(
        dict(np.load(f_npz))))
    fc_cpu = variant.FullAlignmentCaller(variant.convert_keras_weights_full(
        dict(np.load(f_npz))), device="cpu")
    xf = rng.integers(-100, 101, (VARIANT_F_BATCH, 89, 33, 8)) \
        .astype(np.float32)
    model_rows = [variant_model_row(card, "clair3p", pc, pc_cpu, xp),
                  variant_model_row(card, "clair3f", fc, fc_cpu, xf)]

    # the SSW sweep on input B's realign pairs
    recs = bam_io.read_bam(str(case_b["bam"]))[1]
    lo, hi = splits["realign"]["realign_window"]
    reads = [r.seq for r in recs if not (r.flag & variant.CLAIR3_FILTER_FLAGS)
             and r.pos < hi and r.pos + r.ref_span() > lo]
    if len(reads) != splits["realign"]["pairs"]:
        fail(f"ssw: {len(reads)} reads over the realign window, the run "
             f"aligned {splits['realign']['pairs']}")
    sweep_row = ssw_sweep_row(card, reads, case_b["ref_seq"][lo:hi])

    # each run's bound: its models' float32 operations over 67e12 FLOP/s
    # plus its sweep's integer operations over 1.67e13 op/s
    p_flops = model_rows[0]["flops"] // VARIANT_P_BATCH
    with variant._fp32():
        f_flops = {r: model_flops(fc.model, torch.zeros(
            (1, r if fc.model.fits(r) else fc.model.depth, 33, 8),
            device="cuda")) for r in set(
                sum((st.get("fa_rows", []) for st in splits.values()), []))}
    for name, st in splits.items():
        flops = p_flops * st["candidates"] + sum(
            f_flops[r] for r in st.get("fa_rows", []))
        ops = SSW_OPS_PER_CELL * sweep_row["fwd_cells"] \
            if name == "realign" else 0
        profs[name].update(
            flops=flops, int_ops=ops, bound_ms=(flops / PEAK_FP32_FLOPS
                                                + ops / PEAK_INT32_OPS_PER_S)
            * 1e3)
    phase_s = time.perf_counter() - phase_t0
    row = dict(name="nn-variant", route="torch ops (cuDNN models, graphed "
               "SSW sweep)", checks=checks, timing_lines=lines,
               splits=splits, profiles=profs, models=model_rows,
               ssw=sweep_row, peak_gb=peak_gb, input_a_s=gen_a_s,
               inputs_s=gen_s, phase_s=phase_s, card=card)
    print("nn-variant CLI bounds: " + "; ".join(
        f"{k} {v['bound_ms']:.3f} ms ({v['flops'] / 1e9:.2f} GFLOP, "
        f"{v['int_ops'] / 1e9:.2f} G int ops)" for k, v in profs.items())
        + f"; peak {peak_gb:.3f} GB; input A written in {gen_a_s:.1f} s; "
        f"phase {phase_s:.1f} s")
    return row


MESH_FMI_READS = 16384
MESH_REPS = 3


def regress_report(fn, jobs: bool = True) -> str:
    """Run a `regress` (fn) with its jobs under WORK/jobs; its stdout,
    which must end in `Failed jobs: 0/N` where jobs ran."""
    out = io.StringIO()
    with environ({"GENARCH_JOB_DIR": str(WORK / "jobs")}), \
            contextlib.redirect_stdout(out):
        rc = fn()
    text = out.getvalue()
    if rc != 0 or jobs and not re.search(r"^Failed jobs: 0/\d+$", text,
                                         re.M):
        fail(f"regress returned {rc}:\n{text[-3000:]}")
    return text


def wall_s(fn, reps: int = MESH_REPS) -> float:
    """Median host seconds of fn() after a warm call, each call ended by
    a sync of the card."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def mesh_kernel_row(card, name, base, launches, shard_args, kernel, want,
                    plain_ms, nbytes, ops, one_shard_args):
    """A kernel row for the two-shard run: the kernel on every shard held
    to the plain version's outputs for the same items (`want`, from
    phases 2-3, with their plain_ms), the wrapper on each shard's inputs
    (CUDA events, warm, mean of KERNEL_REPS) and on the one-device run's
    inputs beside it."""
    import torch
    max_err = 0
    for args, w in zip(shard_args, want):
        k = kernel(args)
        torch.cuda.synchronize()
        max_err = max(max_err, max(int((a.long().cpu() - b).abs().max())
                                   for a, b in zip(k, w)))
    if max_err:
        fail(f"{name}: kernel vs plain max |diff| {max_err} on a shard")
    ms = event_ms(lambda: [kernel(a) for a in shard_args], KERNEL_REPS)
    one_ms = event_ms(lambda: [kernel(a) for a in one_shard_args],
                      KERNEL_REPS)
    b_ms, b_by = bound_ms(nbytes, ops)
    return dict(base, name=name, launches=launches, max_abs_err=max_err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, one_shard_ms=one_ms, card=card)


def mesh_phase(card: str, bpm_row: dict, bsw_row: dict):
    """The slice's own path on the card, after every other phase (it
    reads their inputs and goldens): (a) `cli regress bpm` and `regress
    bsw` at phases 2-3's inputs, --devices 1, each job's output held to
    the file those phases held to the plain versions; (b) bpm_batch and
    bsw_batch on a mesh of two shards of the one card, exactly equal to
    the one-device run, each shard launching the hand kernel, held to
    the plain outputs phases 2-3 saved (their rows give the plain
    versions' times on the same items); (c) wfa,
    chain, fast-chain, abea and fmi on small inputs, and fmi with sharded
    tables on its bench input's first MESH_FMI_READS reads, each on that
    mesh and exactly equal to its one-device run; (d) the sharded k-mer
    count at the kmer-cnt bench input against count_distinct; (e)
    `regress small` without a dataset root, every kernel a SKIP.
    Returns (its path row, the kernel rows of (b))."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch import cli
    from genarchbench_tpu_torch.io import chain_io
    from genarchbench_tpu_torch.io.bsw_io import read_bsw_pairs
    from genarchbench_tpu_torch.io.fasta_io import read_fasta
    from genarchbench_tpu_torch.io.seqpair_io import read_seqpairs
    from genarchbench_tpu_torch.kernels import (abea, bpm, bpm_cuda, bsw,
                                                bsw_cuda, chain, fast_chain,
                                                fmi, kmer, wfa)
    from genarchbench_tpu_torch.sharding.mesh import (Mesh, shard_args,
                                                      shard_index,
                                                      shard_items)

    phase_t0 = time.perf_counter()
    sy = synth()
    card0 = torch.device("cuda", 0)
    mesh = Mesh((card0, card0))
    row = dict(name="mesh", route="torch ops and hand kernels", card=card)

    # (a) the regress harness on the card, one job each
    bpm_in, bsw_in = WORK / "bpm_pairs.txt", WORK / "bsw_pairs.txt"
    jobs = {}
    t0 = time.perf_counter()
    text = regress_report(lambda: cli.main(
        ["regress", "bpm", "--cmd", f"-i {bpm_in} -o {{out}}/out.txt",
         "--golden", str(WORK / "bpm.out"), "--source", "file:out.txt",
         "--devices", "1"]))
    jobs["bpm"] = (text, time.perf_counter() - t0)
    t0 = time.perf_counter()
    text = regress_report(lambda: cli.main(
        ["regress", "bsw", "--cmd", f"-pairs {bsw_in}",
         "--golden", str(WORK / "bsw.err"), "--source", "stderr",
         "--devices", "1"]))
    jobs["bsw"] = (text, time.perf_counter() - t0)
    for name, (text, call_s) in jobs.items():
        job = timing_line(text, f"[{name} devices=1]").strip()
        m = re.search(rf"launches .*{name}=(\d+)", job)
        if not m or int(m.group(1)) < 1:
            fail(f"regress {name}: the job launched no {name} kernel: {job}")
        scaling = timing_line(text, f"[{name}] scaling:").strip()
        print(f"regress {name}: {job} | {scaling} | call {call_s:.2f} s")
        job_wall = float(re.search(r"wall=([0-9.]+)s", job).group(1))
        nums = re.findall(r"([0-9.]+)s", scaling)
        row[f"regress_{name}"] = dict(
            job_wall_s=job_wall, timing_s=float(nums[0]) if nums else None,
            launches=int(m.group(1)), call_s=call_s, line=job)

    parts = {"regress_gpu_s": time.perf_counter() - phase_t0}
    t_part = time.perf_counter()

    # (b) the hand kernels' batch functions on two shards of the card
    rows = []
    pairs = read_seqpairs(str(bpm_in), swap_longer_first=True)
    reset_launch_counts()
    single = bpm.bpm_batch(pairs, device="cuda")
    n1 = bpm_cuda.LAUNCHES
    reset_launch_counts()
    sharded = bpm.bpm_batch(pairs, mesh=mesh)
    n2 = bpm_cuda.LAUNCHES
    if not np.array_equal(single, sharded) or n2 != 2 * n1:
        fail(f"bpm mesh: {int((single != sharded).sum())} pairs differ; "
             f"{n2} launches on two shards, {n1} on one")
    groups = bpm.word_groups(pairs)
    bpm_parts = [(W, part) for W, idxs in groups.items()
                 for part in shard_items(idxs, mesh)]
    shard_in = [[torch.from_numpy(a).cuda()
                 for a in bpm.group_arrays(pairs, part, W)]
                for W, part in bpm_parts]
    plain = torch.from_numpy(np.load(WORK / "bpm_plain.npy"))
    want = [(plain[torch.from_numpy(part)],) for _, part in bpm_parts]
    one_in = [[torch.from_numpy(a).cuda()
               for a in bpm.group_arrays(pairs, idxs, W)]
              for W, idxs in groups.items()]
    word_steps = sum(a[0].shape[0] * int(a[3].long().sum()) for a in shard_in)
    rows.append(mesh_kernel_row(
        card, "bpm-mesh2", dict(route="cuda",
                                source="genarchbench_tpu_torch/csrc/bpm.cu",
                                replaces="genarchbench_tpu/kernels/"
                                         "bpm_pallas.py:98"),
        n2, shard_in, lambda a: (bpm_cuda.bpm_distance(*a),), want,
        bpm_row["plain_ms"],
        sum(tensor_bytes(a) + 4 * a[0].shape[2] for a in shard_in),
        BPM_OPS_PER_WORD_STEP * word_steps, one_in))
    rows[-1].update(shards=len(mesh.devices), batch_one_s=wall_s(lambda: bpm.bpm_batch(
        pairs, device="cuda")), batch_two_s=wall_s(
        lambda: bpm.bpm_batch(pairs, mesh=mesh)), groups=len(groups))

    # the CLI's grouping (-b 0: one batch), as phase 3's
    bpairs = read_bsw_pairs(str(bsw_in))
    reset_launch_counts()
    single = bsw.bsw_batch(bpairs, batch_size=0, device="cuda")
    n1 = bsw_cuda.LAUNCHES
    reset_launch_counts()
    sharded = bsw.bsw_batch(bpairs, batch_size=0, mesh=mesh)
    n2 = bsw_cuda.LAUNCHES
    if not np.array_equal(single, sharded) or n2 != 2 * n1:
        fail(f"bsw mesh: {int((single != sharded).sum())} pairs differ; "
             f"{n2} launches on two shards, {n1} on one")
    sc = dict(match=1, mismatch=-4, ambig=-1, o_del=6, e_del=1, o_ins=6,
              e_ins=1, zdrop=100, w=100)
    _, arrays = bsw.kernel_inputs(bpairs, 0, bsw.LANES, match=1,
                                  end_bonus=5, o_ins=6, e_ins=1, o_del=6,
                                  e_del=1, w=100)
    shard_in = [list(a) for a in zip(*shard_args(mesh, *arrays))]
    one_in = [[torch.from_numpy(a).cuda() for a in arrays]]
    plain = torch.from_numpy(np.load(WORK / "bsw_plain.npy"))
    want = [tuple(plain[:, torch.from_numpy(ix)])
            for ix in shard_index(len(arrays[0]), mesh)]
    band_cells = bsw_row["band_cells"]
    rows.append(mesh_kernel_row(
        card, "bsw-mesh2", dict(route="cuda",
                                source="genarchbench_tpu_torch/csrc/bsw.cu",
                                replaces="genarchbench_tpu/kernels/"
                                         "bsw_pallas.py:98"),
        n2, shard_in, lambda a: bsw_cuda.bsw_scores(*a, **sc), want,
        bsw_row["plain_ms"],
        sum(tensor_bytes(a) + 6 * a[2].numel() * 4 for a in shard_in),
        # the repeated padding group, if any, evaluates its cells again
        BSW_OPS_PER_CELL * band_cells, one_in))
    rows[-1].update(shards=len(mesh.devices), batch_one_s=wall_s(
        lambda: bsw.bsw_batch(bpairs, batch_size=0, device="cuda")),
        batch_two_s=wall_s(lambda: bsw.bsw_batch(bpairs, batch_size=0,
                                                  mesh=mesh)))
    for r in rows:
        print(f"{r['name']}: {r['launches']} launches, kernels "
              f"{r['ms']:.4f} ms on two shards, {r['one_shard_ms']:.4f} ms "
              f"on one; batch function {r['batch_two_s'] * 1e3:.1f} ms on "
              f"two shards, {r['batch_one_s'] * 1e3:.1f} ms on one")

    parts["hand_kernels_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (c) the torch-op paths on two shards of the card
    def same(name, a, b):
        if a != b:
            fail(f"{name}: the two-shard run differs from the one-device "
                 f"run")

    def lists(res):
        return [[np.asarray(x).tolist() for x in r[:2]] for r in res]

    split = {}
    wf = WORK / "mesh_wfa.txt"
    wf.write_text(sy.gen_seqpair_dataset(np.random.default_rng(14),
                                         n_pairs=256, length=100,
                                         error_rate=0.08))
    wpairs = read_seqpairs(str(wf), swap_longer_first=False)
    same("wfa", wfa.wfa_batch(wpairs, device="cuda"),
         wfa.wfa_batch(wpairs, mesh=mesh))
    text = sy.gen_chain_input(np.random.default_rng(11), n_records=64,
                              max_anchors=200)
    recs = list(chain_io.read_records(io.StringIO(text)))
    same("chain", lists(chain.chain_batch(recs, device="cuda")),
         lists(chain.chain_batch(recs, mesh=mesh)))
    same("fast-chain", lists(fast_chain.fast_chain_batch(recs, device="cuda")),
         lists(fast_chain.fast_chain_batch(recs, mesh=mesh)))
    ai = input_module("torch_abea_inputs")
    model = ai.synth_model(0)
    rng = np.random.default_rng(16)
    seqs = [ai.random_seq(rng, int(rng.integers(200, 600)))
            for _ in range(16)]
    ets = [abea.get_events(ai.synth_signal(rng, model, s)) for s in seqs]
    got = abea.align_batch(seqs, ets, model, mesh=mesh)
    same("abea", abea.align_batch(seqs, ets, model, device="cuda"), got)
    if not all(got):
        fail("abea mesh: a read failed QC on the small input")
    fi = input_module("torch_fmi_inputs")
    (WORK / "mesh_fmi").mkdir(exist_ok=True)
    small_fa, small_fq = fi.gen_case(WORK / "mesh_fmi",
                                     np.random.default_rng(15),
                                     ref_len=20000, n_reads=256)
    sidx = fmi.load_index(str(small_fa))
    sreads = fmi.read_queries(str(small_fq))

    def fmi_run(index, reads, **kw):
        res = fmi.search_reads(fmi.FMISearch(index, **kw), reads, 512, 19)
        return [a.tolist() for a in res[0]]
    same("fmi", fmi_run(sidx, sreads, device="cuda"),
         fmi_run(sidx, sreads, mesh=mesh))
    bench_dir = WORK / "fmi_bench"
    fa, fq = bench_dir / "ref.fa", bench_dir / "reads.fq"
    if not fq.exists():
        bench_dir.mkdir(exist_ok=True)
        fa, fq = fi.bench_input(bench_dir)
    bidx = fmi.load_index(str(fa))
    breads = fmi.read_queries(str(fq))[:MESH_FMI_READS]
    t0 = time.perf_counter()
    one = fmi_run(bidx, breads, device="cuda")
    split["fmi_one_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = fmi_run(bidx, breads, mesh=mesh, shard_tables=True)
    split["fmi_sharded_tables_s"] = time.perf_counter() - t0
    same("fmi sharded tables", one, two)
    print(f"mesh torch-op paths: wfa, chain, fast-chain, abea, fmi equal on "
          f"two shards; fmi sharded tables on {len(breads)} bench reads "
          f"({len(one[0])} SMEMs): {split['fmi_sharded_tables_s']:.2f} s, "
          f"one device {split['fmi_one_s']:.2f} s")

    parts["torch_op_paths_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (d) the sharded k-mer count
    kf = WORK / "kmer_bench.fa"
    if not kf.exists():
        input_module("torch_kmer_inputs").bench_fasta(kf)
    reads = read_fasta(str(kf))
    want = kmer.count_distinct(reads, KMER_K)
    got = kmer.count_distinct_sharded(reads, KMER_K, mesh=mesh)
    if got != want:
        fail(f"kmer sharded count {got} != count_distinct {want}")
    split["kmer_one_s"] = wall_s(lambda: kmer.count_distinct(reads, KMER_K))
    split["kmer_sharded_s"] = wall_s(
        lambda: kmer.count_distinct_sharded(reads, KMER_K, mesh=mesh))
    print(f"kmer sharded count on two shards: {got} k-mers, equal to "
          f"count_distinct; {split['kmer_sharded_s'] * 1e3:.2f} ms, one "
          f"device {split['kmer_one_s'] * 1e3:.2f} ms (medians of "
          f"{MESH_REPS})")

    parts["kmer_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (e) regress small without a dataset
    with environ({"GENARCH_BENCH_INPUTS_ROOT": ""}):
        text = regress_report(lambda: cli.main(["regress", "small"]),
                              jobs=False)
    if "0 passed, 0 failed, 13 skipped (of 13)" not in text:
        fail(f"regress small without a dataset: {text[-1500:]}")
    parts["regress_small_s"] = time.perf_counter() - t_part
    phase_s = time.perf_counter() - phase_t0
    print(f"mesh phase {phase_s:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    row.update(split, parts=parts, phase_s=phase_s,
               kernel_rows=[r["name"] for r in rows])
    return row, rows


TRAIN_SAMPLES = 3000
TRAIN_LABELS = (250, 350)         # label lengths, drawn from numpy seed 0
TRAIN_BATCH = 16
TRAIN_CHECK_BATCH = 2
TRAIN_REPS = 3
# full width, card against CPU at TRAIN_CHECK_BATCH: the loss, relative;
# each parameter's gradient, max |diff| over the CPU gradient's norm
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
# the dryrun's all-ones step, card against CPU: tests/test_torch_train.py's
# tolerances for that input (loss relative, gradient over its norm,
# running statistics absolute; parameters within 1e-5 where |g| exceeds
# the gradient tolerance times the norm, elsewhere within 2 lr)
DRYRUN_TOL = dict(loss=1e-5, grad=2e-3, stats=1e-4, param=1e-5)


def train_batch(B: int, seed: int):
    """B seeded standard-normal chunks (B, 1, TRAIN_SAMPLES) and labels of
    random bases 1-4 (numpy seed 0) of lengths TRAIN_LABELS, padded."""
    import numpy as np
    import torch
    x = np.random.default_rng(seed).standard_normal(
        (B, 1, TRAIN_SAMPLES)).astype(np.float32)
    rng = np.random.default_rng(0)
    lens = rng.integers(TRAIN_LABELS[0], TRAIN_LABELS[1] + 1, B)
    L = TRAIN_LABELS[1]
    pad = (np.arange(L)[None] >= lens[:, None]).astype(np.float32)
    lab = np.where(pad > 0, 0, rng.integers(1, 5, (B, L)))
    return torch.from_numpy(x), torch.from_numpy(lab), torch.from_numpy(pad)


def step_errors(got, want, grad_tol: float) -> dict:
    """Two `step_from_state` results (loss, state, gradients) apart: the
    loss (relative), the gradients (max |diff| over the norm of `want`'s),
    the parameters where |g| > grad_tol x the norm and elsewhere, the
    running statistics."""
    (lg, sg, gg), (lw, sw, gw) = got, want
    err = dict(loss=abs(lg - lw) / abs(lw), grad=max(
        float((gg[k] - gw[k]).abs().max() / gw[k].norm()) for k in gw),
        param=0.0, param_rest=0.0, stats=0.0)
    for k, w in sw.items():
        d = (sg[k] - w).abs().float()
        if k.endswith(("running_mean", "running_var")):
            err["stats"] = max(err["stats"], float(d.max()))
        elif k in gw:
            sure = gw[k].abs() > grad_tol * gw[k].norm()
            for key, m in (("param", sure), ("param_rest", ~sure)):
                if m.any():
                    err[key] = max(err[key], float(d[m].max()))
    return err


def train_phase(card: str) -> dict:
    """The nn-base training step (`nn/train.py`; no hand kernel: cuDNN
    convolutions, torch's CTC and AdamW), with cuDNN's TF32 off: (a)
    `dryrun_multichip(2)` on two shards of the one card (tp 2), its loss,
    gradients, new parameters and running statistics held to the port's
    one-shard step on the CPU from the same seeded weights; (b)
    DEFAULT_CONFIG with every dropout 0.0 (the JAX step takes no dropout
    RNG), one step at TRAIN_CHECK_BATCH x TRAIN_SAMPLES on the card held
    to the same step on the CPU; (c) TRAIN_REPS warm steps at TRAIN_BATCH
    x TRAIN_SAMPLES by CUDA events, their launches (one step under
    torch.profiler), peak memory and bound (three times the forward's
    convolution FLOPs over the fp32 peak)."""
    import copy
    import numpy as np
    import torch
    from genarchbench_tpu_torch.entry import dryrun_multichip
    from genarchbench_tpu_torch.nn import basecall as bc
    from genarchbench_tpu_torch.nn import train

    phase_t0 = time.perf_counter()
    card0 = torch.device("cuda", 0)

    # (a) the dryrun on (cuda:0, cuda:0), against the CPU
    t0 = time.perf_counter()
    res = dryrun_multichip(2, devices=(card0, card0))
    dry_s = time.perf_counter() - t0
    cpu = train.step_from_state(res["config"], res["initial"], *res["batch"],
                                device="cpu")
    dry = step_errors((res["loss"], res["state"], res["grads"]), cpu,
                      DRYRUN_TOL["grad"])
    if not (dry["loss"] <= DRYRUN_TOL["loss"]
            and dry["grad"] <= DRYRUN_TOL["grad"]
            and dry["param"] <= DRYRUN_TOL["param"]
            and dry["param_rest"] <= 2 * train.LR + 1e-6
            and dry["stats"] <= DRYRUN_TOL["stats"]):
        fail(f"train: the dryrun's step on two shards of the card against "
             f"the CPU: {dry} (limits {DRYRUN_TOL}, 2 lr elsewhere)")
    print(f"train dryrun (2 shards of the card, tp 2): loss {res['loss']:.6f} "
          f"in {dry_s:.2f} s; against the CPU's one-shard step: " + ", ".join(
              f"{k} {v:.3g}" for k, v in dry.items()))

    # (b) full width: the card against the CPU at TRAIN_CHECK_BATCH
    cfg = copy.deepcopy(bc.DEFAULT_CONFIG)
    for layer in cfg["block"]:
        layer["dropout"] = 0.0
    state = bc.Basecaller.init(cfg, seed=0, device="cpu").model.state_dict()
    small = train_batch(TRAIN_CHECK_BATCH, 112)
    t0 = time.perf_counter()
    on_card = train.step_from_state(cfg, state, *small, device=card0)
    cpu_t0 = time.perf_counter()
    on_cpu = train.step_from_state(cfg, state, *small, device="cpu")
    cpu_s = time.perf_counter() - cpu_t0
    full = step_errors(on_card, on_cpu, TRAIN_GRAD_TOL)
    if not (np.isfinite(on_card[0]) and full["loss"] <= TRAIN_LOSS_TOL
            and full["grad"] <= TRAIN_GRAD_TOL):
        fail(f"train at DEFAULT_CONFIG, {TRAIN_CHECK_BATCH} x "
             f"{TRAIN_SAMPLES}: card against CPU {full} (limits loss "
             f"{TRAIN_LOSS_TOL}, gradients {TRAIN_GRAD_TOL})")
    print(f"train DEFAULT_CONFIG (dropout 0.0) {TRAIN_CHECK_BATCH} x "
          f"{TRAIN_SAMPLES}: loss {on_card[0]:.4f} card, {on_cpu[0]:.4f} CPU "
          f"({cpu_s:.2f} s); loss rel {full['loss']:.3g}, gradients "
          f"{full['grad']:.3g} of the norm, parameters "
          f"{full['param']:.3g} / {full['param_rest']:.3g}, running "
          f"statistics {full['stats']:.3g}; both steps "
          f"{time.perf_counter() - t0:.2f} s")

    # (c) TRAIN_BATCH x TRAIN_SAMPLES on the card, timed
    model = bc.BasecallModel(cfg)
    model.load_state_dict(state)
    model.to(card0)
    opt = train.adamw(model.parameters())
    x, lab, pad = (t.to(card0) for t in train_batch(TRAIN_BATCH, 113))
    train.train_step(model, opt, x, lab, pad)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = [train.train_step(model, opt, x, lab, pad)
              for _ in range(TRAIN_REPS)]
    stop.record()
    stop.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_REPS
    ms = start.elapsed_time(stop) / TRAIN_REPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
        fail(f"train at {TRAIN_BATCH} x {TRAIN_SAMPLES}: losses {losses}")

    def one_step():
        with torch.autograd.profiler.record_function("nn.train_step"):
            train.train_step(model, opt, x, lab, pad)

    prof, prof_ms = profiled(one_step)
    launches = launches_in_spans(prof, "nn.train_step")
    device = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not e.name.startswith("nn."):
            c = device.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us()
    device_ms = sum(us for _, us in device.values()) / 1e3
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:8]
    model.eval()
    flops = conv_flops(model, x)
    bound = 3 * flops / PEAK_FP32_FLOPS * 1e3
    samples = TRAIN_BATCH * TRAIN_SAMPLES
    phase_s = time.perf_counter() - phase_t0
    print(f"train DEFAULT_CONFIG {TRAIN_BATCH} x {TRAIN_SAMPLES}: "
          f"{ms:.3f} ms a step (CUDA events, mean of {TRAIN_REPS} warm "
          f"steps; host clock {wall_ms:.1f}), {samples / (ms / 1e3):.4g} "
          f"samples/s, losses {', '.join(f'{v:.4f}' for v in losses)}; "
          f"{launches} launches a step ({prof_ms:.1f} ms profiled); peak "
          f"{peak_gb:.3f} GB; bound {bound:.3f} ms (3 x {flops:,} "
          f"convolution FLOPs over {PEAK_FP32_FLOPS:.3g}/s); phase "
          f"{phase_s:.1f} s ({card})")
    print(f"train profiled step: {device_ms:.1f} ms of device activity, "
          f"{device_ms / prof_ms:.1%} of {prof_ms:.1f} ms; top by time:")
    for name, (c, us) in top:
        print(f"  {us / 1e3:9.2f} ms {c:6d} x {us / c:8.2f} us  {name[:90]}")
    return dict(name="nn-base-train", route="torch ops (cuDNN, CTC, AdamW)",
                ms=ms, wall_ms=wall_ms, samples=samples,
                samples_per_s=samples / (ms / 1e3), launches=launches,
                profiled_ms=prof_ms, device_ms=device_ms,
                device_busy_share=device_ms / prof_ms,
                top=[(n[:90], c, us / 1e3) for n, (c, us) in top],
                peak_gb=peak_gb, flops=3 * flops, bound_ms=bound,
                bound_by="operations", tf32=False, dropout=0.0,
                dryrun=dict(loss=res["loss"], mesh=res["mesh"], s=dry_s,
                            errors=dry),
                card_vs_cpu=full, cpu_step_s=cpu_s, phase_s=phase_s,
                card=card)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from genarchbench_tpu_torch import native
    from genarchbench_tpu_torch.kernels import _build

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: {lib_path}")
    t0 = time.perf_counter()
    native_path, zlib_path = native.build(), native.build_zlib()
    print(f"host helpers built in {time.perf_counter() - t0:.2f} s: "
          f"{native_path}, {zlib_path}")
    for ln in ptxas_summary(lib_path.parent / "ptxas.txt"):
        print("  ptxas", ln)
    for ln in sass_loops(lib_path):
        print("  sass", ln)
    WORK.mkdir(parents=True, exist_ok=True)

    rows = [bpm_phase(card),
            bsw_phase(card, "bsw", dict(seed=103, n=16384, ref_len=384,
                                        query_len=192), [], 8),
            bsw_phase(card, "bsw-i8", dict(seed=104, n=16384, ref_len=78,
                                           query_len=60), ["-i8"], 16)]
    edge_phase()
    paths = [wfa_phase(card), nn_phase(card)]
    bench = WORK / "chain_bench.txt"
    t0 = time.perf_counter()
    bench.write_text(synth().gen_chain_input(np.random.default_rng(102),
                                             n_records=16384,
                                             max_anchors=512))
    print(f"chain bench input written in {time.perf_counter() - t0:.1f} s")
    row, records = chain_phase(card, bench)
    paths += [row, fast_chain_phase(card, bench, records), fmi_phase(card),
              abea_phase(card), poa_phase(card), kmer_phase(card),
              dbg_phase(card), pileup_phase(card), variant_phase(card)]
    row, mesh_rows = mesh_phase(card, rows[0], rows[1])
    paths += [row, train_phase(card)]
    rows += mesh_rows
    print(json.dumps({"paths": paths}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
