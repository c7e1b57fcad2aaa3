#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit (nvidia-smi), the kernels' build
     and the host helpers' (the C helpers' library and the BGZF
     decoder's, which links zlib);
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
 11. a `{"paths": [...]}` line for the torch-op paths, a
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
multiply-add) over 67e12 FLOP/s; wfa's the bytes of its backtrace
stores and mismatch tables over 3.35 TB/s.  abea's is the larger of its
(NB, B, 100) bands and traces (5 bytes a cell, written once) with its
inputs over 3.35 TB/s, and 15 float64 operations a band cell (the
emission's subtract, divide, two multiplies and add, the three scores'
five adds, two maxima and two compares, the band-range tests) over the
data sheet's 34e12 FP64 FLOP/s outside the tensor cores.
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
    native_path, bgzf_path = native.build(), native.build_bgzf()
    print(f"host helpers built in {time.perf_counter() - t0:.2f} s: "
          f"{native_path}, {bgzf_path}")
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
              abea_phase(card)]
    print(json.dumps({"paths": paths}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
