#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit (nvidia-smi), the kernels' build;
  2. bpm: the reference-sized input (4096 pairs of 480 bases, 12% error,
     bench.py's seed) through `cli run bpm`; the kernel must have been
     launched, agree exactly with its plain PyTorch version on the card
     for every pair, and the output file must match by the sorted rule;
  3. bsw: 16384 pairs, ref 192-383 / query 10-191 (bench.py's seed),
     through `cli run bsw`, all six outputs exact against the plain
     version, the score lines by the exact rule; then the same for an
     `-i8` input (16-pair groups);
  4. edge shapes: bpm patterns of 1-32 bases and of 33 words (the
     generic-W kernel), bsw with ambiguous bases and 16-pair batches;
  5. a `{"kernels": [...]}` line with each kernel's launches, error,
     times (CUDA events, warm) and bound, then the result line.

Bounds: bytes over 3.35 TB/s (H100 SXM HBM3) against integer operations
over 1.67e13 int32 op/s (132 SMs x 64 INT32 lanes x 1.98 GHz boost: the
data sheet's 67 TFLOP/s fp32 counts an FMA as two operations on 128
lanes an SM).  Operations are counted from each kernel's inner step:
22 per bpm word-step (bpm.py:90-107), 24 per evaluated bsw band cell
(bsw.py:186-247).
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 1.67e13
BPM_OPS_PER_WORD_STEP = 22
BSW_OPS_PER_CELL = 24
KERNEL_REPS = 20


def synth():
    """tests/synth.py (numpy-only input generators), loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "genarch_synth", REPO / "tests" / "synth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_summary(path: pathlib.Path):
    """One line per kernel from nvcc's -Xptxas -v log: registers, spills."""
    name, spill = None, ""
    for ln in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
            w = re.search(r"bpm_kernelILi(\d+)E", fn)
            name = (f"bpm<W={w.group(1)}>" if w else
                    "bpm<generic>" if "bpm_kernel_generic" in fn else
                    "bsw" if "bsw_kernel" in fn else fn)
        elif "spill" in ln:
            spill = ln.split(":", 1)[-1].strip()
        elif "Used" in ln and name:
            yield f"{name}: {ln.split(':', 1)[-1].strip()}; {spill}"
            name, spill = None, ""


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
    plain_ms = event_ms(plains, 1)
    word_steps = sum(args[0].shape[0] * int(args[3].long().sum())
                     for _, args in groups)
    nbytes = sum(tensor_bytes(args) + 4 * args[0].shape[2]
                 for _, args in groups)
    b_ms, b_by = bound_ms(nbytes, BPM_OPS_PER_WORD_STEP * word_steps)
    cells = bpm.cell_updates(pairs)
    return dict(name="bpm", route="cuda",
                source="genarchbench_tpu_torch/csrc/bpm.cu",
                replaces="genarchbench_tpu/kernels/bpm_pallas.py:98",
                launches=launches, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, pairs=len(pairs), max_abs_diff=max_err,
                kernel_ms=ms, cells_per_s=cells / (ms / 1e3), card=card)


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
    plain_ms = event_ms(lambda: bsw_cuda.bsw_scores_plain(*args, **sc), 1)
    nbytes = tensor_bytes(args) + 6 * args[2].numel() * 4
    b_ms, b_by = bound_ms(nbytes, BSW_OPS_PER_CELL * band_cells)
    cells = bsw.cell_updates(pairs)
    return dict(name=name, route="cuda",
                source="genarchbench_tpu_torch/csrc/bsw.cu",
                replaces="genarchbench_tpu/kernels/bsw_pallas.py:98",
                launches=launches, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, pairs=len(pairs), max_abs_diff=max_err,
                kernel_ms=ms, cells_per_s=cells / (ms / 1e3),
                band_cells=band_cells, card=card)


def edge_phase():
    """Shapes the bench input does not reach, kernel against plain."""
    import numpy as np
    import torch
    from genarchbench_tpu_torch.io.bsw_io import BswPairs
    from genarchbench_tpu_torch.io.seqpair_io import SeqPairs
    from genarchbench_tpu_torch.kernels import bpm, bpm_cuda, bsw, bsw_cuda

    rng = np.random.default_rng(7)
    plens = list(range(1, 33)) * 4 + [1030] * 64 + [70] * 64
    pats = [rng.integers(0, 5, n).astype(np.uint8) for n in plens]
    txts = [rng.integers(0, 5, int(rng.integers(0, 60))).astype(np.uint8)
            for _ in plens]
    for idx, arrays in bpm.kernel_inputs(SeqPairs(pats, txts)):
        args = [torch.from_numpy(a).cuda() for a in arrays]
        k = bpm_cuda.bpm_distance(*args)
        p = bpm_cuda.bpm_distance_plain(*args)
        if not torch.equal(k, p):
            fail(f"bpm edge: W={args[0].shape[0]} kernel != plain")

    n = 512
    refs = [np.where(rng.random(m) < 0.05, 0xFFFF, rng.integers(0, 4, m))
            .astype(np.int32) for m in rng.integers(1, 300, n)]
    quers = [np.where(rng.random(m) < 0.05, 0xFFFF, rng.integers(0, 4, m))
             .astype(np.int32) for m in rng.integers(1, 150, n)]
    pairs = BswPairs(rng.integers(0, 60, n).astype(np.int32), refs, quers)
    sc = dict(match=1, mismatch=-4, ambig=-1, o_del=6, e_del=1, o_ins=6,
              e_ins=1, zdrop=100, w=100)
    for batch, lanes in ((16, 8), (0, 16)):
        _, arrays = bsw.kernel_inputs(pairs, batch, lanes, match=1,
                                      end_bonus=5, o_ins=6, e_ins=1,
                                      o_del=6, e_del=1, w=100)
        args = [torch.from_numpy(a).cuda() for a in arrays]
        k = bsw_cuda.bsw_scores(*args, **sc)
        p = bsw_cuda.bsw_scores_plain(*args, **sc)
        if not all(torch.equal(a, b) for a, b in zip(k, p)):
            fail(f"bsw edge: batch={batch} lanes={lanes} kernel != plain")
    print("edge shapes: bpm W=1..3,33 and bsw ambiguous/16-batch agree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from genarchbench_tpu_torch.kernels import _build

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: {lib_path}")
    for ln in ptxas_summary(lib_path.parent / "ptxas.txt"):
        print("  ptxas", ln)
    WORK.mkdir(parents=True, exist_ok=True)

    rows = [bpm_phase(card),
            bsw_phase(card, "bsw", dict(seed=103, n=16384, ref_len=384,
                                        query_len=192), [], 8),
            bsw_phase(card, "bsw-i8", dict(seed=104, n=16384, ref_len=78,
                                           query_len=60), ["-i8"], 16)]
    edge_phase()
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
