"""Run one cell of BENCHMARK.json once and print its result line.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program
(`genarchbench_tpu_torch`).  With --trace 0 the line carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics.  The numbers
that decide `correct` are printed beside their limits as the last lines
of standard error and under the line's last key, `checks`.  Exits with
a code other than 0, and prints no result, when there is no CUDA card
(or fewer than the cell asks for), or when JAX or the JAX package was
loaded in this process.
"""

import time

T0 = time.perf_counter()    # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "genarchbench_tpu"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="h100_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    repo = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo))
    # one card, and every build or kernel cache inside the checkout
    os.environ["GENARCH_DEVICE"] = "cuda"
    os.environ["GENARCH_DEVICES"] = "1"
    cache = repo / "build" / "h100_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    from h100_bench.harness.cell import load_cell
    from h100_bench.harness.cores import pin
    cell = load_cell(args.workload, repo)
    # The configuration's share of the host's cores for the program and
    # every thread it starts: the card waits on the host's launches, and
    # a process free to roam the shared host measures its neighbours.
    # The reference's workers, after the window, get the process's
    # starting set back (`harness/check.py`).
    pin(int(cell.config["host_cores"]))
    import torch
    torch.set_num_threads(int(cell.config["host_cores"]))
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from h100_bench.harness.window import execute
    _, result = execute(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda:0", T0)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"the run loaded {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
