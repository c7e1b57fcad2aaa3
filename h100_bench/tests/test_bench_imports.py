"""Nothing the benchmark runs loads JAX or the JAX package
(`genarchbench_tpu`), compared by whole top-level names; the reference,
the generator and the harness import nothing of the program."""

import ast
import subprocess
import sys

from h100_bench.harness.cell import BENCH_DIR, REPO
from h100_bench.run import FORBIDDEN

PROGRAM = "genarchbench_tpu_torch"


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        assert not set(imported(path)) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_program():
    for sub in ("reference", "generators", "harness", "metrics"):
        for path in (BENCH_DIR / sub).rglob("*.py"):
            assert PROGRAM not in set(imported(path)), path


def test_a_run_loads_no_jax(bench_copy):
    code = (
        "import sys, time, pathlib\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from h100_bench.harness.cell import load_cell\n"
        "from h100_bench.harness.window import execute\n"
        "from h100_bench.run import FORBIDDEN\n"
        "if __name__ == '__main__':\n"
        f"    repo = pathlib.Path({str(bench_copy)!r})\n"
        "    cell = load_cell('chain.tiny', repo)\n"
        "    execute(cell, 7, 0.2, True, 'cpu', time.perf_counter(),\n"
        "            log=open('/dev/null', 'w'))\n"
        "    top = {m.split('.')[0] for m in sys.modules}\n"
        "    print(sorted(top & FORBIDDEN))\n"
        "    print(sorted(m for m in sys.modules\n"
        "                 if m.startswith('genarchbench')))\n")
    script = bench_copy / "probe.py"
    script.write_text(code)
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded, program = out.stdout.strip().splitlines()[-2:]
    assert loaded == "[]"
    assert "genarchbench_tpu_torch.kernels.chain" in program
