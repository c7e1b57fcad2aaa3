"""The benchmark's one command on the card, at a small size: a cell comes
out correct and reports what the contract asks.  Needs a CUDA card."""

import json
import subprocess
import sys

import pytest

from h100_bench.harness.cell import REPO


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("config", ["chain", "fast-chain"])
def test_a_small_cell_on_the_card(card, bench_copy, config, trace):
    (bench_copy / "genarchbench_tpu_torch").symlink_to(
        REPO / "genarchbench_tpu_torch")
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", f"{config}.tiny",
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=bench_copy)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == card
    assert out.stderr.strip().splitlines()[-1].startswith("missing_records")
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["breakdown"]["device_ops"]
    else:
        assert set(res["metrics"]) == {"dp_cups", "setup_s"}
