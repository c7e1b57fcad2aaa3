"""Shared fixtures of the benchmark's own tests (not the repository's
`tests/`): run with `python -m pytest h100_bench/tests -q` from the root
of the repository; the tests marked `card` need a CUDA card and skip
without one."""

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# a small `ont`: a few reads of about 2 kb on two 30 kb contigs
TINY = {"batch_bases": 20000, "contigs": [30000, 30000], "length_mean": 2000,
        "length_sd": 1500, "check_records": 64}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The card's device name; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.cuda.get_device_name(0)


def add_cell(repo: pathlib.Path, config: str, traffic: str, base: str,
             **changes) -> str:
    """A traffic file `traffic` (the traffic `base` with `changes`) and a
    cell `<config>.<traffic>` added to the benchmark at `repo`: files
    and entries only."""
    bench = repo / "h100_bench"
    t = json.loads((bench / "traffic" / f"{base}.json").read_text())
    t.update(changes)
    (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(t))
    b = json.loads((repo / "BENCHMARK.json").read_text())
    name = f"{config}.{traffic}"
    if name not in {w["name"] for w in b["workloads"]}:
        b["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a small cell for the tests"})
        (repo / "BENCHMARK.json").write_text(json.dumps(b))
    return name


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and h100_bench/ with small cells
    `chain.tiny` and `fast-chain.tiny` added to it."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for config in ("chain", "fast-chain"):
        add_cell(tmp_path, config, "tiny", "ont", **TINY)
    return tmp_path
