"""BENCHMARK.json against the benchmark contract's limits: names, units
and lines in the allowed characters, the keys each entry may have, and
every named file and reader present."""

import json
import re

import pytest

from h100_bench.harness.cell import BENCH_DIR, REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "h100_bench/run.py"]
    assert all(line(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["h100_bench"]
    assert isinstance(BENCH["run_seconds"], int)
    # 2 + 14 runs a cell for 24 cells, each run_seconds + 60 s, 180 s a
    # cell to compile and 1200 s spare must fit in 43200 s
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) \
        + 180 * cells + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))


def test_configs_and_cells():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert PATH.match(c["file"]) and c["file"].startswith("h100_bench/")
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert (BENCH_DIR / "adapters" / f"{c['name']}.py").exists()
        assert (BENCH_DIR / "reference" / f"{c['name']}.py").exists()
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[group]:
        extra = {"bound"} if group == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == METRIC_KEYS | extra
        assert m["better"] in ("lower", "higher")
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= cells
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    if group == "end_to_end":
        assert "setup_s" in e2e and len(e2e) >= 2


def test_file_names_under_paths():
    for p in BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(REPO).as_posix()
        assert PATH.match(rel), rel
