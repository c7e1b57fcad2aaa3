"""Whole runs on the CPU at a small size: a cell added as files runs and
comes out correct; with the timed path broken underneath, or with the
control in the program's place, it comes out not correct."""

import time

import numpy as np
import pytest

from h100_bench import control
from h100_bench.harness.cell import load_cell
from h100_bench.harness.window import execute

SEED = 2**31 + 11
CONFIGS = ["chain", "fast-chain"]


def run_cell(repo, name, trace=False):
    cell = load_cell(name, repo)
    return execute(cell, SEED, 0.5, trace, "cpu", time.perf_counter(),
                   log=open("/dev/null", "w"))


@pytest.mark.parametrize("config", CONFIGS)
def test_a_cell_added_as_files_runs(bench_copy, config):
    run, res = run_cell(bench_copy, f"{config}.tiny")
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"dp_cups", "setup_s"}
    assert res["metrics"]["dp_cups"]["value"] > 0
    assert list(res)[-1] == "checks"
    assert all(c == {"value": 0, "limit": 0}
               for c in res["checks"].values())


def test_a_configuration_added_as_files_runs(bench_copy):
    """A configuration is its file, its adapter and its reference, found
    by its name: a copy of chain's under another name makes a cell."""
    import json
    import shutil
    bench = bench_copy / "h100_bench"
    for sub, ext in (("configs", "json"), ("adapters", "py"),
                     ("reference", "py")):
        shutil.copy(bench / sub / f"chain.{ext}",
                    bench / sub / f"chain-copy.{ext}")
    cfg = json.loads((bench / "configs" / "chain-copy.json").read_text())
    cfg["name"] = "chain-copy"
    (bench / "configs" / "chain-copy.json").write_text(json.dumps(cfg))
    b = json.loads((bench_copy / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="chain-copy",
                             file="h100_bench/configs/chain-copy.json"))
    b["workloads"].append({"name": "chain-copy.tiny", "config": "chain-copy",
                           "traffic": "tiny", "chips": 1, "why": "a copy"})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(b))
    _, res = run_cell(bench_copy, "chain-copy.tiny")
    assert res["correct"] is True and res["metrics"]["dp_cups"]["value"] > 0


@pytest.mark.parametrize("config", CONFIGS)
def test_a_traced_run_reads_the_program_layers(bench_copy, config):
    import json
    bench = bench_copy / "BENCHMARK.json"
    b = json.loads(bench.read_text())
    for m in b["per_layer"]:
        m["workloads"].append(f"{config}.tiny")
    bench.write_text(json.dumps(b))
    run, res = run_cell(bench_copy, f"{config}.tiny", trace=True)
    assert res["correct"] is True
    # the CPU has no device trace: those readers find nothing to read
    host = {"host_prep_share", "copy_share", "window_mfu"}
    assert 0 < res["metrics"]["host_prep_share"]["value"] < 100
    if config == "chain":
        # avg_qspan 15 needs more gap corrections than the device path
        # holds: every record goes to the scalar DP, and the loop no step
        assert set(res["metrics"]) == host | {"scalar_share"}
        assert run.stats["deferred"] == run.work[0]["records"]
        assert run.stats["steps"] == 0
        assert res["metrics"]["scalar_share"]["value"] > 0
    else:
        assert set(res["metrics"]) == host
        assert run.stats[run.cell.config["stats"]["steps"]] > 0


def unchanged(records):
    """Every anchor as if the DP step never ran: its own q_span, no
    parent."""
    out = []
    for r in records:
        span = ((r.y >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
        out.append((span, np.full(r.n, -1, np.int32), span))
    return out


def half(res):
    return res[:len(res) // 2] + [None] * (len(res) - len(res) // 2)


def altered(res):
    out = []
    for s, p, v in res:
        s = np.array(s)
        s[-1] += 1
        out.append((s, p, v))
    return out


FAULTS = {"state unchanged": lambda recs, res: unchanged(recs),
          "half the batch left out": lambda recs, res: half(res),
          "an answer altered": lambda recs, res: altered(res)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("config", CONFIGS)
def test_a_broken_timed_path_is_not_correct(bench_copy, monkeypatch, config,
                                            fault):
    cell = load_cell(f"{config}.tiny", bench_copy)
    adapter = cell.adapter()
    entry = adapter.run

    def broken(function, records, device, stats=None):
        return FAULTS[fault](records, entry(function, records, device,
                                            stats))

    monkeypatch.setattr(adapter, "run", broken)
    _, res = execute(cell, SEED, 0.5, False, "cpu", time.perf_counter(),
                     log=open("/dev/null", "w"))
    assert res["correct"] is False
    assert res["checks"]["mismatched_records"]["value"] > 0


def test_chain_f32_differs_only_at_multiples_of_20():
    """Why chain's control (its gap cost in float32) reads as the
    program: with minimap2's integer avg_qspan, k, the float32 cost
    equals the float64 one at every dd of k = 21 and differs, by one,
    only at some multiples of 20 for k = 15; such a predecessor seldom
    wins, and the sampled answers agree (PERF.md)."""
    from h100_bench.reference import _anchors
    dd = np.arange(5001, dtype=np.int32)
    for k, first in ((15, [20, 40, 60, 80, 120]), (21, [])):
        avg = np.float32(k)
        off = np.flatnonzero(_anchors.linear_gap(dd, avg, "f32")
                             != _anchors.linear_gap(dd, avg, "f64"))
        assert off[:5].tolist() == first and (off % 20 == 0).all()


def test_the_control_is_not_correct(bench_copy):
    """fast-chain's control (bfloat16) on a small `sr`: pairs, whose
    jump between mates puts the linear gap cost in play."""
    from conftest import add_cell
    name = add_cell(bench_copy, "fast-chain", "tiny-sr", "sr",
                    batch_bases=1000000, contigs=[200000, 200000],
                    check_records=4096)
    cell = load_cell(name, bench_copy)
    for seed in (SEED, SEED + 1, SEED + 2):
        low = control.readings(cell, seed, cell.config["control_precision"])
        assert low["mismatched_records"] > 0
        same = control.readings(cell, seed, cell.config["precision"])
        assert same["mismatched_records"] == 0
