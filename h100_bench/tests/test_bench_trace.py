"""The trace readers on a canned event list: launches counted inside the
program's spans (graph launches too, a driver call inside a runtime call
once), busy time as the union of overlapping device intervals."""

import pytest

from h100_bench.harness.cell import BENCH_DIR, load_module
from h100_bench.harness.trace import summarize, union
from h100_bench.harness.window import WINDOW_SPAN


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    X("user_annotation", WINDOW_SPAN, 0, 1000),
    X("user_annotation", "chain.loop", 100, 400),
    X("gpu_user_annotation", "chain.loop", 200, 900),
    X("cuda_runtime", "cudaLaunchKernel", 150, 5),
    X("cuda_driver", "cuLaunchKernel", 151, 1),        # inside the above
    X("cuda_runtime", "cudaLaunchKernel", 250, 5),
    X("cuda_runtime", "cudaGraphLaunch", 300, 5),
    X("cuda_driver", "cuLaunchKernelEx", 450, 2),
    X("cuda_runtime", "cudaLaunchKernel", 600, 5),     # outside the span
    X("cuda_runtime", "cudaMemcpyAsync", 400, 5),
    X("kernel", "k1", 200, 100),
    X("kernel", "k2", 250, 100),
    X("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 400, 50),
    X("kernel", "k1", 900, 200),                       # ends past the window
    X("cpu_op", "aten::copy_", 600, 100),
    {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 10},
]


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]


def test_summary_of_a_canned_trace():
    s = summarize(EVENTS, WINDOW_SPAN, ["chain.loop"])
    assert s.launches == 4
    assert s.wall_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(300e-6)     # 200-350, 400-450, 900-1000
    assert s.kernel_s == pytest.approx(300e-6)
    assert s.device_ops[0] == ("k1", pytest.approx(200e-6))
    assert s.idle_gaps[0] == ("aten::copy_", pytest.approx(450e-6))
    assert s.idle_gaps[1] == ("chain.loop", pytest.approx(200e-6))
    assert len(s.idle_gaps) == 3


class FakeRun:
    def __init__(self, trace, stats):
        self.trace, self.stats = trace, stats
        self.cell = type("C", (), {"config": {"stats": {"steps": "steps"}}})


def test_readers_of_a_canned_trace():
    s = summarize(EVENTS, WINDOW_SPAN, ["chain.loop"])
    run = FakeRun(s, {"steps": 2})
    read = {m: load_module(BENCH_DIR / "metrics" / f"{m}.py").read
            for m in ("launches_per_step", "device_idle_share")}
    assert read["launches_per_step"](run) == pytest.approx(2.0)
    assert read["device_idle_share"](run) == pytest.approx(70.0)


def test_the_cores_come_back():
    import os
    from h100_bench.harness import cores
    start = os.sched_getaffinity(0)
    held = cores.pin(1)
    assert os.sched_getaffinity(0) == held and held <= start
    assert len(held) == 1 and max(held) == max(start)
    cores.release()
    assert os.sched_getaffinity(0) == start


def test_spread_and_its_trimmed_form():
    from h100_bench.spread import spread, trimmed
    v = [1.0, 2.0, 3.0, 4.0, 100.0]
    assert spread(v)[0] == 3.0
    assert trimmed(v) == spread([1.0, 2.0, 3.0, 4.0])[3]
