"""What the benchmark reads from one profiled batch: a torch.profiler
trace exported in Chrome's trace format (`traceEvents`, times in us).

  * the window: the harness's own span around the batch;
  * launches: the host's kernel and graph launches (cudaLaunchKernel*,
    cudaLaunchCooperativeKernel*, cudaGraphLaunch*, and the driver's
    cuLaunchKernel* / cuGraphLaunch* where no runtime call holds them)
    that start inside the named spans of the program;
  * busy: the union of the device's activity intervals (kernels, copies,
    memsets) inside the window, so overlapping streams count once;
  * kernel time: the summed durations of the kernels inside the window;
  * the device operations that took most time, and the longest idle
    gaps, each named after the innermost host span or op open at its
    middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

LAUNCH = re.compile(r"^(cudaLaunch|cudaGraphLaunch|cuLaunch|cuGraphLaunch)")
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation"}
TOP = 10
NAME_CHARS = 160


@dataclasses.dataclass
class TraceSummary:
    wall_s: float
    busy_s: float
    kernel_s: float
    launches: int
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _spans(events, name: str) -> List[Tuple[float, float]]:
    return sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
                  if e.get("cat") == "user_annotation" and e["name"] == name)


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def count_launches(events, spans: Sequence[str]) -> int:
    """Host launches starting inside any of `spans`; a launch inside
    another counted launch (a runtime call and the driver call it makes)
    counts once."""
    inside = union(iv for s in spans for iv in _spans(events, s))
    starts = [lo for lo, _ in inside]
    calls = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
                   if e.get("cat") in LAUNCH_CATS and LAUNCH.match(e["name"]))
    count, end = 0, float("-inf")
    for a, b in calls:
        if a < end:
            continue
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and a <= inside[k][1]:
            count += 1
            end = b
    return count


def summarize(events: List[dict], window: str,
              spans: Sequence[str]) -> TraceSummary:
    """The summary of the trace's `window` span (the first one)."""
    events = [e for e in events if e.get("ph") == "X"]
    w0, w1 = _spans(events, window)[0]
    dev = [(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0.0), w1),
            e["name"], e["cat"]) for e in events
           if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e.get("dur", 0.0) > w0]
    busy = union((a, b) for a, b, _, _ in dev)
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, name, _ in dev:
        by_name[name[:NAME_CHARS]] += (b - a) / 1e6
    host = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
            if e.get("cat") in HOST_CATS and e["name"] != window]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                   if b > a), reverse=True)[:TOP]
    idle = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        open_ = [(s, name) for s, e, name in host if s <= mid <= e]
        label = max(open_)[1] if open_ else "host outside torch ops"
        idle.append((label[:NAME_CHARS], length / 1e6))
    return TraceSummary(
        wall_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernel_s=sum(b - a for a, b, _, cat in dev if cat == "kernel") / 1e6,
        launches=count_launches(events, spans),
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=idle)
