"""Region-of-interest (ROI) instrumentation.

The same `ROITimer` as the JAX package's (reference idiom:
chain/src/main.cpp:19-38,112-190), on PyTorch:

  * wall-clock timing of the region, with `sync` waiting for the card
    (`torch.cuda.synchronize`) before the clock stops,
  * an NVTX range `roi_<name>` around the region on a CUDA host, so the
    region is findable in a trace,
  * optional `torch.profiler` capture when `GENARCH_TRACE_DIR` is set
    (a Chrome trace `roi_<name>.json` in that directory),
  * the kernel's greppable timing line (see BASELINE.md's table).

`Laps` splits a run into named phases for a `stats=` dict.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Optional

import torch


class ROITimer:
    """Times a region of device work; prints a reference-compatible line.

    Usage:
        roi = ROITimer("bpm", timing_line="=> Time.Benchmark {t:.2f} s")
        with roi:
            out = work(x)
            roi.sync(out)          # wait for the card inside the ROI
        roi.report()               # prints the timing line to stderr
    """

    def __init__(self, name: str, timing_line: str = "Kernel time: {t} sec",
                 trace_dir: Optional[str] = None):
        self.name = name
        self.timing_line = timing_line
        self.trace_dir = trace_dir or os.environ.get("GENARCH_TRACE_DIR")
        self.elapsed = 0.0
        self._t0 = None
        self._prof = None
        self._nvtx = torch.cuda.is_available()

    def __enter__(self):
        if self.trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        if self._nvtx:
            torch.cuda.nvtx.range_push(f"roi_{self.name}")
        self._t0 = time.perf_counter()
        return self

    def sync(self, *values: Any) -> None:
        """Wait for the card's queued work (call before leaving the ROI).
        Values are accepted for the JAX API's sake; results that reached
        the host as numpy arrays are already complete."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.trace_dir, f"roi_{self.name}.json"))
            self._prof = None
        return False

    def report(self, file=None, **extra) -> None:
        line = self.timing_line.format(t=self.elapsed, **extra)
        print(line, file=file if file is not None else sys.stderr, flush=True)


class Laps:
    """Wall seconds between successive marks, summed by name into
    `stats`, with a sync of `device` at each mark so that a phase holds
    its own device work; every mark is a no-op when `stats` is None."""

    def __init__(self, stats: Optional[dict], device: torch.device):
        self.stats = stats
        self.device = device
        self._t = time.perf_counter()

    def __call__(self, key: str) -> None:
        if self.stats is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stats[key] = self.stats.get(key, 0.0) + now - self._t
        self._t = now
