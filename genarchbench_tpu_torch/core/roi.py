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

`span` and `count` record a run's phases and counts, always: each span
is a `Span` in an in-memory ring of fixed size, in seconds of
`time.perf_counter`, and, while its thread is profiled, a
`torch.profiler.record_function` range, which lands in the profile on
the clock of the card's kernels and copies (a profile records only the
ranges of the thread that started it, and opening one costs several
times the rest of a span).  Each count is a `Count` in the same ring,
under the innermost open span.  `records()` returns a copy of the ring
and the number of records ever appended, which tells a reader whether
the ring has wrapped.  `Laps` splits a run into named phases for a
`stats=` dict; a span given one adds its own seconds, from its opening
to its close, so that the span and the dict share their boundaries.
"""

from __future__ import annotations

import collections
import itertools
import os
import sys
import threading
import time
from typing import Any, List, NamedTuple, Optional, Tuple, Union

import torch

from genarchbench_tpu_torch.core.config import EnvConfig


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
        self.trace_dir = trace_dir or EnvConfig.from_env().trace_dir
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

    def __call__(self, key: str, since: Optional[float] = None) -> float:
        """Mark the end of the phase `key`, begun at `since` (at the
        previous mark when None); returns the mark's time."""
        if self.stats is None:
            return time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        t0 = self._t if since is None else since
        self.stats[key] = self.stats.get(key, 0.0) + now - t0
        self._t = now
        return now


RING = 1 << 16      # records the ring keeps


class Span(NamedTuple):
    """A closed span, in seconds of `time.perf_counter`: `parent` is the
    span open in the same thread when it opened (0 for a root), `root`
    the outermost one (its own id for a root)."""
    id: int
    parent: int
    root: int
    name: str
    t0: float
    t1: float


class Count(NamedTuple):
    """`n` of `name`, counted at `t` inside the span `span` of the root
    `root` (0 and 0 outside any span)."""
    span: int
    root: int
    name: str
    n: int
    t: float


class Recorder:
    """The newest `size` spans and counts, in the order they closed or
    were counted, and `total`, the number ever appended."""

    def __init__(self, size: int = RING):
        self._ring = collections.deque(maxlen=size)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.total = 0

    def _stack(self) -> list:
        """The calling thread's open spans, outermost first."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _append(self, record: Union[Span, Count]) -> None:
        with self._lock:
            self._ring.append(record)
            self.total += 1

    def span(self, name: str, lap: Optional[Laps] = None,
             key: Optional[str] = None) -> "_SpanScope":
        """A context manager: the span `name`, a `Span` once it closes
        and, while a profile runs, a `record_function` range; given
        `lap`, the span's close is the mark `lap(key, since=its
        opening)`."""
        return _SpanScope(self, name, lap, key)

    def count(self, name: str, n: int) -> None:
        """`n` of `name`, under the innermost open span."""
        stack = self._stack()
        top = stack[-1] if stack else None
        self._append(Count(top.id if top else 0, top.root if top else 0,
                           name, int(n), time.perf_counter()))

    def records(self) -> Tuple[List[Union[Span, Count]], int]:
        """(a copy of the ring, the number of records ever appended)."""
        with self._lock:
            return list(self._ring), self.total


class _SpanScope:
    __slots__ = ("_recorder", "_name", "_lap", "_key", "_range", "_stack",
                 "id", "parent", "root", "t0")

    def __init__(self, recorder: Recorder, name: str, lap, key):
        self._recorder = recorder
        self._name = name
        self._lap = lap
        self._key = key

    def __enter__(self):
        stack = self._stack = self._recorder._stack()
        self.id = next(self._recorder._ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = 0, self.id
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        else:
            self._range = None
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = (time.perf_counter() if self._lap is None
              else self._lap(self._key, self.t0))
        self._stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._recorder._append(Span(self.id, self.parent, self.root,
                                    self._name, self.t0, t1))
        return False


# the process's recorder, which the benchmark reads
RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
records = RECORDER.records
