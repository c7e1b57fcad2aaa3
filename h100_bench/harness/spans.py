"""The program's own spans and counts over the measured window.

The program records each batch as a root span, its phases as child
spans and its counts under them, in seconds of `time.perf_counter` (the
window's clock), in a ring it keeps in memory
(`genarchbench_tpu_torch.core.roi`: `records()` returns the ring and the
number of records ever appended).  The harness does not import the
program: it reads the module the adapter's entry has loaded, and finds
nothing where that module keeps no ring.

The window's roots are the root spans that lie inside one of its
batches; the denominator of every share is the batches' summed wall
time, with nothing synchronised beyond the batch's own end.  The warm,
`stats=` and profiled batches lie outside the window and are left out.
"""

from __future__ import annotations

import dataclasses
import sys
from collections import defaultdict
from typing import Dict, Optional, Sequence

RECORDER = "genarchbench_tpu_torch.core.roi"


@dataclasses.dataclass
class WindowSpans:
    wall_s: float               # the window's batches, summed
    roots: int                  # root spans inside them
    phase_s: Dict[str, float]   # phase -> seconds in the roots' children
    counts: Dict[str, float]    # count -> sum under the roots

    def share(self, phases: Sequence[str]) -> float:
        """The share (%) of the batch walls spent in `phases`."""
        return 100.0 * sum(self.phase_s.get(p, 0.0)
                           for p in phases) / self.wall_s


def _appended_at(record) -> float:
    """When the program appended `record`: a span as it closed."""
    return record.t1 if hasattr(record, "t1") else record.t


def _phase(name: str, root) -> str:
    """`name` without its root's prefix: `plan` of `chain.plan` under
    `chain.batch`."""
    head = root.name.rsplit(".", 1)[0] + "."
    return name[len(head):] if name.startswith(head) else name


def window_spans(run) -> Optional[WindowSpans]:
    """The program's records of `run`'s window, or None where the
    program keeps none (no recorder), where the ring has lost part of
    the window, where no root span lies inside it, or where the traced
    batch shows no device activity."""
    if run.trace is None or not run.trace.busy_s:
        return None
    records = getattr(sys.modules.get(RECORDER), "records", None)
    if records is None:
        return None
    ring, total = records()
    if total > len(ring) and (
            not ring or _appended_at(ring[0]) >= run.window[0][1]):
        return None
    batches = [(b0, b1) for _, b0, b1 in run.window]
    spans = [r for r in ring if hasattr(r, "t1")]
    roots = {s.id: s for s in spans if s.parent == 0
             and any(b0 <= s.t0 and s.t1 <= b1 for b0, b1 in batches)}
    if not roots:
        return None
    phase_s: Dict[str, float] = defaultdict(float)
    for s in spans:
        if s.parent in roots:
            phase_s[_phase(s.name, roots[s.parent])] += s.t1 - s.t0
    counts: Dict[str, float] = defaultdict(float)
    for r in ring:
        if not hasattr(r, "t1") and r.root in roots:
            counts[_phase(r.name, roots[r.root])] += r.n
    return WindowSpans(sum(b1 - b0 for b0, b1 in batches), len(roots),
                       dict(phase_s), dict(counts))
