"""Golden-output checking rules.

Replicates the per-kernel `after_run` comparison semantics of the reference
regression scripts (SURVEY.md §4):
  exact         — byte-identical diff (chain, fast-chain, bsw, fmi, pileup, poa,
                  nn-base)
  sorted        — order-insensitive: sort lines then diff (bpm, wfa, dbg,
                  nn-variant rows)
  tolerant_abea — compare only named TSV columns, allow <= `max_diff` rows to
                  differ (abea: cols reference_kmer/model_kmer, <= 10 rows;
                  reference: abea/scripts/regression_small.sh:79-88)
  scalar        — compare one extracted scalar (kmer-cnt: "Total k-mers N")
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


class CheckResult:
    def __init__(self, ok: bool, detail: str = ""):
        self.ok = ok
        self.detail = detail

    def __bool__(self):
        return self.ok

    def __repr__(self):
        return f"CheckResult(ok={self.ok}, detail={self.detail!r})"


def check_exact(out_lines: Sequence[str], ref_lines: Sequence[str]) -> CheckResult:
    if len(out_lines) != len(ref_lines):
        return CheckResult(False, f"line count {len(out_lines)} != {len(ref_lines)}")
    for i, (a, b) in enumerate(zip(out_lines, ref_lines)):
        if a != b:
            return CheckResult(False, f"first diff at line {i}: {a!r} != {b!r}")
    return CheckResult(True)


def check_sorted(out_lines: Sequence[str], ref_lines: Sequence[str]) -> CheckResult:
    return check_exact(sorted(out_lines), sorted(ref_lines))


def check_scalar(out_value, ref_value, rel_tol: float = 0.0) -> CheckResult:
    if rel_tol == 0.0:
        ok = out_value == ref_value
    else:
        ok = abs(out_value - ref_value) <= rel_tol * max(abs(ref_value), 1e-30)
    return CheckResult(ok, f"{out_value} vs {ref_value}")


def check_tolerant_columns(out_lines: Sequence[str], ref_lines: Sequence[str],
                           columns: Tuple[int, ...] = (2, 9),
                           max_diff: int = 10) -> CheckResult:
    """abea rule: diff only `columns` (0-based) of each TSV row; allow up to
    `max_diff` differing rows (reference allows <= 10)."""
    def proj(lines: Sequence[str]) -> List[Tuple[str, ...]]:
        out = []
        for ln in lines:
            f = ln.rstrip("\n").split("\t")
            out.append(tuple(f[c] if c < len(f) else "" for c in columns))
        return out

    a, b = proj(out_lines), proj(ref_lines)
    if len(a) != len(b):
        return CheckResult(False, f"row count {len(a)} != {len(b)}")
    ndiff = sum(1 for x, y in zip(a, b) if x != y)
    return CheckResult(ndiff <= max_diff, f"{ndiff} differing rows (allowed {max_diff})")


RULES = {
    "exact": check_exact,
    "sorted": check_sorted,
    "tolerant_abea": check_tolerant_columns,
}
