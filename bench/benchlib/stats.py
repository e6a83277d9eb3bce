"""Percentiles of samples and lengths of unions of intervals."""

from __future__ import annotations

import math


def percentile(xs, q: float) -> float | None:
    """The ``q``-th percentile (0..100) of ``xs`` by linear interpolation
    between the closest ranks (numpy's default); None for no sample."""
    s = sorted(xs)
    if not s:
        return None
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals) -> list:
    """Disjoint, sorted cover of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]
