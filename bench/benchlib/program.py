"""What the program reports of itself in a traced slice: its counters'
change over the slice, host time in one range within another, and the
slice's idle and host time by the innermost range the host was in
(``Trace.host_at``'s rule: the shortest range around the instant).

Every reader of these returns None where the program reports nothing of
the kind (a program without the range or the counter), so a metric new to
the benchmark reads nothing, and raises nothing, on an older program.
"""

from __future__ import annotations

import bisect
import collections

from .stats import merged, union_length

# what ``Trace.host_at`` names an instant outside every range
OUTSIDE = "host outside the program's ranges"


def counters(rec) -> dict | None:
    """The change of the program's counters over the traced slice, by
    series name (``runtime.rows{kind=real}``, ...): what ``obs`` gained
    while its profiler annotations were on.  None for an untraced run or
    a program that does not keep them."""
    if rec.trace is None:
        return None
    from repro_torch import obs

    read = getattr(obs, "profiled_counts", None)
    return (read() or None) if read is not None else None


def share(part, whole) -> float | None:
    """``part`` over ``whole`` in %, None where either is missing or the
    whole is zero."""
    if part is None or not whole:
        return None
    return 100.0 * part / whole


def host_s_within(trace, name: str, outer: str) -> float | None:
    """Host seconds inside the ``name`` ranges that start inside an
    ``outer`` range (the program's ranges nest); None where the slice has
    no ``name`` range."""
    if name not in trace.host_ranges:
        return None
    outs = merged(trace.host_ranges.get(outer, ()))
    starts = [s for s, _ in outs]
    kept = []
    for s, e in trace.host_ranges[name]:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < outs[i][1]:
            kept.append((s, e))
    return union_length(kept)


def timeline(trace) -> list:
    """The slice cut into (start, end, stack) pieces: ``stack`` holds the
    program's ranges the host was in, longest first (empty outside them),
    so that its last is the shortest range around the piece: the
    innermost range of ``Trace.host_at``, by the same rule."""
    spans = [(s, e, name) for name, ss in trace.host_ranges.items()
             for s, e in ss if e > s]
    events = sorted([(e, 0, i) for i, (_, e, _) in enumerate(spans)]
                    + [(s, 1, i) for i, (s, _, _) in enumerate(spans)])
    points = sorted({0.0, trace.window_s, *(t for t, _, _ in events)})
    out, active, j = [], set(), 0
    for a, b in zip(points, points[1:]):
        while j < len(events) and events[j][0] <= a:
            _, opens, i = events[j]
            if opens:
                active.add(i)
            else:
                active.discard(i)
            j += 1
        # longest first; of equal ones, host_at's pick (the first) last
        out.append((a, b, tuple(spans[i][2] for i in sorted(
            active, key=lambda i: (spans[i][0] - spans[i][1], -i)))))
    return out


def idle_pieces(trace) -> list:
    """The (start, end) intervals of the slice in which no operation ran
    on the device."""
    busy = merged((s, e) for s, e, _, _ in trace.ops)
    edges = [0.0] + [x for se in busy for x in se] + [trace.window_s]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def _overlap_by(pieces, spans, name_of) -> dict:
    """Seconds of ``spans`` that fall in each timeline piece, summed by
    ``name_of(stack)``."""
    out = collections.Counter()
    starts = [p[0] for p in pieces]
    for a, b in spans:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            s, e, stack = pieces[i]
            lo, hi = max(a, s), min(b, e)
            if hi > lo:
                out[name_of(stack)] += hi - lo
            i += 1
    return dict(out)


def innermost(stack: tuple) -> str:
    return stack[-1] if stack else OUTSIDE


def idle_by_range(trace) -> dict:
    """Idle seconds of the slice by the innermost range the host was in
    while the device idled."""
    return _overlap_by(timeline(trace), idle_pieces(trace), innermost)


def host_by_range(trace, whole: tuple = ("serve.prefill",)) -> dict:
    """The slice's wall by the innermost range the host was in, with the
    ranges named in ``whole`` counted whole (what nests inside them goes
    to them)."""
    def name_of(stack):
        for n in stack:
            if n in whole:
                return n
        return innermost(stack)

    return _overlap_by(timeline(trace), [(0.0, trace.window_s)], name_of)
