"""Per-request span tracing: deterministic timelines over the serve stack.

A :class:`Tracer` records **spans** (named intervals with attributes and a
parent) and **events** (named instants) against an injectable clock — the
same clock the scheduler runs on, so a workload driven by
``scheduler.ManualClock`` produces *byte-identical* JSONL traces run to
run: span ids are sequence numbers, timestamps come from the manual
clock, and export order is record order.  The scheduler threads one span
tree per request through its lifecycle::

    request              (submit -> done/expired)
      queued             (submit -> admit | expiry)
      prefill            (admit -> first token; chunks= counts rounds)
      * first_token      (instant)
      decode             (first token -> done; tokens=)

Two export formats:

  * :meth:`Tracer.export_jsonl` — one JSON object per line, schema
    ``{"type": "span"|"event", "name", "id", "parent", "rid", "t0",
    "t1", "attrs"}`` (events carry ``t0`` only).
  * :meth:`Tracer.export_chrome` — Chrome ``chrome://tracing`` / Perfetto
    JSON (complete ``"X"`` events, microsecond timestamps, one row per
    request id), so a served workload can be read as a timeline.

For on-device visibility, :func:`profile_scope` wraps host-side sites
(the scheduler's round, its sampling and token emission, the engine's
prefill / decode / verify calls, each layer's attention and FFN and a
whole-prompt prefill's LM head, the drafter's propose loop, and the
executor's host copy, plan lookup, entry coding and kernel dispatch) in
``torch.profiler.record_function`` when profiling is enabled
(:func:`enable_profiler_annotations`), so the kernels each launches nest
under the serving spans in a ``torch.profiler`` trace.  Off by default and
a shared no-op context manager when off.  :func:`profiled_counts` gives
what the registry's counters gained while annotations were on.

Port of ``repro.obs.trace``; the span tree, ids, timestamps and both
export formats are the reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

__all__ = [
    "Span",
    "Tracer",
    "profile_scope",
    "enable_profiler_annotations",
    "disable_profiler_annotations",
    "profiled_counts",
    "profiler_annotations_enabled",
]


@dataclasses.dataclass
class Span:
    """One named interval; ``end()`` via the owning tracer."""

    name: str
    id: int
    parent: int | None
    rid: int | None
    t0: float
    t1: float | None = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def open(self) -> bool:
        return self.t1 is None


class Tracer:
    """Append-only span/event recorder with deterministic ids and times.

    ``clock`` is any zero-arg callable returning seconds (the scheduler
    passes its own, so trace timestamps share the ``arrival_s`` timebase);
    default wall ``time.perf_counter`` rebased to 0 at construction.
    ``max_records`` bounds memory for long-lived servers: the oldest
    *closed* records are dropped once exceeded (export notes the drop).
    """

    def __init__(self, clock=None, max_records: int = 100_000):
        if clock is None:
            t0 = time.perf_counter()
            clock = lambda: time.perf_counter() - t0
        self._now = clock
        self.max_records = max_records
        self._records: list = []       # Span | event dicts, record order
        self._open = 0
        self._next_id = 0
        self.dropped = 0

    # -- recording --------------------------------------------------------

    def begin(self, name: str, parent: Span | None = None,
              rid: int | None = None, **attrs) -> Span:
        """Open a span; close it with :meth:`end` (spans here are not
        lexically scoped — a request span stays open across many
        scheduling rounds)."""
        span = Span(
            name=name, id=self._next_id,
            parent=None if parent is None else parent.id,
            rid=rid if rid is not None else (
                None if parent is None else parent.rid),
            t0=self._now(), attrs=dict(attrs),
        )
        self._next_id += 1
        self._records.append(span)
        self._open += 1
        return span

    def end(self, span: Span, **attrs) -> Span:
        if span.t1 is not None:
            raise ValueError(f"span {span.name}#{span.id} already ended")
        span.t1 = self._now()
        span.attrs.update(attrs)
        self._open -= 1
        self._trim()
        return span

    def event(self, name: str, parent: Span | None = None,
              rid: int | None = None, **attrs) -> None:
        """A named instant (exported with ``t0`` only)."""
        self._records.append({
            "name": name, "id": self._next_id,
            "parent": None if parent is None else parent.id,
            "rid": rid if rid is not None else (
                None if parent is None else parent.rid),
            "t0": self._now(), "attrs": dict(attrs),
        })
        self._next_id += 1
        self._trim()

    @contextlib.contextmanager
    def span(self, name: str, parent: Span | None = None,
             rid: int | None = None, **attrs):
        """Lexically-scoped convenience over begin/end."""
        s = self.begin(name, parent=parent, rid=rid, **attrs)
        try:
            yield s
        finally:
            self.end(s)

    def _trim(self) -> None:
        # drop oldest CLOSED records past the cap; open spans must survive
        # (their end() still mutates them in place)
        excess = len(self._records) - self.max_records
        if excess <= 0:
            return
        keep = []
        for r in self._records:
            if excess > 0 and not (isinstance(r, Span) and r.open):
                excess -= 1
                self.dropped += 1
            else:
                keep.append(r)
        self._records = keep

    # -- export -----------------------------------------------------------

    def records(self) -> list:
        """Every record as a JSON-ready dict, in record order."""
        out = []
        for r in self._records:
            if isinstance(r, Span):
                out.append({
                    "type": "span", "name": r.name, "id": r.id,
                    "parent": r.parent, "rid": r.rid,
                    "t0": round(r.t0, 9),
                    "t1": None if r.t1 is None else round(r.t1, 9),
                    "attrs": r.attrs,
                })
            else:
                out.append({
                    "type": "event", "name": r["name"], "id": r["id"],
                    "parent": r["parent"], "rid": r["rid"],
                    "t0": round(r["t0"], 9), "attrs": r["attrs"],
                })
        return out

    def skeleton(self) -> list:
        """The payload-free span tree: (type, name, id, parent, rid, t0, t1)
        tuples.  The trace-determinism acceptance compares THIS across
        backends — attrs may legitimately differ (e.g. ``backend=``)."""
        return [
            (d["type"], d["name"], d["id"], d["parent"], d["rid"],
             d["t0"], d.get("t1"))
            for d in self.records()
        ]

    def export_jsonl(self, path) -> None:
        """One compact JSON object per line, record order; deterministic
        byte-for-byte for a deterministic-clock run."""
        with open(path, "w") as f:
            for d in self.records():
                f.write(json.dumps(d, sort_keys=True,
                                   separators=(",", ":")) + "\n")
            if self.dropped:
                f.write(json.dumps(
                    {"type": "meta", "dropped_records": self.dropped},
                    sort_keys=True, separators=(",", ":")) + "\n")

    def export_chrome(self, path) -> None:
        """Chrome trace-event JSON: ``ph:"X"`` complete events in
        microseconds, ``tid`` = request id (-1 for global spans) so each
        request reads as one timeline row."""
        events = []
        for d in self.records():
            tid = -1 if d["rid"] is None else d["rid"]
            base = {"name": d["name"], "pid": 0, "tid": tid,
                    "ts": d["t0"] * 1e6, "args": d["attrs"]}
            if d["type"] == "span":
                t1 = d["t1"] if d["t1"] is not None else d["t0"]
                events.append({**base, "ph": "X",
                               "dur": (t1 - d["t0"]) * 1e6})
            else:
                events.append({**base, "ph": "i", "s": "t"})
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)

    def clear(self) -> None:
        self._records = []
        self._open = 0
        self._next_id = 0
        self.dropped = 0


# -- torch.profiler annotation hooks ----------------------------------------

_PROFILER_ANNOTATIONS = False
# one shared null context: an off scope costs a flag check and nothing else
_NULL_SCOPE = contextlib.nullcontext()
# numeric registry series read when annotations were last turned on, and
# their change over the last annotated interval (profiled_counts)
_COUNTS_AT_ENABLE: dict = {}
_PROFILED_COUNTS: dict = {}


def _numeric_series() -> dict:
    """Every numeric series of ``obs.REGISTRY`` (collector-fed counters
    included; histograms left out), by exported series name."""
    from .metrics import REGISTRY, format_series

    return {format_series(name, labels): value
            for name, labels, _, value in REGISTRY.collect()
            if isinstance(value, (int, float))}


def enable_profiler_annotations() -> None:
    """Turn host-side ``torch.profiler.record_function`` ranges on for the
    instrumented sites (scheduler rounds, engine steps, model layers,
    drafter, executor), and read the registry's numeric series so that
    :func:`profiled_counts` can give what the annotated interval added."""
    global _PROFILER_ANNOTATIONS, _COUNTS_AT_ENABLE
    _COUNTS_AT_ENABLE = _numeric_series()
    _PROFILER_ANNOTATIONS = True


def disable_profiler_annotations() -> None:
    global _PROFILER_ANNOTATIONS, _PROFILED_COUNTS
    if _PROFILER_ANNOTATIONS:
        now = _numeric_series()
        _PROFILED_COUNTS = {k: v - _COUNTS_AT_ENABLE.get(k, 0)
                            for k, v in now.items()}
    _PROFILER_ANNOTATIONS = False


def profiler_annotations_enabled() -> bool:
    return _PROFILER_ANNOTATIONS


def profiled_counts() -> dict:
    """The change of every numeric registry series (``runtime.rows{kind=
    real}``, ``serve.prompt_tokens{kind=pad}``, ...) over the last
    interval in which profiler annotations were on, by series name: what
    the program did while a profiler watched it.  Empty before the first
    such interval has ended."""
    return dict(_PROFILED_COUNTS)


def profile_scope(name: str):
    """``torch.profiler.record_function(name)`` when annotations are
    enabled; one shared null context otherwise, safe to wrap hot dispatch
    sites unconditionally.  A ``record_function`` range has a name only:
    call sites pass a constant string."""
    if not _PROFILER_ANNOTATIONS:
        return _NULL_SCOPE
    import torch

    return torch.profiler.record_function(name)
