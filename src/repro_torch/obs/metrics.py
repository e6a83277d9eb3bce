"""Process-wide metrics registry: counters, gauges, histograms.

Port of ``repro.obs.metrics``, pure stdlib.

One registry (:data:`REGISTRY`) absorbs every counter the stack already
kept in fragments — plan-cache hit/miss/trace counts, KV-pool block
accounting, scheduler admission counters, per-backend dispatch counts —
behind stable dotted names (``plan_cache.hits``, ``kv.blocks_in_use``,
``serve.ttft_s``, ``runtime.backend_dispatch{backend=...}``; the glossary
lives in ``docs/observability.md``).  Three instrument kinds:

  * :class:`Counter` — monotonically increasing (``inc``);
  * :class:`Gauge` — a point-in-time value (``set``);
  * :class:`Histogram` — observations bucketed into FIXED, deterministic
    edges chosen at creation (no dynamic rebinning — two runs of the same
    workload produce identical bucket vectors), plus running count/sum and
    min/max.

All three support label sets (``counter.labels(backend="fused").inc()``);
each label combination is an independent series, exported as
``name{k=v,...}``.

**Default-off, zero-cost when off.**  The module-level :func:`enabled`
flag (set by :func:`enable` / :func:`disable`, seeded from the
``REPRO_OBS`` env var) gates every record path: a disabled instrument's
``inc``/``set``/``observe`` is one boolean check and a return, and the
serving hot paths additionally skip their obs blocks entirely.  Greedy
token streams are bit-identical with observability on or off — recording
never feeds back into execution.

Sources that already keep their own counters (the plan cache, the KV
pool) are pulled at *snapshot time* through **collectors** — callables
registered with :func:`MetricsRegistry.register_collector` that return
``{dotted_name: value}`` mappings — so the hot paths those counters live
on pay nothing extra.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import os
import threading
import time

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "DEFAULT_TIME_EDGES_S",
    "enable",
    "disable",
    "enabled",
    "SETUP_PHASES",
    "setup_phase",
]

ENV_OBS_VAR = "REPRO_OBS"

# Fixed latency bucket edges (seconds): 100us .. ~100s, x4 steps.  Chosen
# once, never rebinned — deterministic across runs and backends.
DEFAULT_TIME_EDGES_S = (
    0.0001, 0.0004, 0.0016, 0.0064, 0.0256, 0.1024, 0.4096, 1.6384,
    6.5536, 26.2144, 104.8576,
)

_ENABLED = os.environ.get(ENV_OBS_VAR, "").strip().lower() in (
    "1", "true", "on", "yes")


def enabled() -> bool:
    """Is observability recording on for this process?"""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def format_series(name: str, labels: tuple) -> str:
    """``name`` or ``name{k=v,...}`` — the exported series identity."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class _Instrument:
    """Shared label-series bookkeeping for all three instrument kinds."""

    kind = "?"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict = {}           # label tuple -> series state
        self._lock = threading.Lock()

    def labels(self, **labels):
        """A bound view of this instrument for one label combination."""
        return _Bound(self, _label_key(labels))

    def _get(self, key: tuple):
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.setdefault(key, self._new_series())
        return s

    def series(self) -> dict:
        """Snapshot of every label series: label tuple -> exported value."""
        with self._lock:
            return {k: self._export(s) for k, s in self._series.items()}

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


class _Bound:
    """One (instrument, label set) pair; forwards the record methods."""

    def __init__(self, inst, key):
        self._inst = inst
        self._key = key

    def inc(self, n=1):
        self._inst._inc(self._key, n)

    def set(self, v):
        self._inst._set(self._key, v)

    def observe(self, v):
        self._inst._observe(self._key, v)


class Counter(_Instrument):
    kind = "counter"

    def _new_series(self):
        return [0]

    def _export(self, s):
        return s[0]

    def _inc(self, key, n):
        if not _ENABLED:
            return
        self._get(key)[0] += n

    def inc(self, n=1, **labels):
        self._inc(_label_key(labels), n)


class Gauge(_Instrument):
    kind = "gauge"

    def _new_series(self):
        return [0.0]

    def _export(self, s):
        return s[0]

    def _set(self, key, v):
        if not _ENABLED:
            return
        self._get(key)[0] = v

    def set(self, v, **labels):
        self._set(_label_key(labels), v)


@dataclasses.dataclass
class _HistSeries:
    counts: list                 # len(edges) + 1 (the last is +Inf overflow)
    count: int = 0
    sum: float = 0.0
    min: float | None = None
    max: float | None = None


class Histogram(_Instrument):
    """Fixed-edge histogram: ``edges[i]`` is the inclusive upper bound of
    bucket i; observations past the last edge land in the +Inf bucket."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 edges: tuple = DEFAULT_TIME_EDGES_S):
        super().__init__(name, help)
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(f"histogram edges must strictly increase: {edges}")
        self.edges = tuple(float(e) for e in edges)

    def _new_series(self):
        return _HistSeries(counts=[0] * (len(self.edges) + 1))

    def _export(self, s: _HistSeries) -> dict:
        return {
            "edges": list(self.edges),
            "counts": list(s.counts),
            "count": s.count,
            "sum": s.sum,
            "min": s.min,
            "max": s.max,
            "mean": (s.sum / s.count) if s.count else None,
        }

    def _observe(self, key, v):
        if not _ENABLED:
            return
        v = float(v)
        s = self._get(key)
        s.counts[bisect.bisect_left(self.edges, v)] += 1
        s.count += 1
        s.sum += v
        s.min = v if s.min is None else min(s.min, v)
        s.max = v if s.max is None else max(s.max, v)

    def observe(self, v, **labels):
        self._observe(_label_key(labels), v)


class MetricsRegistry:
    """Name -> instrument map + snapshot-time collectors.

    ``counter``/``gauge``/``histogram`` are get-or-create: the first call
    for a name fixes its kind (and a histogram's edges); later calls with
    the same name return the same instrument, and a kind mismatch raises —
    two subsystems can never silently split one metric name.
    """

    def __init__(self):
        self._instruments: dict = {}
        self._collectors: list = []
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}"
                )
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  edges: tuple = DEFAULT_TIME_EDGES_S) -> Histogram:
        return self._get_or_create(Histogram, name, help, edges=edges)

    def register_collector(self, fn) -> None:
        """``fn() -> {key: value}``, pulled at every snapshot.

        Keys are dotted names, or ``(name, ((label, value), ...))`` tuples
        for labeled series; values are numbers, exported as gauges.  A
        registered instrument with the same series identity wins the
        collision.  Unregister with :meth:`unregister_collector`.
        """
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(self, fn) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect(self) -> list:
        """Every live series: ``(name, labels_tuple, kind, value)`` rows,
        sorted by series name — collector-sourced rows (exported as
        gauges) first, instrument series overriding on name collision."""
        rows: dict = {}
        with self._lock:
            instruments = list(self._instruments.values())
            collectors = list(self._collectors)
        for fn in collectors:
            for key, value in fn().items():
                name, labels = (key, ()) if isinstance(key, str) else (
                    key[0], tuple(key[1]))
                rows[(name, labels)] = (name, labels, "gauge", value)
        for inst in instruments:
            for labels, value in inst.series().items():
                rows[(inst.name, labels)] = (inst.name, labels, inst.kind,
                                             value)
        return [rows[k] for k in sorted(rows)]

    def snapshot(self) -> dict:
        """JSON-ready state: ``{"metrics": {series: {"kind", "value"}}}``
        with histogram values expanded to their bucket dicts; collector
        values merged in as gauges."""
        return {"metrics": {
            format_series(name, labels): {"kind": kind, "value": value}
            for name, labels, kind, value in self.collect()
        }}

    def reset(self, collectors: bool = False) -> None:
        """Zero every series (tests / process reuse).  Collectors survive by
        default — import-time registrations (e.g. the plan cache's) must
        keep feeding later snapshots; pass ``collectors=True`` to drop the
        per-instance ones too."""
        with self._lock:
            for inst in self._instruments.values():
                inst.reset()
            if collectors:
                self._collectors.clear()


# The process-wide registry every subsystem records into.
REGISTRY = MetricsRegistry()


# Host seconds of the program's set-up phases: quantizing a KAN stack or a
# KAN-FFN block, deploying a quantized stack into its padded bundle, and
# building and loading the kernel library.  Plain process counters, always
# kept (one clock read at each end of a phase), exported as
# ``setup.seconds{phase=...}`` at snapshot time.
SETUP_PHASES = ("quantize", "deploy", "kernel_build")
SETUP_SECONDS: collections.Counter = collections.Counter()


@contextlib.contextmanager
def setup_phase(phase: str):
    """Add the host seconds of the ``with`` body to ``phase``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SETUP_SECONDS[phase] += time.perf_counter() - t0


def _setup_collect() -> dict:
    return {("setup.seconds", (("phase", p),)): SETUP_SECONDS[p]
            for p in SETUP_PHASES}


REGISTRY.register_collector(_setup_collect)
