"""Unified observability: metrics registry, request tracing, structured logs.

Port of ``repro.obs`` (pure stdlib but for :func:`trace.profile_scope`,
which wraps ``torch.profiler.record_function``).  The serve/runtime stack
grew counters in fragments — ``Scheduler.stats()``,
the plan cache's hit/miss/trace counts, ``ServeEngine.compile_stats()`` /
``kv_stats()``, ad-hoc ``log=`` lambdas.  This package gives them one
shared schema and one way out of the process:

  * :mod:`repro_torch.obs.metrics` — a process-wide registry of counters /
    gauges / fixed-bucket histograms under stable dotted names
    (``plan_cache.hits``, ``kv.blocks_in_use``, ``serve.ttft_s``,
    ``runtime.backend_dispatch{backend=...}``), default-off and zero-cost
    when off; existing counter owners feed it through snapshot-time
    collectors.
  * :mod:`repro_torch.obs.trace` — per-request span timelines recorded on the
    scheduler's injectable clock (deterministic under ``ManualClock``),
    exported as JSONL or Chrome-trace JSON, plus ``torch.profiler``
    ranges (``record_function``) around the dispatch sites.
  * :mod:`repro_torch.obs.logging` — one leveled structured logger
    (``REPRO_LOG_LEVEL``) replacing the ad-hoc ``log=`` lambdas, with the
    bare-callable back-compat path preserved.
  * :mod:`repro_torch.obs.exposition` — Prometheus text format, JSON snapshot,
    and a stdlib HTTP ``/metrics`` server.

Metric names, the span taxonomy and the exposition formats are the
reference's (``docs/observability.md``), with two differences of name in
what the collectors feed: ``plan_cache.traces`` counts the port's plan
builds, and ``runtime.backend_dispatch`` labels the fused backend
``fused`` where the reference says ``pallas``.  The port's collectors also
feed series the reference has not: ``runtime.rows{kind=real|pad}``,
``runtime.h2d_bytes``, ``serve.prompt_tokens{kind=real|pad}`` and
``setup.seconds{phase=quantize|deploy|kernel_build}``.

    from repro_torch import obs
    obs.enable()
    obs.REGISTRY.counter("serve.submitted").inc()
    obs.REGISTRY.histogram("serve.ttft_s").observe(0.042)
    print(obs.prometheus_text())
"""

from .logging import (
    ENV_LOG_LEVEL_VAR,
    LEVELS,
    Logger,
    as_logger,
    get_logger,
)
from .exposition import (
    dump_metrics,
    parse_prometheus_text,
    prometheus_text,
    start_metrics_server,
)
from .metrics import (
    DEFAULT_TIME_EDGES_S,
    ENV_OBS_VAR,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    disable,
    enable,
    enabled,
    setup_phase,
)
from .trace import (
    Span,
    Tracer,
    disable_profiler_annotations,
    enable_profiler_annotations,
    profile_scope,
    profiled_counts,
    profiler_annotations_enabled,
)

__all__ = [
    "DEFAULT_TIME_EDGES_S",
    "ENV_LOG_LEVEL_VAR",
    "ENV_OBS_VAR",
    "LEVELS",
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "Logger",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "as_logger",
    "disable",
    "disable_profiler_annotations",
    "dump_metrics",
    "enable",
    "enable_profiler_annotations",
    "enabled",
    "get_logger",
    "parse_prometheus_text",
    "profile_scope",
    "profiled_counts",
    "profiler_annotations_enabled",
    "prometheus_text",
    "setup_phase",
    "start_metrics_server",
]
