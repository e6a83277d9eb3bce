"""Backend-pluggable KAN runtime: executor registry + plan cache.

Port of ``repro.runtime`` (the KAN half; attention dispatch waits for the
LM slice).  See :mod:`.executor` for the ``ref`` / ``fused`` backends and
``REPRO_KAN_BACKEND`` resolution, :mod:`.plancache` for batch bucketing.

    from repro_torch import runtime
    y = runtime.execute(dep, x)                  # resolved backend
    y = runtime.execute(dep, x, backend="ref")   # the layered oracle
"""

from .executor import (
    ENV_BACKEND_VAR,
    FusedExecutor,
    RefExecutor,
    available_backends,
    dispatch_counts,
    get_executor,
    ref_composition,
    register_executor,
    reset_dispatch_counts,
    resolve_backend,
    use_backend,
)
from .plancache import PLAN_CACHE, PlanCache, PlanKey, bucket_batch

__all__ = [
    "ENV_BACKEND_VAR",
    "FusedExecutor",
    "PLAN_CACHE",
    "PlanCache",
    "PlanKey",
    "RefExecutor",
    "available_backends",
    "bucket_batch",
    "cache_stats",
    "dispatch_counts",
    "execute",
    "get_executor",
    "ref_composition",
    "register_executor",
    "reset_cache",
    "reset_dispatch_counts",
    "resolve_backend",
    "use_backend",
]


def execute(dep, x, *, backend=None, default="fused", **opts):
    """Run a deployed KAN bundle through the resolved backend."""
    return get_executor(backend, default=default)(dep, x, **opts)


def cache_stats() -> dict:
    """Hit/miss/build counters of the process-wide plan cache."""
    return PLAN_CACHE.stats()


def reset_cache() -> None:
    """Drop all cached plans and entries and zero the counters."""
    PLAN_CACHE.clear()
