"""Backend-pluggable KAN runtime: executor registry + plan cache.

Port of ``repro.runtime``.  See :mod:`.executor` for the KAN ``ref`` /
``fused`` / ``acim`` backends and ``REPRO_KAN_BACKEND`` resolution, :mod:`.plancache`
for batch bucketing, :mod:`.meshexec` for mesh-sharded execution
(``mesh=`` / :func:`use_mesh`), and :mod:`.attention` for the attention registry
(``ref`` / ``flash``, ``REPRO_ATTN_BACKEND``).

    from repro_torch import runtime
    y = runtime.execute(dep, x)                  # resolved backend
    y = runtime.execute(dep, x, backend="ref")   # the layered oracle
    y = runtime.execute(dep, x, backend="acim",  # paper non-idealities
                        generator=torch.Generator(device=dep.device).manual_seed(0))
"""

from .attention import (
    ENV_ATTN_BACKEND_VAR,
    attn_dispatch_counts,
    available_attn_backends,
    default_attn_backend,
    register_attn_backend,
    reset_attn_dispatch_counts,
    resolve_attn_backend,
    use_attn_backend,
)
from .executor import (
    ACIMExecutor,
    ENV_BACKEND_VAR,
    FusedExecutor,
    RefExecutor,
    available_backends,
    dispatch_counts,
    get_executor,
    io_counts,
    quiet_cim_config,
    ref_composition,
    register_executor,
    reset_dispatch_counts,
    reset_io_counts,
    resolve_backend,
    use_backend,
)
from .meshexec import (
    mesh_axis_sizes,
    reset_shard_notes,
    resolve_mesh,
    shard_notes,
    use_mesh,
)
from .plancache import PLAN_CACHE, PlanCache, PlanKey, bucket_batch

__all__ = [
    "ACIMExecutor",
    "ENV_ATTN_BACKEND_VAR",
    "ENV_BACKEND_VAR",
    "attn_dispatch_counts",
    "FusedExecutor",
    "PLAN_CACHE",
    "PlanCache",
    "PlanKey",
    "RefExecutor",
    "available_attn_backends",
    "available_backends",
    "bucket_batch",
    "cache_stats",
    "default_attn_backend",
    "dispatch_counts",
    "execute",
    "get_executor",
    "io_counts",
    "mesh_axis_sizes",
    "quiet_cim_config",
    "ref_composition",
    "register_attn_backend",
    "reset_attn_dispatch_counts",
    "register_executor",
    "reset_cache",
    "reset_dispatch_counts",
    "reset_io_counts",
    "resolve_attn_backend",
    "resolve_backend",
    "resolve_mesh",
    "shard_notes",
    "use_attn_backend",
    "use_backend",
    "use_mesh",
]


def execute(dep, x, *, backend=None, default="fused", **opts):
    """Run a deployed KAN bundle through the resolved backend."""
    return get_executor(backend, default=default)(dep, x, **opts)


def cache_stats() -> dict:
    """Hit/miss/build counters of the process-wide plan cache."""
    return PLAN_CACHE.stats()


def reset_cache() -> None:
    """Drop all cached plans and entries, zero the counters and forget the
    recorded shard notes."""
    PLAN_CACHE.clear()
    reset_shard_notes()
