"""Batch-bucketed plan + executor cache (the runtime's memo layer).

Port of ``repro.runtime.plancache``.

  * **bucketing**: a logical batch ``b`` is rounded up to the next power of
    two (:func:`bucket_batch`; on a mesh, ``8 * data_size`` times one);
    inputs are zero-padded to the bucket and the
    output sliced back.  Rows are independent through the whole datapath,
    so padding is invisible to the real rows, and a ragged request stream
    builds O(log B) entries instead of one per batch size.
  * **LRU cache**: ``PlanKey -> (PipelinePlan, apply)``.  PyTorch runs
    eagerly, so an entry is the plan plus the backend's apply closure, and
    the reference's ``traces`` counter becomes ``builds``: entries built.
  * **counters**: hits / misses / builds / entries (:meth:`PlanCache.stats`),
    fed to the obs registry at snapshot time as ``plan_cache.hits`` /
    ``.misses`` / ``.traces`` / ``.entries``: the reference's series names,
    with ``builds`` exported as ``plan_cache.traces``.
  * **tuned tile plans**: ``repro_torch.tune.tiles`` registers measured
    ``(bb, bo, bf)`` winners per ``(dims, specs, residual_raw)`` geometry
    (:meth:`PlanCache.set_tile_overrides`); :meth:`PlanCache.plan` applies
    them when it builds a plan, so ``DeployedKAN.replan``, the executors
    and the serving path pick up the tuned plan (on the card: kernel B1's
    row tile, ``PipelinePlan.row_tile``) without a change of their own.
    Registering (or clearing) overrides drops the geometry's cached plans
    and entries, so no consumer keeps the stale plan.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

__all__ = ["bucket_batch", "PlanKey", "PlanCache", "PLAN_CACHE"]


def bucket_batch(b: int, lo: int = 8) -> int:
    """Round a logical batch up to ``lo`` times a power of two.  Meshed
    calls pass ``lo = 8 * data_size``, so every data shard's slab is at
    least one 8-row tile and the bucket divides by any data size."""
    if b < 1:
        raise ValueError(f"batch must be >= 1, got {b}")
    p = lo
    while p < b:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Hashable identity of one executor variant."""

    dims: tuple
    specs: tuple            # per-layer ASPQuantSpec (frozen dataclasses)
    bucket: int             # padded batch, a power of two >= 8
    residual_raw: bool
    device: str             # "cuda:0", "cpu", ...: where the entry runs
    backend: str
    flags: tuple = ()       # backend statics (e.g. ("cim", CIMConfig(...)))
    mesh: tuple = ()        # meshexec.mesh_fingerprint, () when unsharded


class PlanCache:
    """LRU of PlanKey -> (PipelinePlan, apply) with counters."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._plans: collections.OrderedDict = collections.OrderedDict()
        self._tile_overrides: dict = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.builds = 0

    def get(self, key: PlanKey, builder):
        """Return the cached (plan, apply) for ``key``; build on a miss.

        ``builder(key)`` returns the ``(plan, apply)`` pair.
        """
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry
            self.misses += 1
            entry = builder(key)
            self.builds += 1
            self._entries[key] = entry
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
            return entry

    def plan(self, batch: int, dims: tuple, specs: tuple, *,
             residual_raw: bool = False):
        """Memoized ``make_pipeline_plan``: a re-plan is a dict lookup.

        Applies the tuned tile overrides registered for this geometry, if
        any."""
        from ..kernels.kan_spline.pipeline import make_pipeline_plan

        key = (batch, tuple(dims), tuple(specs), residual_raw)
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                overrides = self._tile_overrides.get(
                    (tuple(dims), tuple(specs), residual_raw))
                plan = make_pipeline_plan(batch, tuple(dims), tuple(specs),
                                          residual_raw=residual_raw,
                                          tile_overrides=overrides)
                self._plans[key] = plan
                while len(self._plans) > 4 * self.maxsize:
                    self._plans.popitem(last=False)
            else:
                self._plans.move_to_end(key)
            return plan

    # -- tuned tile-plan registry (repro_torch.tune.tiles) ----------------

    def set_tile_overrides(self, dims: tuple, specs: tuple,
                           residual_raw: bool, overrides) -> None:
        """Register (or with ``overrides=None`` clear) a tuned tile plan.

        ``overrides`` is a per-layer ``((bb, bo, bf), ...)`` tuple (or one
        broadcast triple; see ``make_pipeline_plan``).  Cached plans and
        entries of the geometry are dropped, so the next resolution builds
        on the tuned tiles; clearing a geometry with nothing registered
        drops nothing.
        """
        from ..kernels.kan_spline.pipeline import normalize_tile_overrides

        gkey = (tuple(dims), tuple(specs), bool(residual_raw))
        with self._lock:
            if overrides is None:
                if gkey not in self._tile_overrides:
                    return  # nothing registered: clearing must not invalidate
                del self._tile_overrides[gkey]
            else:
                self._tile_overrides[gkey] = normalize_tile_overrides(
                    overrides, len(dims) - 1)
            for k in [k for k in self._plans if (k[1], k[2], k[3]) == gkey]:
                del self._plans[k]
            for k in [k for k in self._entries
                      if (k.dims, k.specs, k.residual_raw) == gkey]:
                del self._entries[k]

    def get_tile_overrides(self, dims: tuple, specs: tuple,
                           residual_raw: bool):
        """The registered tuned tile plan for a geometry, or None."""
        with self._lock:
            return self._tile_overrides.get(
                (tuple(dims), tuple(specs), bool(residual_raw)))

    def tile_overrides(self) -> dict:
        """Snapshot of every registered tuned tile plan (for reporting)."""
        with self._lock:
            return dict(self._tile_overrides)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "builds": self.builds,
                "entries": len(self._entries),
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._plans.clear()
            self._tile_overrides.clear()
            self.hits = self.misses = self.builds = 0


# The process-wide cache every executor resolves through.
PLAN_CACHE = PlanCache()


def _obs_collect() -> dict:
    """The cache counters under the reference's documented dotted names,
    pulled at snapshot time (the cache's hot path pays nothing).  The
    reference counts jit traces where the port counts builds; both are
    entries made on a miss, so ``builds`` is exported as
    ``plan_cache.traces`` and the series names equal the reference's."""
    st = PLAN_CACHE.stats()
    return {"plan_cache.hits": st["hits"], "plan_cache.misses": st["misses"],
            "plan_cache.traces": st["builds"],
            "plan_cache.entries": st["entries"]}


from ..obs import REGISTRY as _OBS_REGISTRY  # noqa: E402

_OBS_REGISTRY.register_collector(_obs_collect)
