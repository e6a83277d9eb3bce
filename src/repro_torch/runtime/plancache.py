"""Batch-bucketed plan + executor cache (the runtime's memo layer).

Port of ``repro.runtime.plancache``.

  * **bucketing**: a logical batch ``b`` is rounded up to the next power of
    two (:func:`bucket_batch`); inputs are zero-padded to the bucket and the
    output sliced back.  Rows are independent through the whole datapath,
    so padding is invisible to the real rows, and a ragged request stream
    builds O(log B) entries instead of one per batch size.
  * **LRU cache**: ``PlanKey -> (PipelinePlan, apply)``.  PyTorch runs
    eagerly, so an entry is the plan plus the backend's apply closure, and
    the reference's ``traces`` counter becomes ``builds``: entries built.
  * **counters**: hits / misses / builds / entries (:meth:`PlanCache.stats`).

The reference's tuned-tile registry waits for the tune slice.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

__all__ = ["bucket_batch", "PlanKey", "PlanCache", "PLAN_CACHE"]


def bucket_batch(b: int, lo: int = 8) -> int:
    """Round a logical batch up to the next power of two (>= ``lo``)."""
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


class PlanCache:
    """LRU of PlanKey -> (PipelinePlan, apply) with counters."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._plans: collections.OrderedDict = collections.OrderedDict()
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
        """Memoized ``make_pipeline_plan``: a re-plan is a dict lookup."""
        from ..kernels.kan_spline.pipeline import make_pipeline_plan

        key = (batch, tuple(dims), tuple(specs), residual_raw)
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                plan = make_pipeline_plan(batch, tuple(dims), tuple(specs),
                                          residual_raw=residual_raw)
                self._plans[key] = plan
                while len(self._plans) > 4 * self.maxsize:
                    self._plans.popitem(last=False)
            else:
                self._plans.move_to_end(key)
            return plan

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
            self.hits = self.misses = self.builds = 0


# The process-wide cache every executor resolves through.
PLAN_CACHE = PlanCache()
