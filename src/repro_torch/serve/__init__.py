"""Serving layer: slot-based engine + streaming scheduler.

Port of ``repro.serve``: :mod:`.engine` owns the state (slot pool, KV
cache, contiguous or paged), :mod:`.scheduler` the event loop (arrivals,
admission / backpressure, deadlines, streaming callbacks, seeded sampling,
TTFT / throughput / accept-rate metrics, obs tracing), :mod:`.kvpool` the
paged block pool and :mod:`.spec` the speculative-decode drafter.
"""

from .engine import Request, ServeEngine, prefill_bucketing_supported
from .scheduler import (
    ManualClock,
    QueueFull,
    SamplingParams,
    Scheduler,
    sample_token,
)
from .spec import DraftModel, DraftSpec

__all__ = [
    "DraftModel",
    "DraftSpec",
    "ManualClock",
    "QueueFull",
    "Request",
    "SamplingParams",
    "Scheduler",
    "ServeEngine",
    "prefill_bucketing_supported",
    "sample_token",
]
