"""Serving layer: slot-based engine + streaming scheduler.

Port of ``repro.serve``: :mod:`.engine` owns the state (slot pool, KV
cache, contiguous or paged), :mod:`.scheduler` the event loop (arrivals,
admission / backpressure, deadlines, streaming callbacks, seeded sampling,
TTFT / throughput metrics), :mod:`.kvpool` the paged block pool.  The
speculative-decode drafter (``serve/spec.py``) is not ported yet
(ROADMAP A6).
"""

from .engine import Request, ServeEngine, prefill_bucketing_supported
from .scheduler import (
    ManualClock,
    QueueFull,
    SamplingParams,
    Scheduler,
    sample_token,
)

__all__ = [
    "ManualClock",
    "QueueFull",
    "Request",
    "SamplingParams",
    "Scheduler",
    "ServeEngine",
    "prefill_bucketing_supported",
    "sample_token",
]
