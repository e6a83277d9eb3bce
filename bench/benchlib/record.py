"""What one run leaves for the metric readers and the check."""

from __future__ import annotations

import time


class RunRecord:
    """Filled by a traffic generator; read by ``bench/metrics/*.py``.

    ``t_start`` is the process start (host clock), ``t_open`` / ``t_close``
    the measured window.  ``trace`` is the reduced profile of the traced
    slice of the window (``--trace 1``), else None.  ``answers`` is what the
    check compares.  Generators add what their readers need:
    ``rows_done`` and ``traced_rows`` (rows), ``streams``, ``first_rid`` /
    ``end_rid``, ``traced_steps`` and ``traced_decode_calls`` (LM)."""

    def __init__(self, ctx):
        self.cfg = ctx.cfg
        self.mix = ctx.mix
        self.seconds = ctx.seconds
        self.t_start = ctx.t_start
        self._ctx = ctx
        self.t_open = self.t_close = None
        self.attempted = 0
        self.failed = 0
        self.rows_done = 0
        self.trace = None
        self.peak_bytes = 0
        self.answers = []

    def open_window(self, now: float | None = None) -> None:
        self._ctx.reset_peak()
        self.t_open = time.perf_counter() if now is None else now

    def close_window(self, now: float | None = None) -> None:
        self.t_close = time.perf_counter() if now is None else now
        self.peak_bytes = self._ctx.read_peak()

    @property
    def device_trace(self):
        """The traced slice, where it holds device operations (a CPU
        rehearsal has none, and gives no device metric)."""
        return self.trace if self.trace is not None and self.trace.ops else None

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    @property
    def setup_s(self) -> float:
        return self.t_open - self.t_start
