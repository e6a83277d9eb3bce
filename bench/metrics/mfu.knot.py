"""mfu.knot: the model FLOPs of the requests dispatched in the traced slice
(float32, at 67 TFLOP/s) over the slice's length."""

from benchlib import work


def read(rec):
    if rec.device_trace is None or not rec.traced_rows:
        return None
    calls = [w for n in rec.traced_rows for w in work.kan_network(n, rec.cfg)]
    return work.mfu_percent(calls, rec.trace.window_s)
