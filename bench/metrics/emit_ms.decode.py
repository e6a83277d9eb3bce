"""emit_ms.decode: host time inside the scheduler's ``serve.emit`` ranges
(the per-slot loop that emits tokens, runs the callbacks and finishes
requests) in the traced slice, in ms per decode step counted there
(decode_calls)."""


def read(rec):
    t = rec.trace
    if (t is None or not rec.traced_decode_calls
            or "serve.emit" not in t.host_ranges):
        return None
    return 1e3 * t.host_s("serve.emit") / rec.traced_decode_calls
