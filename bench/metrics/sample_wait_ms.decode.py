"""sample_wait_ms.decode: host time inside the scheduler's
``serve.sample`` ranges (the argmax or the logits' transfer to the host,
up to the host arrays) in the traced slice, in ms per decode step counted
there (decode_calls)."""


def read(rec):
    t = rec.trace
    if (t is None or not rec.traced_decode_calls
            or "serve.sample" not in t.host_ranges):
        return None
    return 1e3 * t.host_s("serve.sample") / rec.traced_decode_calls
