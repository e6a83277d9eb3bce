"""decode_step_ms.itl: the traced slice's wall outside ``serve.prefill``
ranges, over the decode steps the engine counted there (decode_calls)."""


def read(rec):
    t = rec.device_trace
    if t is None or not rec.traced_decode_calls:
        return None
    return 1e3 * (t.window_s - t.host_s("serve.prefill")) / rec.traced_decode_calls
