"""prefill_share.ttft: share of the traced slice's wall that the host
spent inside the program's ``serve.prefill`` ranges."""


def read(rec):
    t = rec.device_trace
    return None if t is None else 100.0 * t.host_s("serve.prefill") / t.window_s
