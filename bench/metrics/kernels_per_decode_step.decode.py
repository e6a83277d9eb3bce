"""kernels_per_decode_step.decode: device kernels that ran inside the
``serve.decode_step`` ranges of the traced slice, per decode step."""


def read(rec):
    t = rec.device_trace
    if t is None or not rec.traced_decode_calls:
        return None
    n = sum(1 for op in t.inside("serve.decode_step") if op[3] == "kernel")
    return n / rec.traced_decode_calls
