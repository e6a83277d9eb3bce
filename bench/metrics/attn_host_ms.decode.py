"""attn_host_ms.decode: host time inside the program's ``model.attention``
ranges that ran within a ``serve.decode_step`` range of the traced slice,
in ms per decode step counted there (decode_calls)."""

from benchlib import program


def read(rec):
    t = rec.trace
    if t is None or not rec.traced_decode_calls:
        return None
    s = program.host_s_within(t, "model.attention", "serve.decode_step")
    return None if s is None else 1e3 * s / rec.traced_decode_calls
