"""moe_host_ms.decode: host time inside the program's routed-MoE ranges
(``model.moe.route``, ``model.moe.experts``, ``model.moe.shared``) that
ran within a ``serve.decode_step`` range of the traced slice, in ms per
decode step counted there (decode_calls)."""

from benchlib import program

RANGES = ("model.moe.route", "model.moe.experts", "model.moe.shared")


def read(rec):
    t = rec.trace
    if t is None or not rec.traced_decode_calls:
        return None
    parts = [program.host_s_within(t, r, "serve.decode_step") for r in RANGES]
    if all(p is None for p in parts):
        return None
    return 1e3 * sum(p or 0.0 for p in parts) / rec.traced_decode_calls
