"""h2d_host_ms_per_mrow.knot: host time inside the program's
``runtime.h2d`` ranges (the executor's copy of host rows to the device)
in the traced slice, in ms per million rows dispatched there."""


def read(rec):
    t = rec.trace
    if t is None or "runtime.h2d" not in t.host_ranges:
        return None
    rows = sum(rec.traced_rows)
    return 1e3 * t.host_s("runtime.h2d") / (rows / 1e6) if rows else None
