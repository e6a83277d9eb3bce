"""h2d_ms_per_mrow.knot: device time of host-to-device copies in the
traced slice, in ms per million rows dispatched there."""


def read(rec):
    rows = sum(rec.traced_rows)
    if rec.device_trace is None or not rows:
        return None
    ms = 1e3 * rec.trace.kind_s("memcpy", lambda n: "HtoD" in n)
    return ms / (rows / 1e6)
