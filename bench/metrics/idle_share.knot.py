"""idle_share.knot: share of the traced slice in which no kernel, copy or
memset ran on the device (1 - the union of their intervals over the
slice)."""


def read(rec):
    return None if rec.device_trace is None else rec.trace.idle_percent()
