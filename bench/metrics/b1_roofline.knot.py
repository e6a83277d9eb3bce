"""b1_roofline.knot: kernel B1's share of its roofline in the traced
slice: the logical bound of every layer of every request dispatched there
(benchlib.work.kan_network) over B1's device time."""

from benchlib import work
from benchlib.trace import is_b1


def read(rec):
    if rec.device_trace is None:
        return None
    calls = [w for n in rec.traced_rows for w in work.kan_network(n, rec.cfg)]
    return work.roofline_percent(calls, rec.trace.op_s(is_b1))
