"""b2_roofline.decode: kernel B2's share of its roofline in the traced
slice's decode steps: each active request's K and V read once and its
QK^T and PV at 40 logical heads, per layer, over the ``flash_kernel*``
device time inside the ``serve.decode_step`` ranges."""

from benchlib import work
from benchlib.trace import is_b2


def read(rec):
    t = rec.device_trace
    if t is None:
        return None
    _, dec = work.traced_lm_calls(rec)
    dev = sum(e - s for s, e, n, _ in t.inside("serve.decode_step") if is_b2(n))
    return work.roofline_percent([w for p in dec for w in p["b2"]], dev)
