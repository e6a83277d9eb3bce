"""b1_roofline.prefill: kernel B1's share of its roofline in the traced
slice's prefills: the logical bound of both KAN-FFN halves of every layer
at each prompt's real length, over B1's device time inside the
``serve.prefill`` ranges."""

from benchlib import work
from benchlib.trace import is_b1


def read(rec):
    t = rec.device_trace
    if t is None:
        return None
    pre, _ = work.traced_lm_calls(rec)
    dev = sum(e - s for s, e, n, _ in t.inside("serve.prefill") if is_b1(n))
    return work.roofline_percent([w for p in pre for w in p["b1"]], dev)
