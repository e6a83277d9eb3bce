"""b1_roofline.decode: kernel B1's share of its roofline in the traced
slice's decode steps: the logical bound of both KAN-FFN halves of every
layer at the step's active requests, over B1's device time inside the
``serve.decode_step`` ranges."""

from benchlib import work
from benchlib.trace import is_b1


def read(rec):
    t = rec.device_trace
    if t is None:
        return None
    _, dec = work.traced_lm_calls(rec)
    dev = sum(e - s for s, e, n, _ in t.inside("serve.decode_step") if is_b1(n))
    return work.roofline_percent([w for p in dec for w in p["b1"]], dev)
