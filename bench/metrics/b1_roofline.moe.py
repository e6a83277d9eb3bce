"""b1_roofline.moe: the grouped expert B1's share of its roofline in the
traced slice: the logical bound of both halves of every MoE layer's
grouped call (every routed row at 2048 x 128 and 128 x 2048, each
expert's weights read once a call, float32 MACs; ``benchlib/
work_mla_moe.py``) of every prefill and decode step, over B1's device
time inside the program's ``model.moe.experts`` ranges."""

from benchlib import work, work_mla_moe
from benchlib.trace import is_b1


def read(rec):
    t = rec.device_trace
    if t is None or "model.moe.experts" not in t.host_ranges:
        return None
    m = work_mla_moe.MoEDims.of(rec.cfg)
    pre, dec = work_mla_moe.traced_calls(rec)
    works = [w for n in pre + [len(k) for k in dec]
             for w in work_mla_moe.moe_grouped(m, n)]
    dev = sum(e - s for s, e, n, _ in t.inside("model.moe.experts")
              if is_b1(n))
    return work.roofline_percent(works, dev)
