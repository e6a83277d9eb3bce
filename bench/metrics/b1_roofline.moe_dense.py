"""b1_roofline.moe_dense: kernel B1's share of its roofline in the
traced slice outside the routed experts: the logical bound of both halves
of the leading dense layers' KAN-FFNs and of every MoE layer's shared
experts (one KAN-FFN of ``shared_hidden``) at each prefill's tokens and
each decode step's active requests (``benchlib/work_mla_moe.py``), over
B1's device time inside the program's ``model.ffn`` ranges and outside
its ``model.moe.experts`` ranges (whose grouped calls
``b1_roofline.moe`` reads)."""

from benchlib import work, work_mla_moe
from benchlib.trace import is_b1


def read(rec):
    t = rec.device_trace
    if t is None or "model.moe.shared" not in t.host_ranges:
        return None
    m = work_mla_moe.MoEDims.of(rec.cfg)
    pre, dec = work_mla_moe.traced_calls(rec)
    works = [w for n in pre + [len(k) for k in dec]
             for w in work_mla_moe.ffn_ungrouped(m, n)]
    grouped = set(t.inside("model.moe.experts"))
    dev = sum(e - s for s, e, n, k in t.inside("model.ffn")
              if is_b1(n) and (s, e, n, k) not in grouped)
    return work.roofline_percent(works, dev)
