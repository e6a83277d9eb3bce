"""mla_roofline.decode: the absorbed MLA's share of its roofline in the
traced slice's decode steps: each active request's latent cache rows at
its real length (r + dr values a position) read once, plus its latent
query in and latent output out, per layer (``benchlib/work_mla_moe.py``),
over the device time of the kernels in the program's ``model.mla.attend``
ranges (decode only: prefill attends in the expanded form)."""

from benchlib import work, work_mla_moe


def read(rec):
    t = rec.device_trace
    if t is None or "model.mla.attend" not in t.host_ranges:
        return None
    m = work_mla_moe.MoEDims.of(rec.cfg)
    _, dec = work_mla_moe.traced_calls(rec)
    works = [work_mla_moe.mla_decode(m, keys) for keys in dec
             for _ in range(m.layers)]
    dev = sum(e - s for s, e, _, _ in t.inside("model.mla.attend"))
    return work.roofline_percent(works, dev)
