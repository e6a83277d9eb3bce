"""mfu.moe: the model FLOPs of every prefill and decode step in the
traced slice (``benchlib/work_mla_moe.py``: the expanded MLA at prefill,
the absorbed form at decode, every KAN's MACs in float32, the routers in
float32), each precision class at its peak (bfloat16 989, float32 67
TFLOP/s), over the slice's length."""

from benchlib import work, work_mla_moe


def read(rec):
    t = rec.device_trace
    if t is None:
        return None
    return work.mfu_percent(work_mla_moe.model_works(rec), t.window_s)
