"""mfu.lm: the model FLOPs of every prefill and decode step in the traced
slice, each precision class at its peak (bfloat16 989, float32 67
TFLOP/s), over the slice's length."""

from benchlib import work


def read(rec):
    t = rec.device_trace
    if t is None:
        return None
    pre, dec = work.traced_lm_calls(rec)
    return work.mfu_percent([work.model_work(p) for p in pre + dec],
                            t.window_s)
