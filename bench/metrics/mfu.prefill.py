"""mfu.prefill: the model FLOPs of the traced slice's prefills, each
precision class at its peak, over the wall the host spent inside their
``serve.prefill`` ranges."""

from benchlib import work


def read(rec):
    t = rec.device_trace
    if t is None:
        return None
    pre, _ = work.traced_lm_calls(rec)
    return work.mfu_percent([work.model_work(p) for p in pre],
                            t.host_s("serve.prefill"))
