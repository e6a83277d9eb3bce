"""queue_share.ttft: of the requests sent in the window whose time to
first token (``Request.ttft_s``, the scheduler's clock) is at or above its
95th percentile, the summed wait from arrival to admission
(``Request.queue_s``) over their summed time to first token, in %."""

from benchlib.stats import percentile


def read(rec):
    reqs = [s.req for s in rec.streams.values()
            if rec.first_rid <= s.rid < rec.end_rid and s.times]
    if not reqs or not hasattr(reqs[0], "queue_s"):
        return None
    cut = percentile([r.ttft_s for r in reqs], 95)
    tail = [r for r in reqs if r.ttft_s >= cut]
    ttft = sum(r.ttft_s for r in tail)
    return 100.0 * sum(r.queue_s for r in tail) / ttft if ttft > 0 else None
