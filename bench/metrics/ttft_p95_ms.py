"""ttft_p95_ms: 95th percentile, over every request sent in the window, of
the time from the client's send to its first token (host clock)."""

from benchlib.stats import percentile


def read(rec):
    xs = [1e3 * (s.times[0] - s.t_send) for s in rec.streams.values()
          if rec.first_rid <= s.rid < rec.end_rid and s.times]
    return percentile(xs, 95)
