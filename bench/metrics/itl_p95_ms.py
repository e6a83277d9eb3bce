"""itl_p95_ms: 95th percentile of every gap between consecutive tokens of
a stream whose later token came inside the window (host clock)."""

from benchlib.stats import percentile


def read(rec):
    xs = [1e3 * (b - a) for s in rec.streams.values()
          for a, b in zip(s.times, s.times[1:])
          if rec.t_open < b <= rec.t_close]
    return percentile(xs, 95)
