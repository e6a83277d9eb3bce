"""tokens_per_s: tokens the clients received inside the window, over the
window's length (host clock)."""


def read(rec):
    n = sum(1 for s in rec.streams.values() for t in s.times
            if rec.t_open < t <= rec.t_close)
    return n / rec.window_s
