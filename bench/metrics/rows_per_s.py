"""rows_per_s: rows whose outputs reached the host inside the window, over
the window's length (host clock)."""


def read(rec):
    return rec.rows_done / rec.window_s
