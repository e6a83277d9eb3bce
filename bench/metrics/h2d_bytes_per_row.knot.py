"""h2d_bytes_per_row.knot: bytes of host data the executor copied to the
device (``runtime.h2d_bytes``) over the rows it was given
(``runtime.rows{kind=real}``), both counted over the traced slice."""

from benchlib import program


def read(rec):
    c = program.counters(rec)
    if c is None or not c.get("runtime.rows{kind=real}"):
        return None
    return c.get("runtime.h2d_bytes", 0) / c["runtime.rows{kind=real}"]
