"""pad_share.knot: rows the executor added to reach its power-of-two
buckets, as a share of all rows it ran, over the traced slice
(``runtime.rows{kind=pad}`` over real + pad)."""

from benchlib import program


def read(rec):
    c = program.counters(rec)
    if c is None or "runtime.rows{kind=pad}" not in c:
        return None
    pad = c["runtime.rows{kind=pad}"]
    return program.share(pad, pad + c.get("runtime.rows{kind=real}", 0))
