"""pad_share.prefill: prompt tokens the engine added to reach its
power-of-two prefill buckets, as a share of all prompt tokens it
prefilled, over the traced slice (``serve.prompt_tokens{kind=pad}`` over
real + pad)."""

from benchlib import program


def read(rec):
    c = program.counters(rec)
    if c is None or "serve.prompt_tokens{kind=pad}" not in c:
        return None
    pad = c["serve.prompt_tokens{kind=pad}"]
    return program.share(pad,
                         pad + c.get("serve.prompt_tokens{kind=real}", 0))
