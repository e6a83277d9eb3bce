"""Faults planted under the timed path, by name: each must make a run of
its cell come out not correct.  ``plant(name)`` gives the ``plant(sut)``
hook of ``harness.run_cell`` and an ``undo()`` that takes the fault out
again.  The CPU tests (``bench/tests/test_bench_control.py``) and
``bench/calibrate.py --fault`` (the readings at a cell's own size on the
card) plant the same faults."""

from __future__ import annotations


def alter_answer(y):
    """The first output of each answer moved by 0.01."""
    y[0, 0] += 0.01
    return y


def drop_half(y):
    """The second half of each answer's rows left at zero."""
    y[y.shape[0] // 2:] = 0.0
    return y


def other_token(logits, step):
    """Every fourth decode step hands each slot its second-best token."""
    if step % 4 == 3:
        top = logits.argmax(-1, keepdim=True)
        logits.scatter_(-1, top, float("-inf"))
    return logits


def half_the_slots(logits, step):
    """The second half of the slots gets the first half's logits."""
    h = logits.shape[0] // 2
    logits[h:2 * h] = logits[:h].clone()
    return logits


def _wrap_execute(fault):
    def plant(sut):
        execute = sut.execute
        sut.execute = lambda x: fault(execute(x))
    return plant, lambda: None


def _wrap_decode(fault):
    def plant(sut):
        eng = sut.engine
        decode = eng.decode_active
        eng.decode_active = lambda tokens: fault(decode(tokens),
                                                 eng.decode_calls)
    return plant, lambda: None


def _state_unchanged():
    """Each decode step leaves the KV cache as it found it."""
    from repro_torch.models import layers

    saved = layers._put_rows

    def plant(sut):
        layers._put_rows = lambda *a, **k: None

    def undo():
        layers._put_rows = saved
    return plant, undo


FAULTS = {
    "alter_answer": lambda: _wrap_execute(alter_answer),
    "drop_half": lambda: _wrap_execute(drop_half),
    "other_token": lambda: _wrap_decode(other_token),
    "half_the_slots": lambda: _wrap_decode(half_the_slots),
    "state_unchanged": _state_unchanged,
}


def plant(name: str):
    """``(plant(sut), undo())`` of the fault ``name``."""
    return FAULTS[name]()
