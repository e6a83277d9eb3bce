"""Speculative decoding held against plain decode on the card.

The one definition of the check, shared by ``chip_smoke.py`` (phase 6) and
``tests/test_torch_gpu.py``.  The reference's invariant is bit identity:
``verify_step`` row j equals the logits of j sequential ``decode_step``
calls, so greedy spec streams equal ``spec_decode=0`` streams.  On the CPU
the port keeps it (``tests/test_torch_spec.py``).  On the card the bf16
matmuls run over slots x (k+1) rows in a verify pass and over slots rows
in a decode step, and cuBLAS does not promise a row the same bits at two
row counts, so the check is in two steps:

  1. :func:`verify_decode_delta` measures the largest |logit difference|
     between the two on the served model at the served shapes;
  2. :func:`spec_divergences` lets a spec stream part from the plain one
     only at a step where the plain run's top-2 logit margin
     (:func:`record_step_margins`) is at most twice that difference: two
     logits that each move by at most d change their difference by at
     most 2d, so only such a step can change the argmax.  Each such step
     is returned, to be counted; with a difference of 0 no step is
     excused and the streams must be equal.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import Request

__all__ = ["verify_decode_delta", "record_step_margins", "spec_divergences"]


def _clone_cache(cache):
    return [{key: {n: t.clone() for n, t in kv.items()}
             for key, kv in g.items()} for g in cache]


def verify_decode_delta(eng, prompts: list, k: int) -> dict:
    """Prefill ``prompts`` (one per slot) into a paged engine, then score
    the same k+1 tokens per slot twice from the same cache: k+1 sequential
    ``decode_active`` steps (greedy chain) and one ``verify_active`` pass.
    Returns ``{"max_abs_delta", "rows", "rows_bit_equal"}`` over the
    (slots x (k+1)) logits rows; the slots are released afterwards."""
    if not eng.paged:
        raise ValueError("verify_decode_delta needs a paged engine")
    slots = list(range(min(eng.slots, len(prompts))))
    tokens = np.zeros((eng.slots, k + 1), np.int64)
    for i in slots:
        logits = eng._prefill_slot(i, Request(rid=-1 - i, prompt=prompts[i]))
        tokens[i, 0] = int(np.argmax(logits))
    eng._ensure_decode_blocks(k + 1)     # the same blocks for both passes
    cache, pos = _clone_cache(eng.cache), eng.pos.copy()
    seq = []
    for j in range(k + 1):
        logits = eng.decode_active(tokens[:, j])
        seq.append(logits)
        if j < k:
            tokens[:, j + 1] = logits.argmax(dim=-1).cpu().numpy()
        eng.pos += 1
    eng.cache, eng.pos = cache, pos
    ver = eng.verify_active(tokens)
    delta, equal = 0.0, 0
    for j, row in enumerate(seq):
        d = (ver[slots, j] - row[slots]).abs().amax(dim=-1)
        delta = max(delta, float(d.max()))
        equal += int((d == 0).sum())
    for i in slots:
        eng.release_slot(i)
    return {"max_abs_delta": delta, "rows": len(slots) * (k + 1),
            "rows_bit_equal": equal}


def record_step_margins(eng) -> dict:
    """Wrap ``eng``'s prefill and decode calls so that each emitted
    token's logits row leaves its top-2 margin in the returned dict,
    ``{rid: [margin of token 0, token 1, ...]}`` (a plain-decode engine;
    one host copy of the margins per call)."""
    margins: dict = {}
    decode, prefill = eng.decode_active, eng._prefill_step

    def decode_active(tokens):
        logits = decode(tokens)
        top = torch.topk(logits.float(), 2, dim=-1).values
        m = (top[:, 0] - top[:, 1]).cpu().tolist()
        for i, r in enumerate(eng.active):
            if r is not None:
                margins.setdefault(r.rid, []).append(m[i])
        return logits

    def _prefill_step(slot):
        req = eng._prefilling[slot]["req"]
        logits = prefill(slot)
        if logits is not None:
            top = np.sort(np.asarray(logits, np.float64))[-2:]
            margins.setdefault(req.rid, []).append(float(top[1] - top[0]))
        return logits

    eng.decode_active, eng._prefill_step = decode_active, _prefill_step
    return margins


def spec_divergences(base: dict, spec: dict, margins: dict,
                     delta: float) -> list:
    """``[(rid, step, margin)]`` where a spec stream first parts from the
    plain one; raises AssertionError where it parts at a step whose plain
    margin exceeds ``2 * delta``, or where equal prefixes end at different
    lengths.  A stream that parted is not compared past that step."""
    out = []
    if set(base) != set(spec):
        raise AssertionError(f"requests differ: {set(base) ^ set(spec)}")
    for rid, want in base.items():
        got = spec[rid]
        step = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                    None)
        if step is None:
            if len(got) != len(want):
                raise AssertionError(f"request {rid}: lengths {len(got)} "
                                     f"!= {len(want)} with equal tokens")
            continue
        m = margins[rid][step]
        if m > 2 * delta:
            raise AssertionError(
                f"request {rid} parts from plain decode at step {step}, "
                f"where the plain top-2 margin {m:.4f} exceeds twice the "
                f"verify-vs-decode difference {delta:.4f}")
        out.append((rid, step, m))
    return out
