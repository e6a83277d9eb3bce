"""Streaming serve scheduler: event-driven continuous batching.

Port of ``repro.serve.scheduler``.  :class:`ServeEngine` owns the slot
pool and the KV cache; this module owns *when* its steps run:

  * **admission / backpressure**: a bounded queue (``max_queue``; a full
    queue rejects with :class:`QueueFull`) of requests with arrival times
    (``Request.arrival_s``, an offset from scheduler start) and optional
    queueing deadlines (``Request.deadline_s``);
  * **prefill / decode rounds**: each round expires overdue requests,
    admits arrived ones into free slots (whole prompts, or with
    ``engine.prefill_chunk`` one chunk per round), then advances ALL
    active slots with one decode step (FIFO, as the reference);
  * **streaming**: ``on_token(request, token)`` / ``on_done(request)``
    callbacks as tokens are produced;
  * **sampling**: per-request :class:`SamplingParams`, greedy by default;
  * **metrics**: TTFT, inter-token latencies, tokens/s and queue depth in
    :meth:`Scheduler.stats`.

The reference's observability hooks (tracer, metrics registry, periodic
stats line) wait for the obs slice (ROADMAP A6), and so does speculative
decoding (``serve/spec.py``).  Time comes from an injectable clock;
:class:`ManualClock` makes arrivals and deadlines deterministic.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

__all__ = [
    "ManualClock",
    "QueueFull",
    "SamplingParams",
    "Scheduler",
    "sample_token",
]


class QueueFull(RuntimeError):
    """Raised by :meth:`Scheduler.submit` when the bounded queue is full."""


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode sampling policy (``Request.sampling``).

    ``temperature <= 0`` is greedy argmax.  Otherwise the logits are divided
    by the temperature, restricted to the ``top_k`` highest (0 = no limit)
    and to the smallest nucleus of mass ``top_p``, and the token is drawn
    from the renormalized remainder, keyed by ``(seed, rid, position)``.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0 (0 = greedy)")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 = unrestricted)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


class ManualClock:
    """Deterministic clock for tests/simulation: time moves only on demand."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("time only moves forward")
        self._t += float(dt)


def _draw_seed(seed: int, rid: int, position: int) -> int:
    """A 63-bit generator seed mixed from (seed, rid, position)."""
    state = np.random.SeedSequence([seed, rid, position]).generate_state(2)
    return (int(state[0]) << 31 ^ int(state[1])) & (2**63 - 1)


def sample_token(logits: np.ndarray, params: SamplingParams, rid: int,
                 position: int) -> int:
    """Draw one token id from a logits row under ``params``.

    A pure function of (logits, params, rid, position): the draw uses a CPU
    ``torch.Generator`` seeded from ``(seed, rid, position)``, so each
    request has its own reproducible stream whatever the scheduling order.
    It is reproducible within the port but does not equal the reference's
    ``jax.random`` draws (different generators); the filtering (temperature,
    top-k, top-p) is the reference's, in float64.
    """
    if params.greedy:
        return int(np.argmax(logits))
    row = np.asarray(logits, np.float64) / max(params.temperature, 1e-6)
    if 0 < params.top_k < row.size:
        kth = np.partition(row, -params.top_k)[-params.top_k]
        row = np.where(row < kth, -np.inf, row)
    if params.top_p < 1.0:
        order = np.argsort(-row, kind="stable")
        probs = np.exp(row[order] - row[order[0]])
        probs /= probs.sum()
        cum = np.cumsum(probs)
        # smallest prefix with mass >= top_p; the head token always stays
        cut = int(np.searchsorted(cum, params.top_p)) + 1
        row[order[cut:]] = -np.inf
    probs = torch.softmax(torch.from_numpy(row), dim=0)
    gen = torch.Generator().manual_seed(_draw_seed(params.seed, rid, position))
    return int(torch.multinomial(probs, 1, generator=gen).item())


def _pct(xs: list, q: float) -> float | None:
    """Nearest-rank percentile of a small sample (None when empty)."""
    if not xs:
        return None
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, round(q * (len(s) - 1))))]


def _summary(xs: list) -> dict:
    return {
        "n": len(xs),
        "mean": (sum(xs) / len(xs)) if xs else None,
        "p50": _pct(xs, 0.50),
        "p95": _pct(xs, 0.95),
    }


class Scheduler:
    """Event-driven continuous batching over one :class:`ServeEngine`.

    ``log``: a callable that receives one line per scheduler event, or
    None for silence.  ``trace`` / ``tracer`` / ``stats_interval_s`` are
    the reference's observability hooks and raise until the obs slice
    ports them (ROADMAP A6).
    """

    def __init__(self, engine, max_queue: int | None = None, clock=None,
                 log: Callable | None = None, trace: bool = False,
                 tracer=None, stats_interval_s: float | None = None):
        if trace or tracer is not None or stats_interval_s is not None:
            raise NotImplementedError(
                "scheduler tracing / stats lines are not ported yet "
                "(ROADMAP A6: obs)")
        self.engine = engine
        self.max_queue = max_queue
        self._clock = clock
        self._now = clock.now if clock is not None else time.perf_counter
        self._t0 = self._now()
        self._log = log
        self.queue: list = []                  # submitted, not yet admitted
        self.finished: list = []               # completion order (+ expired)
        self._on_token: dict[int, Callable] = {}
        self._on_done: dict[int, Callable] = {}
        self._rec: dict[int, dict] = {}        # ACTIVE rid -> timing record
        self.submitted = 0
        self.completed = 0
        self.expired = 0
        self.rejected = 0
        self.decode_steps = 0
        # bounded metric state: per-request records live only while active
        self._ttfts: collections.deque = collections.deque(maxlen=4096)
        self._itls: collections.deque = collections.deque(maxlen=4096)
        self._tokens_done = 0                  # tokens of finished requests
        self._round_tokens = 0
        self._round_slots = 0
        self._span_start: float | None = None  # first admission
        self._span_end: float | None = None    # last emitted token
        self._depth_samples: collections.deque = collections.deque(
            maxlen=4096)                       # (elapsed_s, depth) trace tail
        self._depth_rounds = 0
        self._depth_sum = 0
        self._depth_max = 0

    def _say(self, msg: str, **fields) -> None:
        if self._log is not None:
            extra = " ".join(f"{k}={v}" for k, v in fields.items())
            self._log(f"{msg} {extra}".strip())

    # -- time -------------------------------------------------------------

    def elapsed(self) -> float:
        """Seconds since scheduler construction (the arrival_s timebase)."""
        return self._now() - self._t0

    def _wait(self, dt: float) -> None:
        if dt <= 0:
            return
        if self._clock is not None and hasattr(self._clock, "advance"):
            self._clock.advance(dt)
        else:
            time.sleep(dt)

    # -- submission -------------------------------------------------------

    def submit(self, req, on_token: Callable | None = None,
               on_done: Callable | None = None):
        """Enqueue a request; raises :class:`QueueFull` on backpressure.
        An ``arrival_s`` in the past is bumped to now; a future one keeps
        the request invisible to admission until then."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.rejected += 1
            raise QueueFull(
                f"queue full ({len(self.queue)}/{self.max_queue}); "
                f"request {req.rid} rejected"
            )
        req.arrival_s = max(float(req.arrival_s), self.elapsed())
        req.status = "queued"
        self.queue.append(req)
        self.submitted += 1
        self._on_token[req.rid] = on_token
        self._on_done[req.rid] = on_done
        return req

    # -- one scheduling round --------------------------------------------

    def step(self) -> bool:
        """Expire, admit, advance staged prefills, then one decode step.
        Returns True if a prefill or a decode ran."""
        now = self.elapsed()
        self._expire(now)
        progressed = self._admit_arrived(now)
        progressed = self._advance_prefills() or progressed
        depth = len(self.queue)
        self._depth_samples.append((now, depth))
        self._depth_rounds += 1
        self._depth_sum += depth
        self._depth_max = max(self._depth_max, depth)
        if any(r is not None for r in self.engine.active):
            self._decode_round()
            progressed = True
        return progressed

    def run_until_idle(self) -> list:
        """Drive :meth:`step` until queue and pool drain; returns finished.
        When only future arrivals remain, waits for the next one."""
        eng = self.engine
        while (self.queue or any(r is not None for r in eng.active)
               or eng.prefilling_slots()):
            if not self.step() and self.queue:
                nxt = min(r.arrival_s for r in self.queue)
                self._wait(nxt - self.elapsed())
        return self.finished

    # -- internals --------------------------------------------------------

    def _expire(self, now: float) -> None:
        keep = []
        for r in self.queue:
            if (r.deadline_s is not None
                    and now - r.arrival_s > r.deadline_s):
                r.done = True
                r.status = "expired"
                self.expired += 1
                self.finished.append(r)
                self._finish_cb(r)
                self._retire(r.rid)
                self._say("request expired", rid=r.rid,
                          queued_s=round(now - r.arrival_s, 3))
            else:
                keep.append(r)
        self.queue = keep

    def _admit_arrived(self, now: float) -> bool:
        eng = self.engine
        admitted = False
        while True:
            slot = eng._free_slot()
            if slot is None:
                break
            idx = next(
                (i for i, r in enumerate(self.queue) if r.arrival_s <= now),
                None,
            )
            if idx is None:
                break
            req = self.queue.pop(idx)
            if eng.prefill_chunk is not None:
                # chunked prefill: claim the slot now, one chunk per round
                eng._begin_prefill(slot, req)
                req.status = "running"
                admitted = True
                self._say("admitted request", rid=req.rid, prefill="chunked",
                          queued=len(self.queue))
                continue
            logits = eng._prefill_slot(slot, req)
            self._first_token(req, logits)
            admitted = True
            self._say("admitted request", rid=req.rid, queued=len(self.queue))
        return admitted

    def _advance_prefills(self) -> bool:
        """One chunk for every mid-prefill slot; emits the first token of
        any prompt that completes this round."""
        eng = self.engine
        progressed = False
        for slot in eng.prefilling_slots():
            req = eng._prefilling[slot]["req"]
            logits = eng._prefill_step(slot)
            progressed = True
            if logits is not None:
                self._first_token(req, logits)
                self._say("prefill complete", rid=req.rid)
        return progressed

    def _first_token(self, req, logits) -> None:
        """Select and record a freshly prefilled request's first token."""
        t = self.elapsed()
        tok = self._select(req, logits)
        req.output.append(tok)
        req.status = "running"
        req.ttft_s = t - req.arrival_s
        self._ttfts.append(req.ttft_s)
        self._rec[req.rid] = {
            "arrival": req.arrival_s, "admit": t, "token_times": [t],
        }
        if self._span_start is None or t < self._span_start:
            self._span_start = t
        self._span_end = t
        self._emit(req, tok)

    def _decode_round(self) -> None:
        eng = self.engine
        tokens = np.zeros(eng.slots, np.int32)
        for i, r in enumerate(eng.active):
            if r is not None:
                tokens[i] = r.output[-1]
        logits = eng.decode_active(tokens)
        self.decode_steps += 1
        # pure-greedy pools take the device-side argmax (B ints to the
        # host, not the (slots, vocab) logits)
        if any(getattr(r, "sampling", None) is not None
               for r in eng.active if r is not None):
            rows, nxt = logits.cpu().numpy(), None
        else:
            rows, nxt = None, logits.argmax(dim=-1).cpu().numpy()
        t = self.elapsed()
        self._span_end = t
        for i, r in enumerate(eng.active):
            if r is None:
                continue
            eng.pos[i] += 1
            tok = int(nxt[i]) if rows is None else self._select(r, rows[i])
            # a slot admitted behind the scheduler's back (direct
            # ServeEngine._admit) is adopted on its first decode
            rec = self._rec.setdefault(
                r.rid, {"arrival": r.arrival_s, "admit": t, "token_times": []}
            )
            self._round_tokens += 1
            self._round_slots += 1
            self._emit_tokens(r, rec, [tok], t)
            if (tok == r.eos_id or len(r.output) >= r.max_new_tokens
                    or eng.pos[i] >= eng.max_len - 1):
                self._finish_request(r, i, t, rec)

    def _finish_request(self, r, slot: int, t: float, rec: dict) -> None:
        r.done = True
        r.status = "done"
        r.latency_s = t - rec["admit"]
        self.completed += 1
        self.finished.append(r)
        self.engine.release_slot(slot)
        self._finish_cb(r)
        self._retire(r.rid)
        self._say("request done", rid=r.rid, tokens=len(r.output),
                  latency_s=round(r.latency_s, 3))

    def _emit_tokens(self, r, rec: dict, toks: list, t: float) -> None:
        """Record and stream tokens emitted together at instant ``t``."""
        times = rec["token_times"]
        n = len(toks)
        last = times[-1] if times else t
        for j, tok in enumerate(toks, start=1):
            tj = t if j == n else last + (t - last) * (j / n)
            r.output.append(tok)
            times.append(tj)
            self._emit(r, tok)

    def _retire(self, rid: int) -> None:
        """Fold a finished request's record into the capped aggregates."""
        rec = self._rec.pop(rid, None)
        if rec is not None:
            times = rec["token_times"]
            self._tokens_done += len(times)
            self._itls.extend(b - a for a, b in zip(times, times[1:]))
        self._on_token.pop(rid, None)
        self._on_done.pop(rid, None)

    def _select(self, req, logits_row: np.ndarray) -> int:
        sp = getattr(req, "sampling", None)
        if sp is None:
            return int(np.argmax(logits_row))
        return sample_token(logits_row, sp, req.rid, len(req.output))

    def _emit(self, req, tok: int) -> None:
        cb = self._on_token.get(req.rid)
        if cb is not None:
            cb(req, tok)

    def _finish_cb(self, req) -> None:
        cb = self._on_done.get(req.rid)
        if cb is not None:
            cb(req)

    # -- observability ----------------------------------------------------

    def queue_depth_trace(self) -> list:
        """(elapsed_s, queue_depth) samples, one per scheduling round."""
        return list(self._depth_samples)

    def drain_finished(self) -> list:
        """Return and clear the finished list."""
        out, self.finished = self.finished, []
        return out

    def stats(self) -> dict:
        """Aggregate metrics snapshot (the reference's keys; ``spec`` is
        None until speculative decoding is ported).  TTFT counts from
        arrival; ITLs are per emitted token; ``tokens_per_s`` spans first
        admission to the last emitted token."""
        active_recs = list(self._rec.values())
        itls = list(self._itls) + [
            b - a for rec in active_recs
            for a, b in zip(rec["token_times"], rec["token_times"][1:])
        ]
        tokens = self._tokens_done + sum(
            len(rec["token_times"]) for rec in active_recs
        )
        span = 0.0
        if self._span_start is not None and self._span_end is not None:
            span = self._span_end - self._span_start
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "expired": self.expired,
            "rejected": self.rejected,
            "queued": len(self.queue),
            "active": sum(r is not None for r in self.engine.active),
            "prefilling": len(self.engine.prefilling_slots()),
            "decode_steps": self.decode_steps,
            "kv": self.engine.kv_stats(),
            "tokens": tokens,
            "tokens_per_s": (tokens / span) if span > 0 else None,
            "tokens_per_round": (self._round_tokens / self._round_slots
                                 if self._round_slots else None),
            "ttft_s": _summary(list(self._ttfts)) if self._ttfts else None,
            "itl_s": _summary(itls),
            "spec": None,
            "queue_depth": {
                "samples": len(self._depth_samples),
                "rounds": self._depth_rounds,
                "max": self._depth_max,
                "mean": (self._depth_sum / self._depth_rounds
                         if self._depth_rounds else 0.0),
            },
            "elapsed_s": self.elapsed(),
        }
