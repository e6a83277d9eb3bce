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
    active slots with one decode step (FIFO, as the reference), or, when
    the engine speculates (``engine.spec_k``), with one propose -> verify
    -> accept round (:meth:`Scheduler._spec_round`);
  * **streaming**: ``on_token(request, token)`` / ``on_done(request)``
    callbacks as tokens are produced;
  * **sampling**: per-request :class:`SamplingParams`, greedy by default;
  * **metrics**: TTFT, inter-token latencies, tokens/s, queue depth and the
    speculative accept rate in :meth:`Scheduler.stats`; with the obs
    registry enabled (``repro_torch.obs.enable()`` / ``REPRO_OBS=1``) the
    same events feed the ``serve.*`` / ``kv.*`` series of
    ``docs/observability.md``.  Recording only: token streams are the
    same with observability on or off;
  * **tracing**: ``Scheduler(trace=True)`` records one span tree per
    request (``request`` > ``queued`` / ``prefill`` / ``decode`` and a
    ``first_token`` event) through :class:`repro_torch.obs.Tracer` on the
    scheduler's own clock (:meth:`Scheduler.elapsed`), so a
    :class:`ManualClock` workload exports byte-identical JSONL run to run.
    Whatever the tracer, each admitted request carries ``queue_s``
    (arrival to admission) beside ``ttft_s`` (arrival to first token), and
    ``latency_s`` runs from admission to the last token.  With profiler
    annotations on, each round runs under the ``serve.round`` range, and a
    decode round's argmax or logits transfer under ``serve.sample`` and its
    per-slot token emission under ``serve.emit``;
  * **logging**: ``log=`` takes a bare callable (every line forwarded) or
    None for the structured ``repro_torch.obs`` logger, where per-request
    lines sit at debug level under ``REPRO_LOG_LEVEL``;
    ``stats_interval_s=`` adds a periodic one-line stats summary.

Time comes from an injectable clock; :class:`ManualClock` makes arrivals
and deadlines deterministic.  On a mesh of more than one rank with no
clock given, the decisions that hang on time read :class:`MeshClock`, rank
0's clock broadcast to every rank, so every rank expires and admits alike.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .. import obs
from ..dist import comm

__all__ = [
    "ManualClock",
    "MeshClock",
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


class MeshClock:
    """One clock for every rank of a mesh: rank 0's reading on each.

    :meth:`share` broadcasts rank 0's value of a float64 reading to every
    rank of ``mesh`` through ``dist.comm.broadcast``, over each axis group
    in turn from the last axis to the first, so the value of the rank at
    (0, 0) lands everywhere.  The tensor lives on the mesh's device (a CUDA
    tensor under NCCL, so a read is a host sync).  It is a collective:
    every rank must read at the same point, in the same order.  An axis of
    one rank is skipped, except on a mesh whose every axis has one rank
    (the scheduler makes no MeshClock there unless it is given one): its
    first axis's world-1 group then runs the broadcast.  ``reads`` counts
    the reads.
    """

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names)
        groups = [mesh.get_group(n) for n in reversed(names)]
        wide = [g for g in groups if comm.group_size(g) > 1]
        self._groups = wide or groups[-1:]
        self._one_rank = not wide
        if mesh.device_type == "cuda":
            self._device = torch.device("cuda", torch.cuda.current_device())
        else:
            self._device = torch.device(mesh.device_type)
        self.reads = 0

    def share(self, value: float) -> float:
        """Rank 0's ``value`` on every rank (a collective)."""
        t = torch.tensor([value], dtype=torch.float64, device=self._device)
        for g in self._groups:
            comm.broadcast(t, 0, g, one_rank=self._one_rank)
        self.reads += 1
        return float(t.item())

    def now(self) -> float:
        """Rank 0's ``time.perf_counter()`` on every rank (a collective)."""
        return self.share(time.perf_counter())


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


# KV-pool counters mirrored into gauges each scheduling round (paged
# engines only; the reference's names, docs/observability.md)
_KV_GAUGES = (
    "blocks_in_use", "blocks_in_use_peak", "blocks_cached", "blocks_free",
    "prefix_hits", "prefix_misses", "allocs", "evictions", "truncations",
)




class Scheduler:
    """Event-driven continuous batching over one :class:`ServeEngine`.

    The scheduler drives the engine's slot pool / cache through its
    internals (``_free_slot`` / ``_prefill_slot`` / ``decode_active`` /
    ``verify_active``); one scheduler per engine at a time.  ``log``: a
    bare callable (every line, debug included) or None for the
    structured ``obs`` logger; ``trace`` / ``tracer``: span recording on
    :meth:`elapsed`; ``stats_interval_s``: a periodic stats line.

    Time: :meth:`elapsed` reads ``clock`` (``time.perf_counter`` when None).
    On a mesh of more than one rank (``engine.shards.ranks``) with no
    ``clock``, and whenever ``clock`` is a :class:`MeshClock`, the reads a
    decision hangs on are rank 0's through :meth:`MeshClock.share`, one
    read each: :meth:`submit` of a request with a deadline or an
    ``arrival_s`` above 0, and :meth:`step` while the queue holds a request
    with a deadline or one whose arrival was still ahead at submission.
    Only those requests wait on time: any other queued request counts as
    arrived, and none expires.  Every other read (token and admission
    times, the tracer, stats, the length of the wait for an arrival) drives
    no decision and stays this rank's own, so latencies on a rank other
    than 0 may be off by the skew between the ranks' clocks.  With no mesh
    or a one-rank mesh nothing is broadcast.
    """

    def __init__(self, engine, max_queue: int | None = None, clock=None,
                 log: Callable | None = None, trace: bool = False,
                 tracer=None, stats_interval_s: float | None = None):
        self.engine = engine
        self.max_queue = max_queue
        shards = getattr(engine, "shards", None)
        if clock is None and getattr(shards, "ranks", 1) > 1:
            clock = MeshClock(shards.mesh)
        self._clock = clock
        self._share = clock.share if isinstance(clock, MeshClock) else None
        self._now = (clock.now if clock is not None and self._share is None
                     else time.perf_counter)
        self._t0 = self._now()
        self._ahead: set = set()               # queued rids not yet arrived
        # bare callables keep their legacy everything-forwarded behavior;
        # None routes through the structured process logger (info threshold,
        # REPRO_LOG_LEVEL) where per-request chatter sits at debug level
        self.log = obs.as_logger(log, "sched")
        self.stats_interval_s = stats_interval_s
        self._last_stats_line = 0.0
        # span recorder on the scheduler's own clock: ManualClock workloads
        # trace deterministically (byte-identical JSONL run to run)
        self.tracer = tracer
        if trace and self.tracer is None:
            self.tracer = obs.Tracer(clock=self.elapsed)
        self._spans: dict[int, dict] = {}      # ACTIVE rid -> span handles
        self._mx = self._bind_metrics() if obs.enabled() else None
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
        # bounded metric state: per-request records live only while the
        # request is active (<= slots of them); finished requests leave
        # behind scalars/capped samples, so a long-lived scheduler's
        # footprint does not grow with total requests served.  finished
        # itself is the caller's to drain (drain_finished()).
        self._ttfts: collections.deque = collections.deque(maxlen=4096)
        self._itls: collections.deque = collections.deque(maxlen=4096)
        self._tokens_done = 0                  # tokens of finished requests
        # decode-round shape: tokens emitted per (active slot, round) pair —
        # exactly 1.0 without speculative decoding, 1 + accepted/round with
        self._round_tokens = 0
        self._round_slots = 0
        # speculative-decode aggregates (engine.spec_k > 0 rounds only)
        self._spec_rounds = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._draft_s: collections.deque = collections.deque(maxlen=4096)
        self._verify_s: collections.deque = collections.deque(maxlen=4096)
        self._span_start: float | None = None  # first admission
        self._span_end: float | None = None    # last emitted token
        self._depth_samples: collections.deque = collections.deque(
            maxlen=4096)                       # (elapsed_s, depth) trace tail
        self._depth_rounds = 0
        self._depth_sum = 0
        self._depth_max = 0

    def _bind_metrics(self) -> dict:
        """Resolve the serve.* / kv.* instruments once at construction so
        the per-round record path is attribute access, not registry
        lookups.  Only called when obs is enabled; ``self._mx is None``
        otherwise and every obs block below is skipped outright."""
        R = obs.REGISTRY
        mx = {
            "submitted": R.counter("serve.submitted"),
            "completed": R.counter("serve.completed"),
            "expired": R.counter("serve.expired"),
            "rejected": R.counter("serve.rejected"),
            "tokens": R.counter("serve.tokens"),
            "decode_steps": R.counter("serve.decode_steps"),
            "queue_depth": R.gauge("serve.queue_depth"),
            "active": R.gauge("serve.active_slots"),
            "prefilling": R.gauge("serve.prefilling_slots"),
            "ttft": R.histogram("serve.ttft_s"),
            "itl": R.histogram("serve.itl_s"),
            "spec_drafted": R.counter("serve.spec.drafted"),
            "spec_accepted": R.counter("serve.spec.accepted"),
            "spec_draft_s": R.histogram("serve.spec.draft_s"),
            "spec_verify_s": R.histogram("serve.spec.verify_s"),
        }
        for k in _KV_GAUGES:
            mx[f"kv.{k}"] = R.gauge(f"kv.{k}")
        return mx

    # -- time -------------------------------------------------------------

    def elapsed(self) -> float:
        """Seconds since scheduler construction (the arrival_s timebase),
        on this rank's clock."""
        return self._now() - self._t0

    def _decision_now(self, timed: bool) -> float:
        """:meth:`elapsed` for a decision: rank 0's on a mesh clock when
        ``timed`` (a deadline or an arrival hangs on it)."""
        now = self.elapsed()
        if timed and self._share is not None:
            now = self._share(now)
        return now

    def _queue_timed(self) -> bool:
        return self._share is not None and any(
            r.deadline_s is not None or r.rid in self._ahead
            for r in self.queue)

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

        ``req.arrival_s`` earlier than now is bumped to the submission
        instant (you cannot arrive in the past); a future value keeps the
        request invisible to admission until that offset — the hook the
        sustained-load benchmark drives its deterministic arrival schedule
        through.
        """
        now = self._decision_now(req.deadline_s is not None
                                 or req.arrival_s > 0)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.rejected += 1
            if self._mx is not None:
                self._mx["rejected"].inc()
            raise QueueFull(
                f"queue full ({len(self.queue)}/{self.max_queue}); "
                f"request {req.rid} rejected"
            )
        if req.arrival_s > now:
            self._ahead.add(req.rid)
        req.arrival_s = max(float(req.arrival_s), now)
        req.status = "queued"
        self.queue.append(req)
        self.submitted += 1
        if self._mx is not None:
            self._mx["submitted"].inc()
        if self.tracer is not None:
            root = self.tracer.begin(
                "request", rid=req.rid, prompt_tokens=len(req.prompt),
                max_new_tokens=req.max_new_tokens,
            )
            self._spans[req.rid] = {
                "request": root,
                "queued": self.tracer.begin("queued", parent=root),
            }
        self._on_token[req.rid] = on_token
        self._on_done[req.rid] = on_done
        return req

    # -- one scheduling round --------------------------------------------

    def step(self) -> bool:
        """Expire, admit, advance staged prefills, then one decode step.

        With chunked prefill (``engine.prefill_chunk``) each round advances
        every mid-prefill slot by ONE chunk before the pooled decode, so a
        long prompt prefills interleaved with decode instead of stalling
        the whole pool; without it admission prefills whole prompts
        synchronously (the classic path — greedy streams bit-identical to
        the pre-scheduler loop).

        Returns True if any progress was made (a prefill or a decode ran);
        False means the scheduler is idle right now — either fully drained,
        or every queued request has a future arrival time.
        """
        with obs.profile_scope("serve.round"):
            now = self._decision_now(self._queue_timed())
            self._expire(now)
            progressed = self._admit_arrived(now)
            progressed = self._advance_prefills() or progressed
            depth = len(self.queue)
            self._depth_samples.append((now, depth))
            self._depth_rounds += 1
            self._depth_sum += depth
            self._depth_max = max(self._depth_max, depth)
            if self._mx is not None:
                self._sample_gauges(depth)
            if (self.stats_interval_s is not None
                    and now - self._last_stats_line >= self.stats_interval_s):
                self._last_stats_line = now
                self._stats_line(now)
            if any(r is not None for r in self.engine.active):
                if self.engine.spec_k:
                    self._spec_round()
                else:
                    self._decode_round()
                progressed = True
            return progressed

    def run_until_idle(self) -> list:
        """Drive :meth:`step` until queue and pool drain; returns finished.

        When the only remaining work is a future arrival, the scheduler
        waits for it (``time.sleep`` on the wall clock, ``advance`` on a
        :class:`ManualClock`).
        """
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
                self._ahead.discard(r.rid)
                self.expired += 1
                if self._mx is not None:
                    self._mx["expired"].inc()
                self._trace_finish(r, "expired")
                self.finished.append(r)
                self._finish_cb(r)
                self._retire(r.rid)
                self.log.debug("request expired", rid=r.rid,
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
                (i for i, r in enumerate(self.queue)
                 if r.rid not in self._ahead or r.arrival_s <= now),
                None,
            )
            if idx is None:
                break
            req = self.queue.pop(idx)
            self._ahead.discard(req.rid)
            # the admission instant: the request's wait ends, its prefill
            # (whole, or its first chunk) starts
            req.queue_s = self.elapsed() - req.arrival_s
            if eng.prefill_chunk is not None:
                # chunked prefill: claim the slot now, advance one chunk per
                # round (_advance_prefills) — the first token is emitted
                # when the prompt completes
                self._trace_admit(req, chunked=True)
                eng._begin_prefill(slot, req)
                req.status = "running"
                admitted = True
                self.log.debug("admitted request", rid=req.rid,
                               prefill="chunked", queued=len(self.queue))
                continue
            self._trace_admit(req, chunked=False)
            logits = eng._prefill_slot(slot, req)
            self._first_token(req, logits)
            admitted = True
            self.log.debug("admitted request", rid=req.rid,
                           queued=len(self.queue))
        return admitted

    def _advance_prefills(self) -> bool:
        """One chunk of progress for every mid-prefill slot (chunked mode);
        emits the first token of any prompt that completes this round."""
        eng = self.engine
        progressed = False
        for slot in eng.prefilling_slots():
            req = eng._prefilling[slot]["req"]
            logits = eng._prefill_step(slot)
            progressed = True
            if self.tracer is not None:
                sp = self._spans.get(req.rid)
                if sp is not None and "chunks" in sp:
                    sp["chunks"] += 1
            if logits is not None:
                self._first_token(req, logits)
                self.log.debug("prefill complete", rid=req.rid)
        return progressed

    def _first_token(self, req, logits) -> None:
        """Select and record a freshly-prefilled request's first token."""
        t = self.elapsed()
        tok = self._select(req, logits)
        req.output.append(tok)
        req.status = "running"
        req.ttft_s = t - req.arrival_s
        self._ttfts.append(req.ttft_s)
        if self._mx is not None:
            self._mx["ttft"].observe(req.ttft_s)
        if self.tracer is not None:
            sp = self._spans.get(req.rid)
            if sp is not None:
                pre = sp.pop("prefill", None)
                if pre is not None:
                    self.tracer.end(pre, chunks=sp.pop("chunks", 0))
                self.tracer.event("first_token", parent=sp["request"],
                                  ttft_s=round(req.ttft_s, 9))
                sp["decode"] = self.tracer.begin("decode",
                                                 parent=sp["request"])
        self._rec[req.rid] = {
            "arrival": req.arrival_s, "admit": req.arrival_s + req.queue_s,
            "token_times": [t],
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
        if self._mx is not None:
            self._mx["decode_steps"].inc()
        # pure-greedy pools (the common case, and all of run()) take the
        # device-side argmax — transferring B ints per step, not the whole
        # (slots, vocab) logits matrix; the full rows come to host only
        # when some active request actually samples
        with obs.profile_scope("serve.sample"):
            if any(getattr(r, "sampling", None) is not None
                   for r in eng.active if r is not None):
                rows, nxt = logits.cpu().numpy(), None
            else:
                rows, nxt = None, logits.argmax(dim=-1).cpu().numpy()
        with obs.profile_scope("serve.emit"):
            t = self.elapsed()
            self._span_end = t
            for i, r in enumerate(eng.active):
                if r is None:
                    continue
                eng.pos[i] += 1
                tok = (int(nxt[i]) if rows is None
                       else self._select(r, rows[i]))
                # a slot admitted behind the scheduler's back (direct
                # ServeEngine._admit) is adopted on its first decode:
                # timing starts now, its prefill token predates the record
                rec = self._rec.setdefault(
                    r.rid,
                    {"arrival": r.arrival_s, "admit": t, "token_times": []})
                self._round_tokens += 1
                self._round_slots += 1
                self._emit_tokens(r, rec, [tok], t)
                if (tok == r.eos_id or len(r.output) >= r.max_new_tokens
                        or eng.pos[i] >= eng.max_len - 1):
                    self._finish_request(r, i, t, rec)

    def _spec_round(self) -> None:
        """One speculative decode round: propose -> verify -> accept/emit.

        The drafter proposes ``spec_k`` greedy tokens per active slot; the
        target scores all k+1 positions in ONE batched forward
        (``verify_active``); the longest draft prefix matching the
        target's own greedy argmax is accepted, and the matching argmax
        tokens plus the first-mismatch correction are emitted through the
        SAME per-token finish checks as :meth:`_decode_round`.  Every
        emitted token is the argmax of the target's verify row for its
        position, so greedy streams equal ``spec_decode=0`` wherever a
        verify row equals the sequential ``decode_step`` row (the
        reference's invariant; the port's tests hold it on the CPU, and
        ``chip_smoke.py`` measures on the card how far a bf16 matmul over
        slots x (k+1) rows moves a row's logits against one over slots
        rows).  Speculation only decides how many rows a round consumes.
        Sampled requests emit ONE token from row 0 under the classic
        ``(seed, rid, position)`` draw (their drafts are discarded).
        Rejected draft KV rolls back via ``truncate_slot`` /
        ``draft.truncate``.
        """
        eng = self.engine
        k = eng.spec_k
        draft = eng.draft
        active = [(i, r) for i, r in enumerate(eng.active) if r is not None]
        # catch-up token lists: the true tokens at drafter positions
        # dpos..pos inclusive (one entry at steady state; two after a
        # fully-accepted round — see DraftModel.propose)
        pend = {}
        for i, r in active:
            plen = len(r.prompt)
            lo, hi = int(draft.pos[i]), int(eng.pos[i])
            pend[i] = [r.prompt[p] if p < plen else r.output[p - plen]
                       for p in range(lo, hi + 1)]
        t0 = time.perf_counter()
        drafts = draft.propose(pend, k)
        t1 = time.perf_counter()
        tokens = np.zeros((eng.slots, k + 1), np.int32)
        for i, r in active:
            tokens[i, 0] = r.output[-1]
            tokens[i, 1:] = drafts[i]
        logits = eng.verify_active(tokens)
        self.decode_steps += 1
        self._spec_rounds += 1
        if self._mx is not None:
            self._mx["decode_steps"].inc()
        # pure-greedy pools take the device-side argmax — (slots, k+1) ints
        # per round, not the logits cube; full rows come to host only when
        # some active request actually samples
        with obs.profile_scope("serve.sample"):
            if any(getattr(r, "sampling", None) is not None
                   for _, r in active):
                rows = logits.cpu().numpy()                 # (slots, k+1, V)
                g = np.argmax(rows, axis=-1)
            else:
                rows = None
                g = logits.argmax(dim=-1).cpu().numpy()     # (slots, k+1)
        t2 = time.perf_counter()
        self._draft_s.append(t1 - t0)
        self._verify_s.append(t2 - t1)
        if self._mx is not None:
            self._mx["spec_draft_s"].observe(t1 - t0)
            self._mx["spec_verify_s"].observe(t2 - t1)
        t = self.elapsed()
        self._span_end = t
        for i, r in active:
            rec = self._rec.setdefault(
                r.rid, {"arrival": r.arrival_s, "admit": t, "token_times": []}
            )
            sampled = getattr(r, "sampling", None) is not None
            if sampled:
                toks = [self._select(r, rows[i, 0])]
            else:
                m = 0
                while m < k and int(tokens[i, m + 1]) == int(g[i, m]):
                    m += 1
                toks = [int(g[i, j]) for j in range(m + 1)]
                self._spec_drafted += k
                self._spec_accepted += m
                if self._mx is not None:
                    self._mx["spec_drafted"].inc(k)
                    self._mx["spec_accepted"].inc(m)
            # accepted tokens still pass the baseline's PER-TOKEN finish
            # checks: acceptance can never run past EOS / max_new_tokens /
            # the max_len position cap (tokens after the finish point are
            # discarded, exactly as the baseline would never produce them)
            emit = []
            out_len = len(r.output)
            posi = int(eng.pos[i])
            finished = False
            for tok in toks:
                posi += 1
                out_len += 1
                emit.append(tok)
                if (tok == r.eos_id or out_len >= r.max_new_tokens
                        or posi >= eng.max_len - 1):
                    finished = True
                    break
            eng.pos[i] = posi
            self._round_tokens += len(emit)
            self._round_slots += 1
            self._emit_tokens(r, rec, emit, t)
            if finished:
                self._finish_request(r, i, t, rec)
            else:
                # roll back the rejected speculative KV tail on both models
                eng.truncate_slot(i, posi)
                draft.truncate(i, posi)

    def _finish_request(self, r, slot: int, t: float, rec: dict) -> None:
        r.done = True
        r.status = "done"
        r.latency_s = t - rec["admit"]
        self.completed += 1
        if self._mx is not None:
            self._mx["completed"].inc()
        self._trace_finish(r, "done")
        self.finished.append(r)
        self.engine.release_slot(slot)
        self._finish_cb(r)
        self._retire(r.rid)
        self.log.debug("request done", rid=r.rid, tokens=len(r.output),
                       latency_s=round(r.latency_s, 3))

    def _emit_tokens(self, r, rec: dict, toks: list, t: float) -> None:
        """Record + stream tokens emitted together at wall instant ``t``.

        Multi-token acceptance (speculative decode) lands n > 1 tokens of
        one request in one round; inter-token latency stays
        per-EMITTED-token by spreading the round's wall time uniformly
        across them — each gap records as (t - last) / n, which at n = 1
        is exactly the classic per-round ITL."""
        times = rec["token_times"]
        n = len(toks)
        last = times[-1] if times else t
        for j, tok in enumerate(toks, start=1):
            tj = t if j == n else last + (t - last) * (j / n)
            r.output.append(tok)
            if self._mx is not None and times:
                self._mx["itl"].observe(tj - times[-1])
            times.append(tj)
            self._emit(r, tok)

    def _retire(self, rid: int) -> None:
        """Fold a finished request's record into the capped aggregates and
        drop all per-request state (records live only while active)."""
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
        if self._mx is not None:
            self._mx["tokens"].inc()
        cb = self._on_token.get(req.rid)
        if cb is not None:
            cb(req, tok)

    def _finish_cb(self, req) -> None:
        cb = self._on_done.get(req.rid)
        if cb is not None:
            cb(req)

    # -- obs hooks (no-ops unless tracing / metrics are enabled) -----------

    def _trace_admit(self, req, chunked: bool) -> None:
        """queued span ends, prefill span opens (admission instant)."""
        if self.tracer is None:
            return
        sp = self._spans.get(req.rid)
        if sp is None:
            return  # submitted before tracing was attached
        q = sp.pop("queued", None)
        if q is not None:
            self.tracer.end(q)
        sp["prefill"] = self.tracer.begin("prefill", parent=sp["request"],
                                          chunked=chunked)
        sp["chunks"] = 0

    def _trace_finish(self, req, status: str) -> None:
        """Close the request's whole span tree (done or expired)."""
        if self.tracer is None:
            return
        sp = self._spans.pop(req.rid, None)
        if sp is None:
            return
        dec = sp.get("decode")
        if dec is not None and dec.open:
            self.tracer.end(dec, tokens=len(req.output))
        for k in ("queued", "prefill"):
            s = sp.get(k)
            if s is not None and s.open:
                self.tracer.end(s)
        if sp["request"].open:
            self.tracer.end(sp["request"], status=status,
                            tokens=len(req.output))

    def _sample_gauges(self, depth: int) -> None:
        """Mirror the point-in-time pool state into the obs gauges (one
        call per scheduling round; only reached when obs is enabled)."""
        mx = self._mx
        mx["queue_depth"].set(depth)
        mx["active"].set(sum(r is not None for r in self.engine.active))
        mx["prefilling"].set(len(self.engine.prefilling_slots()))
        kv = self.engine.kv_stats()
        if kv:
            for k in _KV_GAUGES:
                if k in kv:
                    mx[f"kv.{k}"].set(kv[k])

    def _stats_line(self, now: float) -> None:
        """One periodic info-level summary line through the structured
        logger (``stats_interval_s=``) — replaces ad-hoc caller lambdas."""
        s = self.stats()
        ttft_p50 = None if s["ttft_s"] is None else s["ttft_s"]["p50"]
        self.log.info(
            "stats",
            elapsed_s=round(now, 3),
            submitted=s["submitted"], completed=s["completed"],
            expired=s["expired"], rejected=s["rejected"],
            queued=s["queued"], active=s["active"],
            tokens=s["tokens"],
            tokens_per_s=(round(s["tokens_per_s"], 1)
                          if s["tokens_per_s"] is not None else None),
            ttft_p50_s=(round(ttft_p50, 4) if ttft_p50 is not None else None),
        )

    # -- observability ----------------------------------------------------

    def queue_depth_trace(self) -> list:
        """(elapsed_s, queue_depth) samples, one per scheduling round
        (capped tail: the most recent 4096 rounds)."""
        return list(self._depth_samples)

    def drain_finished(self) -> list:
        """Return and clear the finished list — long-lived callers should
        drain periodically so completed Request objects don't accumulate."""
        out, self.finished = self.finished, []
        return out

    def stats(self) -> dict:
        """Aggregate metrics snapshot (the reference's keys; see
        docs/serving.md for the glossary).

        TTFT is measured from *arrival* (not admission), so queueing delay
        under load shows up where a caller would feel it; inter-token
        latencies are PER EMITTED TOKEN — the gaps between consecutive
        emitted tokens of one request, pooled over all requests (finished
        aggregates plus the currently active requests' partial streams).
        When a round emits n > 1 tokens of one request (speculative
        multi-token acceptance) the round's wall time spreads uniformly
        across them, so ITL keeps meaning seconds-per-token instead of
        deflating to seconds-per-round; ``tokens_per_round`` (mean tokens
        emitted per active slot per decode round — exactly 1.0 without
        speculation) carries the round-shape signal separately.
        ``tokens_per_s`` spans first admission to the last emitted token.
        TTFT/ITL percentiles are over the most recent 4096 samples.
        ``spec`` is None unless the engine speculates (``spec_decode=k``);
        ``accept_rate`` is accepted/drafted over greedy slots (sampled
        requests discard their drafts and are not counted).

        Every field is defined for every scheduler state: zero completed
        requests never divides by zero or emits NaN (``tokens_per_s`` is
        None until a span exists), and a workload where no request ever
        produced a first token — e.g. everything expired in the queue —
        reports ``ttft_s: None`` rather than an empty summary dict.
        """
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
            "spec": (None if not getattr(self.engine, "spec_k", 0) else {
                "k": self.engine.spec_k,
                "rounds": self._spec_rounds,
                "drafted": self._spec_drafted,
                "accepted": self._spec_accepted,
                "accept_rate": (self._spec_accepted / self._spec_drafted
                                if self._spec_drafted else None),
                "draft_s": _summary(list(self._draft_s)),
                "verify_s": _summary(list(self._verify_s)),
            }),
            "queue_depth": {
                "samples": len(self._depth_samples),
                "rounds": self._depth_rounds,
                "max": self._depth_max,
                "mean": (self._depth_sum / self._depth_rounds
                         if self._depth_rounds else 0.0),
            },
            "elapsed_s": self.elapsed(),
        }
