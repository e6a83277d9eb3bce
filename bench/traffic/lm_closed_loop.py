"""Closed-loop LM clients through an ``lm_serve`` system's scheduler.

``clients`` clients each keep one greedy request outstanding: when a
request's last token is emitted, its client sends the next one at once.
Prompt and output lengths are the mix's fixed sequences, cycled
(``benchlib.lengths``); prompt tokens are drawn from the run's seed, uniform over the vocabulary above the three special ids, and no
request stops early (no end-of-sequence id).  With ``stagger:
"residual"`` each client's first request asks for a uniform share of its
length, so completions are spread evenly from the start and the load is
steady once the first admissions are served.

Set-up warms the engine at every power-of-two prompt bucket of the mix
(one request each, which also warms decode at every slot), then the
clients run ``ramp_s`` seconds before the window opens.  The window
opens and closes between scheduler steps.  Each token's time is taken on
the host when the scheduler hands it over (``on_token``): TTFT from the
client's send, inter-token gaps between a stream's consecutive tokens.
After the close no request is sent, and the loop runs on until every
request sent in the window has its first token.  Requests finished in the
window are kept for the check: the one with the most tokens and a
seed-drawn sample of the others.
"""

from __future__ import annotations

import time

import numpy as np

from benchlib import lengths
from benchlib.record import RunRecord
from benchlib.work import ceil_pow2

DRAIN_LIMIT_S = 60.0


class Stream:
    __slots__ = ("rid", "client", "t_send", "plen", "prompt", "times",
                 "t_done", "req")

    def __init__(self, rid, client, t_send, prompt, req):
        self.rid, self.client, self.t_send = rid, client, t_send
        self.prompt, self.plen, self.req = prompt, len(prompt), req
        self.times = []
        self.t_done = None


def run(ctx) -> RunRecord:
    from repro_torch.serve import Request, Scheduler

    mix, eng = ctx.mix, ctx.sut.engine
    vocab = ctx.cfg["vocab_size"]
    plens = lengths.fixed_sizes(mix["prompt"], mix, 0)
    olens = lengths.fixed_sizes(mix["output"], mix, 1)
    share = lengths.fixed_shares(mix, int(mix["clients"]))

    def prompt_of(q: int, n: int, salt: int = 3) -> list:
        return lengths.prompt_tokens(ctx.seed, q, n, vocab, salt)

    # warm every prompt bucket of the mix, and decode at every slot
    lo = ceil_pow2(int(mix["prompt"]["min"]))
    hi = ceil_pow2(int(mix["prompt"]["max"]))
    warm, b = [], lo
    while b <= hi:
        warm.append(Request(rid=-1 - len(warm), prompt=prompt_of(b, b, 6),
                            max_new_tokens=2, eos_id=-1))
        b *= 2
    eng.run(warm)
    ctx.sync()

    rec = RunRecord(ctx)
    streams: dict = {}
    state = {"phase": "ramp", "sent": 0, "step": None}
    sched = Scheduler(eng)

    def send(client: int, first: bool = False) -> None:
        q = state["sent"]
        state["sent"] += 1
        k = q % len(plens)
        n_out = int(olens[k])
        if first and mix.get("stagger") == "residual":
            n_out = max(1, int(np.ceil(share[client] * n_out)))
        prompt = prompt_of(q, int(plens[k]))
        req = Request(rid=q, prompt=prompt, max_new_tokens=n_out, eos_id=-1)
        streams[q] = Stream(q, client, time.perf_counter(), prompt, req)
        sched.submit(req, on_token=on_token, on_done=on_done)

    def on_token(req, tok) -> None:
        t = time.perf_counter()
        s = streams[req.rid]
        step = state["step"]
        if step is not None:
            if s.times:
                step["decode_keys"].append(s.plen + len(s.times))
            else:
                step["prefills"].append(s.plen)
        s.times.append(t)

    def on_done(req) -> None:
        s = streams[req.rid]
        s.t_done = time.perf_counter()
        if req.status != "done":
            rec.failed += 1
        if state["phase"] != "drain":
            send(s.client)

    for c in range(int(mix["clients"])):
        send(c, first=True)
    t_ramp = time.perf_counter()
    tracer, traced = None, []
    while True:
        now = time.perf_counter()
        phase = state["phase"]
        if phase == "ramp" and now - t_ramp >= mix["ramp_s"]:
            state["phase"] = phase = "window"
            rec.open_window(now)
            rec.first_rid = state["sent"]
            if ctx.trace:
                tracer = ctx.tracer()
                tracer.start()
                t_trace = time.perf_counter()
                calls0 = eng.decode_calls
        elif phase == "window":
            if tracer is not None and (now - t_trace
                                       >= min(mix["trace_s"], ctx.seconds)):
                rec.trace = tracer.stop()
                rec.traced_decode_calls = eng.decode_calls - calls0
                tracer = None
            if now - rec.t_open >= ctx.seconds and tracer is None:
                state["phase"] = phase = "drain"
                rec.close_window(now)
                rec.end_rid = state["sent"]
        if phase == "drain":
            waiting = [s for s in streams.values()
                       if s.rid >= rec.first_rid and not s.times]
            if not waiting or now - rec.t_close > DRAIN_LIMIT_S:
                rec.failed += len(waiting)
                break
        step = {"prefills": [], "decode_keys": []}
        state["step"] = step
        sched.step()
        state["step"] = None
        sched.drain_finished()
        if tracer is not None:
            traced.append(step)
    rec.streams = streams
    rec.traced_steps = traced
    rec.attempted = rec.end_rid - rec.first_rid
    rec.answers = sample_answers(streams, rec, int(mix["check_requests"]),
                                 lengths.rng(ctx.seed, 5))
    return rec


def sample_answers(streams: dict, rec, n: int, gen) -> list:
    """(prompt, tokens) of up to ``n`` requests finished in the window: the
    one with the most tokens, and the rest drawn from ``gen``."""
    done = sorted((s for s in streams.values()
                   if s.t_done is not None
                   and rec.t_open < s.t_done <= rec.t_close),
                  key=lambda s: (-len(s.req.output), s.rid))
    if not done:
        return []
    rest = done[1:]
    pick = gen.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [(s.prompt, list(s.req.output))
            for s in [done[0]] + [rest[int(i)] for i in sorted(pick)]]
