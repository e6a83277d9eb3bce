"""Closed-loop bulk scoring of feature rows through a ``kan_network``
system.

One client keeps ``in_flight`` requests outstanding: it dispatches the
next request (the program copies its host rows to the device and
launches the network) before it reads the oldest answer back to the
host.  Request sizes are the mix's fixed sequence, cycled
(``benchlib.lengths``); rows are slices of a pool of knot-invariant rows
drawn from the run's seed (``benchlib.knot``), held in pageable host
memory as a client's tables are.

The client reads each answer into a host buffer it allocated and
touched at set-up, as a bulk scorer streams results into its own
memory; a fresh host tensor per answer would add the page faults of
~4 MB of new memory to every request.

Set-up warms one request of every power-of-two bucket the sizes fall in,
then the loop runs ``ramp_s`` seconds before the window opens.  The
window opens and closes at answer boundaries: ``rows_done`` counts the
rows whose answers reached the host inside it.  A seed-drawn reservoir of
``check_answers`` answers read in the window is kept for the check.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from benchlib import lengths
from benchlib.knot import knot_features
from benchlib.record import RunRecord
from benchlib.work import ceil_pow2


def run(ctx) -> RunRecord:
    mix, sut = ctx.mix, ctx.sut
    sizes = lengths.fixed_sizes(mix["rows"], mix, 0)
    pool = knot_features(int(mix["pool_rows"]), ctx.seed % lengths.SEED_MOD)
    gen = lengths.rng(ctx.seed, 2)
    offsets = gen.integers(0, len(pool) - sizes + 1)

    # the host buffer for the answers, touched once; then every bucket the
    # sizes use, warmed at its largest size
    buf = torch.zeros((int(sizes.max()), ctx.cfg["dims"][-1]))
    for b in sorted({ceil_pow2(int(n)) for n in sizes}):
        n = int(sizes[np.array([ceil_pow2(int(m)) for m in sizes]) == b].max())
        buf[:n].copy_(sut.execute(pool[:n]))
    ctx.sync()

    rec = RunRecord(ctx)
    pending = collections.deque()
    keep = int(mix["check_answers"])
    sample, seen = [], 0
    state = "ramp"
    t_ramp = time.perf_counter()
    tracer = None
    traced = []                 # rows of the requests dispatched while traced
    i = 0
    while True:
        k = i % len(sizes)
        n, off = int(sizes[k]), int(offsets[k])
        x = pool[off:off + n]
        pending.append((x, sut.execute(x)))
        if tracer is not None:
            traced.append(n)
        i += 1
        if len(pending) < mix["in_flight"]:
            continue
        x, y = pending.popleft()
        y = buf[:x.shape[0]].copy_(y)
        now = time.perf_counter()
        if state == "ramp":
            if now - t_ramp >= mix["ramp_s"]:
                state = "window"
                rec.open_window(now)
                if ctx.trace:
                    tracer = ctx.tracer()
                    tracer.start()
                    t_trace = time.perf_counter()
            continue
        rec.attempted += 1
        rec.rows_done += int(x.shape[0])
        # a seed-drawn reservoir of the answers read in the window
        seen += 1
        if len(sample) < keep:
            sample.append((x, y.clone()))
        else:
            r = int(gen.integers(0, seen))
            if r < keep:
                sample[r] = (x, y.clone())
        if tracer is not None and (now - t_trace
                                   >= min(mix["trace_s"], ctx.seconds)):
            rec.trace = tracer.stop()
            tracer = None
        if now - rec.t_open >= ctx.seconds and tracer is None:
            rec.close_window(now)
            break
    for x, y in pending:        # answers still in flight at the close
        buf[:x.shape[0]].copy_(y)
    rec.answers = sample
    rec.traced_rows = traced
    return rec
