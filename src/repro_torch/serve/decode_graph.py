"""A pooled decode step replayed from CUDA graphs, cut at the program's ranges.

A decode step of a deep serving stack launches hundreds of small kernels,
and issuing them one by one from Python can take longer than the card
takes to run them: the step then waits on the host, and its time follows
the host's load.  :class:`DecodeGraph` captures one step once and replays
it.  Every ``obs.profile_scope`` entered or left inside the step ends one
graph and begins the next (all in one memory pool, replayed in the order
they were captured), and a replay enters and leaves the same scopes
between the same graphs, so a trace still puts each kernel under its
layer's range.  The step must not read the device from the host: a read
fails the capture.

The host counters that the step moves (launches, dispatches, rows) move
once at capture, when nothing runs; that change is taken back, and added
again at every replay, so a replayed step counts as an eager one does.
"""

from __future__ import annotations

import collections
import warnings

import torch

from ..obs import trace as obs_trace


def _counters() -> tuple:
    """The module-level host counters a decode step can move."""
    from ..core.kan_ffn_deploy import MOE_COUNTS
    from ..kernels.cuda import LAUNCHES
    from ..runtime.attention import ATTN_DISPATCH_COUNTS
    from ..runtime.executor import DISPATCH_COUNTS, IO_COUNTS

    return (LAUNCHES, MOE_COUNTS, ATTN_DISPATCH_COUNTS, DISPATCH_COUNTS,
            IO_COUNTS)


class DecodeGraph:
    """``fn(*inputs)`` run once eagerly on a side stream (its output is
    ``first``; the run warms every lazy initialisation there), then
    captured on that stream.  Calling the object copies new values into
    the captured inputs, replays, and returns the captured output
    (overwritten by the next call)."""

    def __init__(self, fn, inputs: tuple):
        dev = inputs[0].device
        self.inputs = tuple(t.clone() for t in inputs)
        self._pool = torch.cuda.graph_pool_handle()
        # ("graph", CUDAGraph) | ("enter", range name) | ("exit", None)
        self.steps: list = []
        counters = _counters()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        # a range with no kernel in it leaves an empty graph, which the
        # capture warns of and a replay launches as a no-op
        with torch.cuda.stream(stream), warnings.catch_warnings():
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            self.first = fn(*self.inputs)
            before = [collections.Counter(c) for c in counters]
            self._begin()
            obs_trace._SCOPE_CUT = self._cut
            try:
                self.out = fn(*self.inputs)
            finally:
                obs_trace._SCOPE_CUT = None
                self._end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self._deltas = []
        for c, b in zip(counters, before):
            d = collections.Counter(c)
            d.subtract(b)
            d = {k: v for k, v in d.items() if v}
            for k, v in d.items():
                c[k] -= v
            self._deltas.append((c, d))

    def _begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self._pool)
        self.steps.append(("graph", g))

    def _end(self) -> None:
        self.steps[-1][1].capture_end()

    def _mark(self, kind: str, name) -> None:
        self._end()
        self.steps.append((kind, name))
        self._begin()

    def _cut(self, name: str):
        graph = self

        class _Cut:
            def __enter__(self):
                graph._mark("enter", name)

            def __exit__(self, *exc):
                graph._mark("exit", None)
                return False

        return _Cut()

    def __call__(self, *values) -> torch.Tensor:
        for dst, v in zip(self.inputs, values):
            dst.copy_(v)
        scopes = []
        for kind, x in self.steps:
            if kind == "graph":
                x.replay()
            elif kind == "enter":
                scope = obs_trace.profile_scope(x)
                scope.__enter__()
                scopes.append(scope)
            else:
                scopes.pop().__exit__(None, None, None)
        for c, d in self._deltas:
            for k, v in d.items():
                c[k] += v
        return self.out
