"""The port's host-phase instrumentation: counters, queue wait, ranges.

  * the executor's ``runtime.rows{kind=real|pad}`` and
    ``runtime.h2d_bytes`` and the engine's
    ``serve.prompt_tokens{kind=real|pad}`` equal what was sent, whole and
    chunked, and reach the registry through collectors;
  * ``setup.seconds{phase=...}`` grows in quantize and deploy, one phase
    each, and ``obs.profiled_counts`` gives what an annotated interval
    added;
  * ``Request.queue_s`` (arrival to admission) plus the request's own
    prefill is its ``ttft_s`` under ``ManualClock``, equals the tracer's
    ``queued`` span, and ``latency_s`` runs from admission;
  * under a CPU ``torch.profiler`` run the ranges nest: ``runtime.*`` in
    ``model.ffn`` in ``serve.decode_step`` (or ``serve.prefill``) in
    ``serve.round``, and a decode step ends outside every nested range;
    with annotations off ``profile_scope`` is one shared null context and
    never reaches ``torch.profiler``.

No JAX here: these hold the port to its own documented behaviour (the
reference has none of these series or ranges).
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch import obs, runtime
from repro_torch.configs import smoke_config
from repro_torch.core.kan_layer import KANSpec, init_kan_network
from repro_torch.core.kan_network_deploy import (
    deploy_kan_network,
    quantize_kan_network,
)
from repro_torch.models.model import init_params
from repro_torch.obs.metrics import SETUP_SECONDS
from repro_torch.serve import ManualClock, Request, Scheduler, ServeEngine
from repro_torch.serve import engine as engine_mod

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def kan1():
    kspec = KANSpec(dims=(17, 1, 14), grid_size=5, n_bits=8)
    params = init_kan_network(torch.Generator().manual_seed(0), kspec,
                              device="cpu")
    return deploy_kan_network(quantize_kan_network(params, kspec), kspec,
                              device="cpu")


@pytest.fixture(scope="module")
def lm():
    cfg = smoke_config("qwen2.5-14b").kan_variant()
    return cfg, init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")


@pytest.fixture(autouse=True)
def _fresh_counts():
    runtime.reset_io_counts()
    engine_mod.PROMPT_TOKENS.clear()
    yield
    obs.disable_profiler_annotations()


def _rows(b, f=17, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (b, f)).astype(
        np.float32)


def _reqs(cfg, plens, max_new=3, seed=42):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(3, cfg.vocab_size, n).tolist(),
                    max_new_tokens=max_new)
            for i, n in enumerate(plens)]


def _snap():
    return {k: v["value"]
            for k, v in obs.REGISTRY.snapshot()["metrics"].items()}


# -- counters -----------------------------------------------------------------


@pytest.mark.parametrize("sizes", [(3,), (5, 8, 9), (100, 17, 1)])
def test_executor_counts_real_and_pad_rows_and_host_bytes(kan1, sizes):
    for b in sizes:
        runtime.execute(kan1, _rows(b, seed=b))
    buckets = [runtime.bucket_batch(b) for b in sizes]
    assert runtime.io_counts() == {
        "rows_real": sum(sizes), "rows_pad": sum(buckets) - sum(sizes),
        "h2d_bytes": 17 * 4 * sum(sizes)}
    snap = _snap()
    assert snap["runtime.rows{kind=real}"] == sum(sizes)
    assert snap["runtime.rows{kind=pad}"] == sum(buckets) - sum(sizes)
    assert snap["runtime.h2d_bytes"] == 17 * 4 * sum(sizes)


def test_host_bytes_count_host_data_only(kan1):
    """A list and a float64 array are host data (counted as the f32 rows
    the device gets); a tensor already on the bundle's device is not."""
    runtime.execute(kan1, _rows(4).astype(np.float64))
    runtime.execute(kan1, _rows(2).tolist())
    runtime.execute(kan1, torch.from_numpy(_rows(6)))
    assert runtime.io_counts() == {"rows_real": 12, "rows_pad": 12,
                                   "h2d_bytes": 17 * 4 * 6}


@pytest.mark.parametrize("mode", [
    {}, {"kv_block_size": 8}, {"kv_block_size": 8, "prefill_chunk": 8}],
    ids=["contiguous", "paged", "chunked"])
def test_prompt_tokens_count_real_and_bucket_padding(lm, mode):
    cfg, params = lm
    plens = (5, 9, 13, 16)
    eng = ServeEngine(params, cfg, slots=2, max_len=64, device="cpu", **mode)
    eng.run(_reqs(cfg, plens))
    chunk = mode.get("prefill_chunk")
    calls = []
    for n in plens:
        # paged engines reuse no block here: every prompt is distinct
        takes = [n] if chunk is None else [
            min(chunk, n - s) for s in range(0, n, chunk)]
        calls += takes
    pad = sum(runtime.bucket_batch(t) - t for t in calls)
    assert dict(engine_mod.PROMPT_TOKENS) == {"real": sum(plens), "pad": pad}
    snap = _snap()
    assert snap["serve.prompt_tokens{kind=real}"] == sum(plens)
    assert snap["serve.prompt_tokens{kind=pad}"] == pad


def test_setup_seconds_count_quantize_and_deploy_apart():
    kspec = KANSpec(dims=(17, 4, 14), grid_size=5)
    params = init_kan_network(torch.Generator().manual_seed(3), kspec,
                              device="cpu")
    before = dict(SETUP_SECONDS)
    q = quantize_kan_network(params, kspec)
    mid = dict(SETUP_SECONDS)
    deploy_kan_network(q, kspec, device="cpu")
    after = dict(SETUP_SECONDS)
    assert mid["quantize"] > before.get("quantize", 0)
    assert mid.get("deploy", 0) == before.get("deploy", 0)
    assert after["deploy"] > mid.get("deploy", 0)
    assert after["quantize"] == mid["quantize"]
    assert after.get("kernel_build", 0) == before.get("kernel_build", 0)
    assert _snap()["setup.seconds{phase=deploy}"] == SETUP_SECONDS["deploy"]


def test_profiled_counts_cover_the_annotated_interval_only(kan1):
    runtime.execute(kan1, _rows(3))
    obs.enable_profiler_annotations()
    runtime.execute(kan1, _rows(9))
    runtime.execute(kan1, _rows(20))
    obs.disable_profiler_annotations()
    runtime.execute(kan1, _rows(40))
    got = obs.profiled_counts()
    assert got["runtime.rows{kind=real}"] == 29
    assert got["runtime.rows{kind=pad}"] == (16 - 9) + (32 - 20)
    assert got["runtime.h2d_bytes"] == 29 * 17 * 4
    assert got["runtime.backend_dispatch{backend=fused}"] == 2


# -- the queue wait -----------------------------------------------------------


class _Timed:
    """Moves a ManualClock by fixed amounts inside the engine's prefill and
    decode calls, so each phase takes known time."""

    PREFILL_S = 1.0
    DECODE_S = 0.25

    def __init__(self, eng, clock):
        prefill, decode = eng._prefill_step, eng.decode_active

        def timed_prefill(slot):
            clock.advance(self.PREFILL_S)
            return prefill(slot)

        def timed_decode(tokens):
            clock.advance(self.DECODE_S)
            return decode(tokens)

        eng._prefill_step = timed_prefill
        eng.decode_active = timed_decode


@pytest.mark.parametrize("trace", [False, True])
def test_queue_wait_plus_own_prefill_is_ttft(lm, trace):
    cfg, params = lm
    clock = ManualClock()
    eng = ServeEngine(params, cfg, slots=2, max_len=64, device="cpu")
    _Timed(eng, clock)
    sched = Scheduler(eng, clock=clock, trace=trace)
    reqs = _reqs(cfg, (6, 7, 8, 5, 9), max_new=3)
    last = {}
    for r in reqs:
        sched.submit(r, on_token=lambda q, tok: last.__setitem__(
            q.rid, clock.now()))
    done = sched.run_until_idle()
    assert len(done) == len(reqs)
    # the first two wait 0 and one prefill; the rest wait for a slot
    assert [r.queue_s for r in reqs[:2]] == [0.0, _Timed.PREFILL_S]
    assert all(r.queue_s > _Timed.PREFILL_S for r in reqs[2:])
    for r in reqs:
        assert r.arrival_s == 0.0
        assert r.queue_s + _Timed.PREFILL_S == pytest.approx(r.ttft_s)
        # admission -> last token, the prefill included
        assert r.latency_s == pytest.approx(last[r.rid] - r.queue_s)
        assert r.latency_s >= _Timed.PREFILL_S + 2 * _Timed.DECODE_S
    if trace:
        spans = {(d["rid"], d["name"]): d for d in sched.tracer.records()}
        for r in reqs:
            q = spans[(r.rid, "queued")]
            assert q["t1"] - q["t0"] == pytest.approx(r.queue_s)


def test_queue_wait_on_the_chunked_path(lm):
    cfg, params = lm
    clock = ManualClock()
    eng = ServeEngine(params, cfg, slots=1, max_len=64, device="cpu",
                      kv_block_size=8, prefill_chunk=8)
    _Timed(eng, clock)
    sched = Scheduler(eng, clock=clock)
    reqs = _reqs(cfg, (12, 20), max_new=2)
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    # 12 tokens: two chunks; the second request waits for the slot: two
    # chunks and one decode step of the first
    assert reqs[0].queue_s == 0.0
    assert reqs[0].ttft_s == pytest.approx(2 * _Timed.PREFILL_S)
    assert reqs[1].queue_s == pytest.approx(
        2 * _Timed.PREFILL_S + _Timed.DECODE_S)
    assert reqs[1].ttft_s == pytest.approx(reqs[1].queue_s
                                           + 3 * _Timed.PREFILL_S)


# -- the ranges ---------------------------------------------------------------


def _ranges(prof) -> dict:
    out = {}
    for e in prof.events():
        if "." in e.name and not e.name.startswith(("aten", "cudaLaunch")):
            out.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out


def _inside(span, outers) -> bool:
    return any(s <= span[0] and span[1] <= e for s, e in outers)


def test_ranges_nest_from_round_to_executor(lm):
    from torch.profiler import ProfilerActivity, profile

    cfg, params = lm
    eng = ServeEngine(params, cfg, slots=2, max_len=64, device="cpu",
                      kan_deploy=True)
    sched = Scheduler(eng)
    for r in _reqs(cfg, (6, 11), max_new=3):
        sched.submit(r)
    obs.enable_profiler_annotations()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sched.run_until_idle()
    obs.disable_profiler_annotations()
    rg = _ranges(prof)
    for name in ("serve.round", "serve.prefill", "serve.decode_step",
                 "serve.sample", "serve.emit", "model.attention",
                 "model.ffn", "model.head", "runtime.plan", "runtime.entry",
                 "kan_spline.fused"):
        assert rg.get(name), (name, sorted(rg))
    steps = rg["serve.decode_step"] + rg["serve.prefill"]
    ffn_in_steps = [f for f in rg["model.ffn"] if _inside(f, steps)]
    assert len(ffn_in_steps) == len(rg["model.ffn"])
    for name in ("runtime.plan", "runtime.entry", "kan_spline.fused"):
        assert all(_inside(s, rg["model.ffn"]) for s in rg[name]), name
    for name in ("serve.decode_step", "serve.prefill", "serve.sample",
                 "serve.emit"):
        assert all(_inside(s, rg["serve.round"]) for s in rg[name]), name
    assert all(_inside(s, steps) for s in rg["model.attention"])
    # the head has a range in a whole-prompt prefill only
    assert all(_inside(s, rg["serve.prefill"]) for s in rg["model.head"])
    assert len(rg["model.head"]) == len(rg["serve.prefill"])
    # one attention and one FFN range per layer per step
    n_layers = cfg.num_layers
    assert len(rg["model.ffn"]) == n_layers * len(steps)
    assert len(rg["model.attention"]) == n_layers * len(steps)
    # a step's last op runs in no nested range, so a device trace, which
    # puts each kernel on its innermost range only, still spans the whole
    # step (kernels_per_decode_step reads serve.decode_step's device span)
    ops = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.name.startswith("aten::"))
    nested = [s for n, spans in rg.items() if n.startswith(
        ("model.", "runtime.", "kan_spline.")) for s in spans]
    for step in rg["serve.decode_step"]:
        last = max((o for o in ops if _inside(o, [step])), key=lambda o: o[1])
        assert not _inside(last, nested), (step, last)


def test_host_copy_range_only_for_host_data(kan1):
    from torch.profiler import ProfilerActivity, profile

    obs.enable_profiler_annotations()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runtime.execute(kan1, _rows(5))
        runtime.execute(kan1, torch.from_numpy(_rows(6)))
    obs.disable_profiler_annotations()
    rg = _ranges(prof)
    assert len(rg["runtime.h2d"]) == 1
    assert len(rg["runtime.entry"]) == len(rg["runtime.plan"]) == 2
    assert len(rg["kan_spline.fused"]) == 2
    # the padding to the bucket (5 -> 8 rows) stays in the kernels' range
    pads = [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name in ("aten::pad", "aten::constant_pad_nd")]
    assert pads and all(_inside(p, rg["kan_spline.fused"]) for p in pads)
    assert not any(_inside(p, rg["runtime.entry"]) for p in pads)


def test_profile_scope_off_never_reaches_the_profiler(lm, monkeypatch):
    """Off, every scope is the one shared null context, and a served
    workload never calls ``record_function``."""
    cfg, params = lm
    a, b = obs.profile_scope("serve.round"), obs.profile_scope("model.ffn")
    assert a is b and isinstance(a, contextlib.nullcontext)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with annotations off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    eng = ServeEngine(params, cfg, slots=2, max_len=64, device="cpu",
                      kan_deploy=True)
    done = eng.run(_reqs(cfg, (5, 9), max_new=2))
    assert len(done) == 2
