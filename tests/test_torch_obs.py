"""The port's observability layer, after ``tests/test_obs.py`` case for
case, plus the port against the reference.

The three invariants of the reference hold in the port:

  * **bit-identity**: greedy token streams are unchanged by observability
    (recording never feeds back into execution);
  * **determinism**: one workload under ``ManualClock`` exports a
    byte-identical JSONL trace run to run, and the ``ref`` / ``fused``
    backends produce the same span skeleton (ids, parents, timestamps;
    attrs may differ);
  * **zero cost when off**: with the registry disabled (the default),
    record calls are no-ops that leave no series behind.

Across packages, on the smoke ``qwen2.5-14b`` ``kan_variant()`` with the
reference's weights converted through ``convert.lm_params_from_numpy``:
the same request schedule under ``ManualClock`` gives the same
``tracer.skeleton()`` in both; a served workload leaves the same set of
series names in both registries, with one label mapped: the reference's
``runtime.backend_dispatch{backend=pallas}`` is the port's
``{backend=fused}`` (``pallas`` is the port's alias of ``fused``), and
besides the port's own series (``PORT_ONLY_SERIES``); and the port's
Prometheus text parses with the reference's strict parser.
"""

import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro import runtime as j_runtime
from repro.configs.registry import smoke_config as j_smoke
from repro.models import model as JM
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.scheduler import ManualClock as JManualClock
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch import convert, obs, runtime
from repro_torch.configs import smoke_config
from repro_torch.models.model import init_params
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import ManualClock, Request, Scheduler, ServeEngine

torch.set_num_threads(1)
# the one label that differs between the packages' series: the fused
# backend's name (the port registers "pallas" as an alias of "fused")
LABEL_ALIASES = {"runtime.backend_dispatch{backend=pallas}":
                 "runtime.backend_dispatch{backend=fused}"}
# series only the port exports (its collectors feed them from start): the
# executor's rows and host bytes, the engine's prompt tokens, set-up
# seconds, the routed KAN MoE's rows and grouped launches
PORT_ONLY_SERIES = {
    "runtime.rows{kind=real}", "runtime.rows{kind=pad}", "runtime.h2d_bytes",
    "serve.prompt_tokens{kind=real}", "serve.prompt_tokens{kind=pad}",
    "setup.seconds{phase=quantize}", "setup.seconds{phase=deploy}",
    "setup.seconds{phase=kernel_build}",
    "moe.rows{kind=routed}", "moe.rows{kind=shared}", "moe.busiest_rows",
    "moe.grouped_launches",
}


@pytest.fixture(scope="module")
def kan_setup():
    cfg = smoke_config("qwen2.5-14b").kan_variant()
    return cfg, init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")


@pytest.fixture(scope="module")
def float_setup():
    cfg = smoke_config("qwen2.5-14b")
    return cfg, init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")


@pytest.fixture(scope="module")
def converted():
    jcfg = j_smoke("qwen2.5-14b").kan_variant()
    cfg = smoke_config("qwen2.5-14b").kan_variant()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture
def obs_on():
    """Enable recording for one test; leave the process as it was found."""
    obs.REGISTRY.reset()
    obs.enable()
    yield
    obs.disable()
    obs.REGISTRY.reset()


def make_reqs(cfg, n=2, plen=5, max_new=3, seed=42, req_cls=Request, **kw):
    rng = np.random.default_rng(seed)
    return [req_cls(rid=rid, prompt=rng.integers(3, cfg.vocab_size,
                                                 plen).tolist(),
                    max_new_tokens=max_new, **kw)
            for rid in range(n)]


def engine(params, cfg, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 32)
    return ServeEngine(params, cfg, device="cpu", **kw)


# -- metrics registry ---------------------------------------------------------


def test_registry_instruments_and_labels(obs_on):
    r = MetricsRegistry()
    r.counter("c").inc()
    r.counter("c").inc(2)
    r.counter("d").inc(backend="fused")
    r.gauge("g").set(7.5)
    r.histogram("h", edges=(1.0, 2.0, 4.0)).observe(1.5)
    snap = r.snapshot()["metrics"]
    assert snap["c"] == {"kind": "counter", "value": 3}
    assert snap["d{backend=fused}"]["value"] == 1
    assert snap["g"]["value"] == 7.5
    h = snap["h"]["value"]
    # fixed edges, value 1.5 lands in the (1, 2] bucket
    assert h["edges"] == [1.0, 2.0, 4.0]
    assert h["counts"] == [0, 1, 0, 0] and h["count"] == 1 and h["sum"] == 1.5
    # get-or-create: same name -> same instrument; kind mismatch refuses
    assert r.counter("c") is r.counter("c")
    with pytest.raises(ValueError, match="already registered"):
        r.gauge("c")


def test_disabled_recording_is_a_noop():
    obs.disable()
    r = MetricsRegistry()
    r.counter("c").inc()
    r.gauge("g").set(1.0)
    r.histogram("h").observe(0.5)
    assert r.snapshot()["metrics"] == {}
    r.counter("c").labels(backend="ref").inc()
    assert r.snapshot()["metrics"] == {}


def test_histogram_rejects_unsorted_edges(obs_on):
    with pytest.raises(ValueError, match="strictly increase"):
        MetricsRegistry().histogram("h", edges=(2.0, 1.0))


def test_collectors_feed_snapshots_and_survive_reset(obs_on):
    r = MetricsRegistry()

    def fn():
        return {"pool.depth": 4, ("disp.count", (("backend", "ref"),)): 9}

    r.register_collector(fn)
    snap = r.snapshot()["metrics"]
    assert snap["pool.depth"] == {"kind": "gauge", "value": 4}
    assert snap["disp.count{backend=ref}"]["value"] == 9
    r.reset()  # collectors survive a plain reset (import-time registrations)
    assert r.snapshot()["metrics"]["pool.depth"]["value"] == 4
    r.unregister_collector(fn)
    assert r.snapshot()["metrics"] == {}


def test_plan_cache_collector_registered_on_global_registry(obs_on):
    snap = obs.REGISTRY.snapshot()["metrics"]
    for k in ("plan_cache.hits", "plan_cache.misses", "plan_cache.traces",
              "plan_cache.entries"):
        assert k in snap and snap[k]["kind"] == "gauge"
    # the port counts builds; they are exported as plan_cache.traces
    assert snap["plan_cache.traces"]["value"] == runtime.cache_stats()["builds"]


# -- exposition ---------------------------------------------------------------


def test_prometheus_text_round_trips_strict_parser(obs_on):
    r = MetricsRegistry()
    r.counter("serve.tokens").inc(12)
    r.counter("runtime.backend_dispatch").inc(3, backend="fused")
    r.histogram("serve.ttft_s", edges=(0.1, 1.0)).observe(0.05)
    r.histogram("serve.ttft_s", edges=(0.1, 1.0)).observe(5.0)
    text = obs.prometheus_text(r)
    parsed = obs.parse_prometheus_text(text)
    assert parsed["serve_tokens"] == 12
    assert parsed['runtime_backend_dispatch{backend="fused"}'] == 3
    # cumulative buckets: 0.05 <= 0.1; 5.0 overflows to +Inf only
    assert parsed['serve_ttft_s_bucket{le="0.1"}'] == 1
    assert parsed['serve_ttft_s_bucket{le="1"}'] == 1
    assert parsed['serve_ttft_s_bucket{le="+Inf"}'] == 2
    assert parsed["serve_ttft_s_count"] == 2
    assert parsed["serve_ttft_s_sum"] == pytest.approx(5.05)
    with pytest.raises(ValueError, match="not a valid prometheus sample"):
        obs.parse_prometheus_text("this is { not a sample\n")


def test_dump_metrics_json_and_prom(tmp_path, obs_on):
    obs.REGISTRY.counter("serve.tokens").inc(5)
    pj, pp = tmp_path / "m.json", tmp_path / "m.prom"
    obs.dump_metrics(pj)
    obs.dump_metrics(pp)
    assert json.loads(pj.read_text())["metrics"]["serve.tokens"]["value"] == 5
    assert obs.parse_prometheus_text(pp.read_text())["serve_tokens"] == 5


def test_metrics_http_server_serves_both_formats(obs_on):
    obs.REGISTRY.counter("serve.tokens").inc(7)
    srv = obs.start_metrics_server(0)  # a free port on 127.0.0.1
    try:
        base = f"http://127.0.0.1:{srv.server_port}"
        text = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert obs.parse_prometheus_text(text)["serve_tokens"] == 7
        snap = json.loads(
            urllib.request.urlopen(f"{base}/metrics.json").read())
        assert snap["metrics"]["serve.tokens"]["value"] == 7
    finally:
        srv.shutdown()


# -- structured logging -------------------------------------------------------


def test_logger_level_filtering_and_formatting(monkeypatch):
    lines = []
    lg = obs.Logger("sched", sink=lines.append, level="info")
    lg.debug("dropped", rid=1)
    lg.info("request done", rid=3, latency_s=0.0421)
    lg.warning("backpressure", queued=4)
    assert lines == [
        "sched: request done rid=3 latency_s=0.0421",
        "sched: [warning] backpressure queued=4",
    ]
    # level=None re-reads REPRO_LOG_LEVEL per record
    lines.clear()
    envlg = obs.Logger("s", sink=lines.append)
    monkeypatch.setenv(obs.ENV_LOG_LEVEL_VAR, "error")
    envlg.info("hidden")
    monkeypatch.setenv(obs.ENV_LOG_LEVEL_VAR, "debug")
    envlg.debug("shown")
    assert lines == ["s: [debug] shown"]


def test_as_logger_back_compat_paths():
    # bare callable: DEBUG threshold, every record forwarded (legacy log=)
    got = []
    lg = obs.as_logger(got.append)
    lg.debug("admitted request", rid=0)
    lg("request done", rid=0)        # __call__ keeps the old lambda shape
    assert got == ["[debug] admitted request rid=0", "request done rid=0"]
    # None -> the named process logger; Logger -> itself
    assert obs.as_logger(None, "x") is obs.get_logger("x")
    assert obs.as_logger(lg) is lg
    with pytest.raises(TypeError):
        obs.as_logger(42)


def test_scheduler_log_lambda_receives_every_line(float_setup):
    """The port's existing ``Scheduler(log=callable)`` callers keep every
    per-request line (the bare-callable path)."""
    cfg, params = float_setup
    got = []
    sched = Scheduler(engine(params, cfg), log=got.append)
    for r in make_reqs(cfg, n=1, max_new=2):
        sched.submit(r)
    sched.run_until_idle()
    assert len(got) == 2
    assert got[0] == "[debug] admitted request rid=0 queued=0"
    assert got[1].startswith("[debug] request done rid=0 tokens=2")


# -- tracer -------------------------------------------------------------------


def test_tracer_records_events_spans_and_trims():
    clk = ManualClock()
    tr = obs.Tracer(clock=clk.now, max_records=3)
    root = tr.begin("request", rid=5)
    clk.advance(1.0)
    tr.event("first_token", parent=root)
    child = tr.begin("decode", parent=root)
    clk.advance(0.5)
    tr.end(child, tokens=2)
    tr.end(root, status="done")
    with pytest.raises(ValueError, match="already ended"):
        tr.end(root)
    recs = tr.records()
    assert len(recs) == 3 and tr.dropped == 0
    assert [r["id"] for r in recs] == [0, 1, 2]  # sequence-number ids
    ev = next(r for r in recs if r["type"] == "event")
    assert ev["rid"] == 5 and ev["t0"] == 1.0  # rid inherits from parent
    # past the cap the oldest CLOSED record is dropped; export notes it
    tr.event("extra")
    assert tr.dropped == 1
    assert [r["name"] for r in tr.records()] == [
        "first_token", "decode", "extra"]


def _serve_traced(params, cfg, backend, path):
    """One deterministic 2-request workload (one future arrival) under
    ManualClock, traced; exports JSONL to ``path``."""
    clock = ManualClock()
    eng = engine(params, cfg, kan_deploy=True, kan_backend=backend)
    sched = Scheduler(eng, clock=clock, trace=True)
    reqs = make_reqs(cfg, n=2, max_new=3)
    reqs[1].arrival_s = 2.5
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    sched.tracer.export_jsonl(path)
    return {r.rid: r.output for r in sched.finished}, sched


def test_trace_jsonl_byte_identical_across_runs(kan_setup, tmp_path):
    cfg, params = kan_setup
    out1, _ = _serve_traced(params, cfg, "fused", tmp_path / "a.jsonl")
    out2, _ = _serve_traced(params, cfg, "fused", tmp_path / "b.jsonl")
    assert out1 == out2
    a, b = (tmp_path / "a.jsonl").read_bytes(), \
        (tmp_path / "b.jsonl").read_bytes()
    assert a == b and a  # identical and non-empty


def test_trace_skeleton_identical_across_backends(kan_setup, tmp_path):
    """ref and fused serve the same schedule -> the same span tree (ids,
    parents, rids, ManualClock timestamps); attrs may differ."""
    cfg, params = kan_setup
    out_r, sch_r = _serve_traced(params, cfg, "ref", tmp_path / "r.jsonl")
    out_f, sch_f = _serve_traced(params, cfg, "fused", tmp_path / "f.jsonl")
    assert out_r == out_f
    sk_r, sk_f = sch_r.tracer.skeleton(), sch_f.tracer.skeleton()
    assert sk_r == sk_f and len(sk_r) > 0


def test_trace_span_taxonomy_complete_timeline(float_setup):
    """A served request leaves the whole span tree: request > queued /
    prefill / decode spans (all closed) and a first_token event."""
    cfg, params = float_setup
    clock = ManualClock()
    sched = Scheduler(engine(params, cfg), clock=clock, trace=True)
    for r in make_reqs(cfg, n=1, max_new=3):
        sched.submit(r)
    sched.run_until_idle()
    by_name = {}
    for r in sched.tracer.records():
        by_name.setdefault(r["name"], []).append(r)
    for name in ("request", "queued", "prefill", "decode"):
        (span,) = by_name[name]
        assert span["type"] == "span" and span["t1"] is not None
        assert span["rid"] == 0
    (ft,) = by_name["first_token"]
    assert ft["type"] == "event" and ft["parent"] == by_name["request"][0]["id"]
    assert by_name["request"][0]["attrs"]["status"] == "done"
    assert by_name["decode"][0]["attrs"]["tokens"] == 3
    # expired-while-queued requests close their tree too
    sched2 = Scheduler(engine(params, cfg, slots=1), clock=clock, trace=True)
    (rq,) = make_reqs(cfg, n=1)
    rq.deadline_s = 0.5
    sched2.submit(rq)
    clock.advance(1.0)
    sched2.step()
    (root,) = [r for r in sched2.tracer.records() if r["name"] == "request"]
    assert root["attrs"]["status"] == "expired" and root["t1"] is not None


def test_chrome_export_shape(float_setup, tmp_path):
    cfg, params = float_setup
    clock = ManualClock()
    sched = Scheduler(engine(params, cfg), clock=clock, trace=True)
    for r in make_reqs(cfg, n=1, max_new=2):
        sched.submit(r)
    sched.run_until_idle()
    path = tmp_path / "t.json"
    sched.tracer.export_chrome(path)
    evs = json.loads(path.read_text())["traceEvents"]
    assert {e["ph"] for e in evs} <= {"X", "i"}
    assert all(e["tid"] == 0 for e in evs)  # one timeline row per request


def test_profile_scope_is_a_record_function_range_only_when_enabled():
    """Off (the default): a null context.  On: a torch.profiler range
    that a profiler run records under its name."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    assert not obs.profiler_annotations_enabled()
    assert isinstance(obs.profile_scope("serve.decode_step"),
                      contextlib.nullcontext)
    obs.enable_profiler_annotations()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.profile_scope("serve.decode_step"):
                torch.ones(4).sum()
    finally:
        obs.disable_profiler_annotations()
    assert "serve.decode_step" in {e.key for e in prof.key_averages()}


# -- end to end: bit-identity + metrics coverage ------------------------------


def test_greedy_streams_bit_identical_with_obs_enabled(float_setup):
    """Observability on (metrics + tracing + profiler ranges) does not
    change a single emitted token."""
    cfg, params = float_setup
    baseline = {r.rid: r.output for r in engine(params, cfg).run(
        make_reqs(cfg))}
    obs.enable()
    obs.enable_profiler_annotations()
    try:
        sched = Scheduler(engine(params, cfg), trace=True)
        for r in make_reqs(cfg):
            sched.submit(r)
        sched.run_until_idle()
        assert {r.rid: r.output for r in sched.finished} == baseline
    finally:
        obs.disable()
        obs.disable_profiler_annotations()
        obs.REGISTRY.reset()


def test_served_workload_covers_documented_metric_names(kan_setup, obs_on):
    """A served request on a paged KAN engine populates the documented
    dotted names across the subsystems (the acceptance snapshot)."""
    cfg, params = kan_setup
    runtime.reset_dispatch_counts()
    eng = engine(params, cfg, kan_deploy=True, kan_backend="ref",
                 kv_block_size=8)
    sched = Scheduler(eng)
    for r in make_reqs(cfg, n=2, max_new=2):
        sched.submit(r)
    sched.run_until_idle()
    snap = obs.REGISTRY.snapshot()["metrics"]
    assert snap["serve.submitted"]["value"] == 2
    assert snap["serve.completed"]["value"] == 2
    assert snap["serve.tokens"]["value"] == sched.stats()["tokens"]
    assert snap["serve.ttft_s"]["kind"] == "histogram"
    assert snap["serve.ttft_s"]["value"]["count"] == 2
    assert "kv.blocks_in_use" in snap and "kv.prefix_hits" in snap
    assert "plan_cache.hits" in snap
    assert snap["runtime.backend_dispatch{backend=ref}"]["value"] > 0
    obs.parse_prometheus_text(obs.prometheus_text())


def test_spec_round_metrics_and_verify_span_names(kan_setup, obs_on):
    """A speculative engine feeds the serve.spec.* series, and its rounds
    run under the reference's profiler range names."""
    from torch.profiler import ProfilerActivity, profile

    cfg, params = kan_setup
    eng = engine(params, cfg, kan_deploy=True, kv_block_size=8,
                 spec_decode=2)
    sched = Scheduler(eng)
    for r in make_reqs(cfg, n=2, max_new=4):
        sched.submit(r)
    obs.enable_profiler_annotations()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sched.run_until_idle()
    finally:
        obs.disable_profiler_annotations()
    snap = obs.REGISTRY.snapshot()["metrics"]
    st = sched.stats()["spec"]
    assert snap["serve.spec.drafted"]["value"] == st["drafted"] > 0
    assert snap["serve.spec.accepted"]["value"] == st["accepted"]
    assert snap["serve.spec.draft_s"]["value"]["count"] == st["rounds"]
    assert snap["serve.spec.verify_s"]["value"]["count"] == st["rounds"]
    keys = {e.key for e in prof.key_averages()}
    for name in ("serve.prefill_chunk", "serve.draft_prefill", "serve.draft",
                 "serve.verify", "kan_spline.fused"):
        assert name in keys, (name, sorted(k for k in keys if "." in k))


# -- the port against the reference -------------------------------------------


def _both_traced(converted, backends=("pallas", "fused"), kv=None):
    """The same ManualClock schedule (one future arrival) through both
    packages' engines; returns their (streams, scheduler) pairs."""
    jcfg, cfg, jp, tp = converted
    kw = {} if kv is None else {"kv_block_size": kv}
    out = []
    for eng_cls, sched_cls, clock_cls, req_cls, p, c, backend, extra in (
            (JServeEngine, JScheduler, JManualClock, JRequest, jp, jcfg,
             backends[0], {}),
            (ServeEngine, Scheduler, ManualClock, Request, tp, cfg,
             backends[1], {"device": "cpu"})):
        eng = eng_cls(p, c, slots=2, max_len=32, kan_deploy=True,
                      kan_backend=backend, **kw, **extra)
        sched = sched_cls(eng, clock=clock_cls(), trace=True)
        reqs = make_reqs(cfg, n=3, max_new=3, req_cls=req_cls)
        reqs[2].arrival_s = 2.5
        for r in reqs:
            sched.submit(r)
        sched.run_until_idle()
        out.append(({r.rid: list(r.output) for r in sched.finished}, sched))
    return out


@pytest.mark.parametrize("kv", [None, 8])
def test_trace_skeleton_equals_reference(converted, kv):
    (j_out, j_sched), (t_out, t_sched) = _both_traced(converted, kv=kv)
    assert {r: len(o) for r, o in j_out.items()} == \
        {r: len(o) for r, o in t_out.items()}
    assert t_sched.tracer.skeleton() == j_sched.tracer.skeleton()
    assert [(r["name"], r["type"]) for r in t_sched.tracer.records()] == \
        [(r["name"], r["type"]) for r in j_sched.tracer.records()]


def test_series_names_equal_reference(converted):
    """One served workload (paged, fused / pallas) in each package leaves
    the same series names in its registry, the dispatch label mapped,
    besides the port's own series (``PORT_ONLY_SERIES``)."""
    j_obs.REGISTRY.reset()
    obs.REGISTRY.reset()
    j_runtime.reset_dispatch_counts()
    runtime.reset_dispatch_counts()
    j_obs.enable()
    obs.enable()
    try:
        _both_traced(converted, kv=8)
        j_names = {LABEL_ALIASES.get(k, k)
                   for k in j_obs.REGISTRY.snapshot()["metrics"]}
        t_names = set(obs.REGISTRY.snapshot()["metrics"])
    finally:
        j_obs.disable()
        obs.disable()
        j_obs.REGISTRY.reset()
        obs.REGISTRY.reset()
    assert PORT_ONLY_SERIES <= t_names
    assert not PORT_ONLY_SERIES & j_names
    assert t_names - PORT_ONLY_SERIES == j_names, (
        (t_names - PORT_ONLY_SERIES) ^ j_names)
    assert "runtime.backend_dispatch{backend=fused}" in t_names


def test_port_prometheus_text_parses_with_reference_parser(converted,
                                                           obs_on):
    _both_traced(converted, kv=8)
    text = obs.prometheus_text()
    parsed = j_obs.parse_prometheus_text(text)
    assert parsed == obs.parse_prometheus_text(text)
    assert parsed["serve_completed"] == 3
    assert parsed['runtime_backend_dispatch{backend="fused"}'] > 0
