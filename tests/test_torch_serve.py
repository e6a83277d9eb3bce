"""The port's serving stack (engine + scheduler + paged pool) vs the
reference engine on the same converted weights, and its own invariants.

Greedy token streams of ``repro_torch.serve.ServeEngine.run`` are held to
the reference ``repro.serve.engine.ServeEngine.run`` on the smoke
``qwen2.5-14b`` ``kan_variant()`` (f32) converted through numpy: contiguous,
paged with prefix-cache hits, and paged with chunked prefill, each with the
KAN-FFN on its float path and deployed (``kan_deploy=True``: the port's
fused stream against the reference's fused stream, never fused against
float).  The port runs its default backends (kernels B1 and B2, whose
plain versions run on these CPU tensors); the reference its own defaults
off-TPU (Pallas interpret mode for the KAN-FFN, the "ref" attention).

A stream may differ only at a step where the reference's top-2 logit
margin is below ``TIE`` (1e-4): two backends that sum in another order
can pick either of two near-equal logits.  Such a step is counted and must
be the last step compared for that request (the streams then continue
from different tokens).
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as j_smoke
from repro.models import model as JM
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert, runtime
from repro_torch.configs import smoke_config
from repro_torch.dist import comm
from repro_torch.kernels import cuda
from repro_torch.launch import serve as cli
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import (
    ManualClock,
    QueueFull,
    Request,
    SamplingParams,
    Scheduler,
    ServeEngine,
)

torch.set_num_threads(1)
TIE = 1e-4
MODES = {
    "contiguous": {},
    "paged": {"kv_block_size": 8},
    "chunked": {"kv_block_size": 8, "prefill_chunk": 8},
}


@pytest.fixture(scope="module")
def setup():
    jcfg = j_smoke("qwen2.5-14b").kan_variant()
    cfg = smoke_config("qwen2.5-14b").kan_variant()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return jcfg, cfg, jp, tp


def _prompts(cfg, n=5, seed=42):
    """Mixed lengths; requests 1 and 3 share a 16-token prefix (two full
    blocks of 8), so paged engines get prefix-cache hits."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(3, cfg.vocab_size, 16).tolist()
    out = []
    for rid, plen in enumerate((6, 21, 9, 19, 13)[:n]):
        p = rng.integers(3, cfg.vocab_size, plen).tolist()
        if rid in (1, 3):
            p = shared + p[16:]
        out.append(p)
    return out


def _run(engine_cls, req_cls, params, cfg, prompts, max_new=5, **kw):
    eng = engine_cls(params, cfg, slots=2, max_len=48, **kw)
    reqs = [req_cls(rid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    return eng, {r.rid: list(r.output) for r in eng.run(reqs)}


def _ref_margins(jp, jcfg, prompt, tokens):
    """The reference's top-2 logit margin at each generated step, teacher
    forced on ``tokens`` (the reference's own stream)."""
    logits, cache = JM.prefill(jp, {"tokens": jnp.asarray([prompt])}, jcfg,
                               max_len=64)
    rows = [np.asarray(logits[0])]
    for i, tok in enumerate(tokens[:-1]):
        logits, cache = JM.decode_step(jp, cache, jnp.asarray([tok]),
                                       jnp.asarray([len(prompt) + i]), jcfg)
        rows.append(np.asarray(logits[0]))
    top2 = [np.sort(r)[-2:] for r in rows]
    return [float(t[1] - t[0]) for t in top2]


def _compare_streams(got, want, jp, jcfg, prompts) -> int:
    """Equal streams, up to tie steps (counted; each ends its request's
    comparison).  Returns the count of tie steps."""
    ties = 0
    assert set(got) == set(want)
    for rid in want:
        g, w = got[rid], want[rid]
        diff = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if diff is None:
            assert len(g) == len(w), (rid, g, w)
            continue
        margin = _ref_margins(jp, jcfg, prompts[rid], w)[diff]
        assert margin < TIE, (rid, diff, g, w, margin)
        ties += 1
    return ties


@pytest.mark.parametrize("kan_deploy", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_streams_match_reference_engine(setup, mode, kan_deploy):
    jcfg, cfg, jp, tp = setup
    prompts = _prompts(cfg)
    kw = dict(MODES[mode], kan_deploy=kan_deploy)
    _, want = _run(JServeEngine, JRequest, jp, jcfg, prompts, **kw)
    runtime.reset_dispatch_counts()
    runtime.reset_attn_dispatch_counts()
    eng, got = _run(ServeEngine, Request, tp, cfg, prompts, device="cpu", **kw)
    ties = _compare_streams(got, want, jp, jcfg, prompts)
    print(f"{mode} kan_deploy={kan_deploy}: tie steps {ties}")
    stats = eng.compile_stats()
    assert stats["attn_backend"] == "flash"
    calls = stats["prefill_calls"] + stats["decode_traces"]
    layers = cfg.num_layers
    assert runtime.attn_dispatch_counts() == {"flash": calls * layers}
    assert runtime.dispatch_counts() == (
        {"fused": calls * layers} if kan_deploy else {})
    if mode != "contiguous":
        assert stats["kv"]["prefix_hits"] >= 2, stats["kv"]
        eng.pool.check_consistent()


def test_failing_reference_config_float_and_fused(setup):
    """The requests of the reference's own failing
    ``test_serve_engine_kan_ffn_fused_path_matches_float_tokens``: the
    port's float stream equals the reference's float stream and its fused
    stream the reference's fused stream (never fused against float)."""
    jcfg, cfg, jp, tp = setup
    rng = jax.random.PRNGKey(42)
    prompts = []
    for _ in range(3):
        rng, k = jax.random.split(rng)
        prompts.append(jax.random.randint(k, (6,), 3, jcfg.vocab_size).tolist())
    out = {}
    for kan_deploy in (False, True):
        _, want = _run(JServeEngine, JRequest, jp, jcfg, prompts, max_new=4,
                       kan_deploy=kan_deploy)
        _, got = _run(ServeEngine, Request, tp, cfg, prompts, max_new=4,
                      kan_deploy=kan_deploy, device="cpu")
        assert _compare_streams(got, want, jp, jcfg, prompts) == 0
        out[kan_deploy] = got
    print(f"port float {out[False]} vs port fused {out[True]}")


@pytest.mark.parametrize("kan_deploy", [False, True])
def test_contiguous_paged_and_chunked_streams_equal_within_the_port(
        setup, kan_deploy):
    _, cfg, _, tp = setup
    prompts = _prompts(cfg)
    outs = {mode: _run(ServeEngine, Request, tp, cfg, prompts, device="cpu",
                       kan_deploy=kan_deploy, **kw)[1]
            for mode, kw in MODES.items()}
    assert outs["paged"] == outs["contiguous"]
    assert outs["chunked"] == outs["contiguous"]


def test_attention_backends_give_the_same_tokens(setup):
    _, cfg, _, tp = setup
    prompts = _prompts(cfg, n=3)
    outs = [_run(ServeEngine, Request, tp, cfg, prompts, device="cpu",
                 kan_deploy=True, attn_backend=b)[1] for b in ("ref", "flash")]
    assert outs[0] == outs[1]


class _FakeMesh:
    """A (data, model) mesh at rank 0, as much of it as
    ``models.model.place_params`` reads (no process group)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape):
        self.shape = shape

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None

    def __getitem__(self, axis):
        return self


def test_engine_refuses_what_is_not_ported(setup):
    _, cfg, _, tp = setup
    # mesh serving is ported (tests/test_torch_mesh.py), and so is a model
    # axis that divides the query heads (4) but not the KV heads (2): each
    # rank keeps one query head and both KV heads, and its cache holds the
    # one KV head its query head reads (served at (1,4) there)
    placed, layout = TM.place_params(tp, cfg, _FakeMesh((1, 4)))
    assert (layout.heads, layout.kv, layout.size) == (True, False, 4)
    attn = placed["decoder"][0]["l0_attn"]
    assert attn["wq"].shape[-2] == 1 and attn["wk"].shape[-2] == 2
    with comm.use_tp(layout):
        assert TL.local_kv_heads(cfg) == 1
    # speculative decoding is ported (tests/test_torch_spec.py): only its
    # inconsistent settings are refused
    with pytest.raises(ValueError, match="kan_deploy"):
        ServeEngine(tp, cfg, spec_decode=2, kv_block_size=8, device="cpu")
    with pytest.raises(ValueError):
        ServeEngine(tp, smoke_config("qwen2.5-14b"), kan_deploy=True,
                    device="cpu")
    with pytest.raises(ValueError):
        ServeEngine(tp, cfg, attn_backend="sdpa-magic", device="cpu")
    with pytest.raises(ValueError):
        ServeEngine(tp, cfg, kan_deploy=True, kan_backend="tpu-magic",
                    device="cpu")


def test_deadline_and_queue_limit(setup):
    _, cfg, _, tp = setup
    eng = ServeEngine(tp, cfg, slots=1, max_len=32, device="cpu")
    clock = ManualClock()
    sched = Scheduler(eng, max_queue=2, clock=clock)
    sched.submit(Request(rid=0, prompt=[5, 6, 7], max_new_tokens=3))
    sched.submit(Request(rid=1, prompt=[8, 9], max_new_tokens=2,
                         deadline_s=0.5))
    with pytest.raises(QueueFull):
        sched.submit(Request(rid=2, prompt=[4], max_new_tokens=2))
    sched.step()            # admits rid 0 (one slot); rid 1 waits
    clock.advance(1.0)      # rid 1 is now past its deadline
    done = sched.run_until_idle()
    st = sched.stats()
    assert {r.rid: r.status for r in done} == {0: "done", 1: "expired"}
    assert (st["completed"], st["expired"], st["rejected"]) == (1, 1, 1)
    assert [len(r.output) for r in done if r.rid == 0] == [3]


def test_sampled_streams_reproduce_under_one_seed(setup):
    _, cfg, _, tp = setup
    sp = SamplingParams(temperature=0.9, top_k=20, top_p=0.9, seed=7)

    def run(seed_params):
        eng = ServeEngine(tp, cfg, slots=2, max_len=32, device="cpu")
        reqs = [Request(rid=i, prompt=[3 + i, 9, 11], max_new_tokens=6,
                        sampling=seed_params) for i in range(3)]
        streamed = {}
        sched = Scheduler(eng)
        for r in reqs:
            sched.submit(r, on_token=lambda r, t: streamed.setdefault(
                r.rid, []).append(t))
        done = sched.run_until_idle()
        outs = {r.rid: list(r.output) for r in done}
        assert outs == streamed
        return outs

    a, b = run(sp), run(sp)
    assert a == b
    c = run(SamplingParams(temperature=0.9, top_k=20, top_p=0.9, seed=8))
    assert c != a


def test_cli_serves_at_smoke_size_on_the_cpu(setup):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--arch", "qwen2.5-14b", "--kan-ffn", "--requests", "3",
                  "--slots", "2", "--max-new", "3", "--kv-block-size", "8",
                  "--prefill-chunk", "8", "--device", "cpu"])
    out = buf.getvalue()
    assert "served requests=3" in out, out
    assert "attn_backend=flash" in out and "kan_backend=fused" in out, out
    # every reference flag is ported: the list of those that waited is gone
    assert not hasattr(cli, "NOT_PORTED")
    with pytest.raises(SystemExit, match="unknown mesh axis"):
        cli.main(["--arch", "qwen2.5-14b", "--mesh", "1", "--device", "cpu"])


def test_cli_spec_decode_trace_and_metrics_on_the_cpu(setup, tmp_path):
    """The seven flags the obs and spec slice ported, in one CPU run:
    --spec-decode / --draft-spec serve through the drafter, --trace-out
    writes the span records, --metrics-dump both snapshot formats,
    --metrics-port serves /metrics while it runs, --log-level and
    --stats-interval drive the structured logger."""
    from repro_torch import obs

    trace, prom, js = (tmp_path / n for n in ("t.jsonl", "m.prom", "m.json"))
    buf = io.StringIO()
    obs.REGISTRY.reset()  # count this run's requests alone
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["--arch", "qwen2.5-14b", "--kan-ffn", "--requests", "3",
                      "--slots", "2", "--max-new", "4", "--kv-block-size",
                      "8", "--spec-decode", "2", "--draft-spec", "grid=4",
                      "--trace-out", str(trace), "--metrics-dump", str(prom),
                      "--metrics-dump", str(js), "--metrics-port", "0",
                      "--log-level", "info", "--stats-interval", "0",
                      "--device", "cpu"])
    finally:
        obs.disable()
        obs.REGISTRY.reset()
    out = buf.getvalue()
    assert "serve: spec decode k=2 draft_grid=4" in out, out
    assert "served requests=3" in out and "accept_rate=" in out, out
    assert "metrics server url=http://127.0.0.1:" in out, out
    assert "stats elapsed_s=" in out, out
    recs = [json.loads(ln) for ln in trace.read_text().splitlines()]
    assert sum(r["name"] == "request" for r in recs) == 3
    assert obs.parse_prometheus_text(prom.read_text())["serve_completed"] == 3
    assert json.loads(js.read_text())["metrics"]["serve.spec.drafted"][
        "value"] > 0
    for argv in (["--spec-decode", "2", "--kv-block-size", "8"],
                 ["--spec-decode", "2", "--kan-ffn"]):
        with pytest.raises(SystemExit, match="--spec-decode requires"):
            cli.main(["--arch", "qwen2.5-14b", *argv, "--device", "cpu"])


def test_cpu_run_launches_no_kernel(setup):
    """On CPU tensors every wrapper takes its plain version."""
    _, cfg, _, tp = setup
    before = cuda.launch_counts()
    _run(ServeEngine, Request, tp, cfg, _prompts(cfg, n=2), device="cpu",
         kan_deploy=True)
    assert cuda.launch_counts() == before
