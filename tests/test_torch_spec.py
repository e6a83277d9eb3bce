"""Speculative decoding in the port, after ``tests/test_spec_decode.py``
(all but its mesh case, which waits for ROADMAP A10), plus the port
against the reference.

The invariant held here on the CPU: greedy token streams under
``spec_decode=k`` equal plain decode (``spec_decode=0``) on the same
requests, for k in {2, 4}, on the ``ref``, ``fused`` and quiet ``acim``
backends; ``verify_step`` rows equal sequential ``decode_step`` rows bit
for bit (logits and the KV written back).  On the card the bf16 matmuls
over slots x (k+1) rows need not keep a row's bits, so ``chip_smoke.py``
measures that difference and gates the card's streams on it.

Across packages:
  * ``refit_layer_spec`` / ``extend_layer_grid`` against the JAX functions
    on the same numpy weights: within 1e-5 + 1e-5 relative (the reference
    solves ``lstsq`` in f32, the port applies ``pinv(new_b) @ old_b``
    formed in float64; measured differences are ~3e-6 at |c| ~2.5);
  * the port's spec stream against the reference's spec stream on
    weights converted through numpy, under ``test_torch_serve.py``'s
    ``TIE`` rule (a step may differ only where the reference's top-2
    logit margin is under 1e-4, and it ends that request's comparison).

The smoke ``qwen2.5-14b`` ``kan_variant()`` (f32) is the model
throughout; the port runs its default backends (kernels B1 and B2, whose
plain versions run on these CPU tensors).
"""

import dataclasses

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
from repro_torch.models import model as M
from repro_torch.runtime.executor import ACIMExecutor
from repro_torch.serve import (
    DraftModel,
    DraftSpec,
    Request,
    SamplingParams,
    Scheduler,
    ServeEngine,
)
from repro_torch.serve.kvpool import KVBlockPool

torch.set_num_threads(1)
TIE = 1e-4
PAGED = dict(kv_block_size=8, kv_blocks=32, prefill_chunk=8)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_smoke("qwen2.5-14b").kan_variant()
    cfg = smoke_config("qwen2.5-14b").kan_variant()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def quiet_acim():
    """The zero-noise acim executor under the name "acim-quiet" for this
    module only (it runs the same launches as "fused")."""
    runtime.register_executor(
        "acim-quiet", ACIMExecutor(cim=runtime.quiet_cim_config()))
    yield "acim-quiet"
    runtime.executor._EXECUTORS.pop("acim-quiet", None)


def make_prompts(cfg, n=3, seed=42):
    """Mixed lengths (different drafter prefill buckets, chunked engine
    prefill shapes), so rounds interleave prefills with spec rounds."""
    rng = np.random.default_rng(seed)
    return [rng.integers(3, cfg.vocab_size, 4 + 3 * rid).tolist()
            for rid in range(n)]


def make_reqs(cfg, max_new=6, req_cls=Request, prompts=None):
    return [req_cls(rid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts or make_prompts(cfg))]


def serve(params, cfg, k, backend=None, draft_spec=None, reqs=None):
    eng = ServeEngine(params, cfg, slots=2, max_len=32, kan_deploy=True,
                      kan_backend=backend, spec_decode=k,
                      draft_spec=draft_spec, device="cpu", **PAGED)
    out = {r.rid: r.output for r in eng.run(reqs or make_reqs(cfg))}
    return out, eng


# ---------------------------------------------------------------------------
# greedy streams under spec_decode=k equal plain decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ref", "fused", "acim-quiet"])
@pytest.mark.parametrize("k", [2, 4])
def test_spec_streams_equal_plain_decode_per_backend(setup, quiet_acim,
                                                     backend, k):
    _, cfg, _, tp = setup
    base, _ = serve(tp, cfg, 0, backend=backend)
    out, eng = serve(tp, cfg, k, backend=backend)
    assert out == base
    stats = eng.compile_stats()
    assert stats["verify_traces"] == 1  # one (slots, k+1) verify width
    assert stats["verify_calls"] > 0 and stats["decode_traces"] == 0
    assert stats["spec"]["k"] == k
    # the drafter deployed at the default halved grid on the same backend
    assert stats["spec"]["draft"]["kan_grid"] == max(2, cfg.kan_grid // 2)
    assert stats["spec"]["draft"]["kan_backend"] == backend


def test_spec_streams_equal_with_draft_spec_and_k1(setup):
    """A mismatched drafter (tiny grid, lower order, fewer bits, another
    backend) and the degenerate k=1 round still reproduce the baseline:
    acceptance, not drafting, decides every emitted token."""
    _, cfg, _, tp = setup
    base, _ = serve(tp, cfg, 0)
    for k, spec in ((1, None), (2, "grid=2,order=2,bits=6,backend=ref")):
        out, _ = serve(tp, cfg, k, draft_spec=spec)
        assert out == base, (k, spec)


# ---------------------------------------------------------------------------
# verify_step: row-for-row parity with sequential decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_verify_step_rows_match_sequential_decode(setup, backend):
    """One batched (B, S) verify forward == S sequential decode_steps, bit
    for bit on the logits AND on the KV written to the paged pool."""
    from repro_torch.core.kan_ffn_deploy import quantize_kan_ffn_params_tree

    _, cfg, _, tp = setup
    p = quantize_kan_ffn_params_tree(tp, cfg)
    b, s, bs, nb = 2, 4, 8, 9
    table = torch.tensor([[1, 2], [3, 4]])  # 2 blocks per slot
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        3, cfg.vocab_size, (b, s)))
    pos0 = torch.tensor([0, 3])  # unequal frontiers
    with runtime.use_backend(backend):
        cache = M.init_paged_cache(p, cfg, nb, bs)
        seq = []
        for j in range(s):
            logits, cache = M.decode_step(p, cache, tokens[:, j], pos0 + j,
                                          cfg, block_table=table)
            seq.append(logits)
        seq_cache = cache
        cache = M.init_paged_cache(p, cfg, nb, bs)
        ver, ver_cache = M.verify_step(p, cache, tokens, pos0, cfg, table)
    assert ver.shape == (b, s, cfg.vocab_size)
    for j in range(s):
        assert torch.equal(ver[:, j], seq[j]), j
    for g_seq, g_ver in zip(seq_cache, ver_cache):
        for key, kv in g_seq.items():
            for name in ("k", "v"):
                assert torch.equal(kv[name], g_ver[key][name]), (key, name)


# ---------------------------------------------------------------------------
# refit_layer_spec: against the reference, and at reduced G AND K
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid,order", [(4, 3), (4, 2), (2, 1), (16, 3)])
def test_refit_layer_spec_matches_reference(grid, order):
    from repro.core.asp_quant import ASPQuantSpec as JSpec
    from repro.core.kan_layer import extend_layer_grid as j_extend
    from repro.core.kan_layer import refit_layer_spec as j_refit
    from repro_torch.core.asp_quant import ASPQuantSpec
    from repro_torch.core.kan_layer import extend_layer_grid, refit_layer_spec

    rng = np.random.default_rng(grid * 10 + order)
    c = (rng.standard_normal((6, 11, 5)) * 0.1).astype(np.float32)
    wb = rng.standard_normal((6, 5)).astype(np.float32)
    old, new = dict(grid_size=8, order=3), dict(grid_size=grid, order=order)
    want = j_refit({"c": jnp.asarray(c), "w_b": jnp.asarray(wb)},
                   JSpec(**old), JSpec(**new))
    got = refit_layer_spec({"c": torch.from_numpy(c),
                            "w_b": torch.from_numpy(wb)},
                           ASPQuantSpec(**old), ASPQuantSpec(**new))
    assert got["c"].dtype == torch.float32
    np.testing.assert_allclose(got["c"].numpy(), np.asarray(want["c"]),
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(got["w_b"].numpy(), wb)
    if order == 3 and grid > 8:
        want = j_extend({"c": jnp.asarray(c), "w_b": jnp.asarray(wb)},
                        JSpec(**old), grid)
        got = extend_layer_grid({"c": torch.from_numpy(c),
                                 "w_b": torch.from_numpy(wb)},
                                ASPQuantSpec(**old), grid)
        np.testing.assert_allclose(got["c"].numpy(), np.asarray(want["c"]),
                                   rtol=1e-5, atol=1e-5)


def test_refit_reduced_grid_and_order(setup):
    from repro_torch.core.bspline import bspline_basis
    from repro_torch.core.kan_layer import KANSpec, param_count
    from repro_torch.models.layers import kan_ffn_hidden, kan_ffn_spec
    from repro_torch.serve.spec import refit_kan_ffn_params_tree

    _, cfg, _, tp = setup
    draft_cfg = dataclasses.replace(cfg, kan_grid=4, kan_order=2,
                                    kan_d_hidden=kan_ffn_hidden(cfg))
    old, new = kan_ffn_spec(cfg), kan_ffn_spec(draft_cfg)
    assert (new.grid_size, new.order) == (4, 2)
    assert (old.grid_size, old.order) == (cfg.kan_grid, cfg.kan_order)

    refit = refit_kan_ffn_params_tree(tp, cfg, draft_cfg)
    blk = tp["decoder"][0]["l0_ffn"]
    rblk = refit["decoder"][0]["l0_ffn"]
    # the basis shrinks from G+K to G'+K' columns; edge geometry unchanged
    assert blk["c1"].shape[-2] == old.grid_size + old.order
    assert rblk["c1"].shape[-2] == new.grid_size + new.order
    assert blk["c1"].shape[:-2] == rblk["c1"].shape[:-2]
    # w_b rides through the refit untouched, bit for bit
    assert torch.equal(blk["wb1"], rblk["wb1"])
    # deterministic: the same refit twice is bit-identical
    refit2 = refit_kan_ffn_params_tree(tp, cfg, draft_cfg)
    assert torch.equal(rblk["c1"], refit2["decoder"][0]["l0_ffn"]["c1"])
    # the least-squares fit of the SAME spline tracks it on the domain
    xs = torch.linspace(old.lo, old.hi, 64)
    ob = bspline_basis(xs, old.lo, old.hi, old.grid_size, old.order)
    nb = bspline_basis(xs, new.lo, new.hi, new.grid_size, new.order)
    f_old = torch.einsum("sn,fno->sfo", ob, blk["c1"][0])
    f_new = torch.einsum("sn,fno->sfo", nb, rblk["c1"][0])

    def rms(a):
        return float(torch.sqrt(torch.mean(a * a)))

    assert rms(f_old - f_new) < 0.5 * rms(f_old)

    # the paper's #Param convention shrinks with (G + K + 1)
    dims = (cfg.d_model, kan_ffn_hidden(cfg), cfg.d_model)
    n_t = param_count(KANSpec(dims=dims, grid_size=cfg.kan_grid,
                              order=cfg.kan_order))
    n_d = param_count(KANSpec(dims=dims, grid_size=4, order=2))
    assert n_d < n_t

    drafter = DraftModel(tp, cfg, DraftSpec(grid=4, order=2), slots=2,
                         max_len=32)
    d = drafter.describe()
    assert (d["kan_grid"], d["kan_order"]) == (4, 2)
    assert d["ffn_params_per_block"] == n_d
    # the drafter keeps the target's layer geometry (hidden width pinned)
    assert drafter.cfg.kan_d_hidden == kan_ffn_hidden(cfg)


def test_draft_deploys_without_rebuilding_target_plans(setup):
    """The drafter's reduced specs key SEPARATE plan-cache entries: after
    a spec-off warm-up, serving spec-on only builds new entries (every
    build is a new entry), and a replay builds nothing."""
    _, cfg, _, tp = setup
    runtime.reset_cache()
    serve(tp, cfg, 0)                          # warm the target's plans
    s0 = runtime.cache_stats()
    _, eng = serve(tp, cfg, 2, draft_spec="grid=4,order=2")
    s1 = runtime.cache_stats()
    d_builds = s1["builds"] - s0["builds"]
    d_entries = s1["entries"] - s0["entries"]
    assert d_entries > 0                       # the drafter added its plans
    assert d_builds == d_entries, (d_builds, d_entries)
    assert eng.compile_stats()["spec"]["draft"]["plan_entries"] == d_entries
    s2 = runtime.cache_stats()
    serve(tp, cfg, 2, draft_spec="grid=4,order=2")
    s3 = runtime.cache_stats()
    assert s3["builds"] == s2["builds"]
    assert s3["hits"] > s2["hits"]


# ---------------------------------------------------------------------------
# KV pool truncate: speculative rollback bookkeeping
# ---------------------------------------------------------------------------


def test_truncate_releases_whole_tail_blocks():
    pool = KVBlockPool(num_blocks=8, block_size=4)
    blocks = [pool.alloc() for _ in range(4)]  # covers 16 token positions
    keep = list(blocks)
    tail = pool.truncate(blocks, 9)            # ceil(9/4)=3 blocks stay
    assert blocks == keep[:3] and tail == keep[3:]
    assert pool.truncations == 1
    assert pool.blocks_in_use() == 3
    assert pool.truncate(blocks, 12) == []     # boundary: nothing to drop
    assert pool.truncate(blocks, 0) == keep[:3]
    assert pool.blocks_in_use() == 0
    with pytest.raises(ValueError):
        pool.truncate(blocks, -1)
    pool.check_consistent()
    assert pool.stats()["truncations"] == 4


def test_truncate_refuses_cached_prefix_blocks():
    pool = KVBlockPool(num_blocks=8, block_size=4)
    prompt = list(range(8))                    # two FULL published blocks
    blocks = [pool.alloc(), pool.alloc(), pool.alloc()]
    pool.publish_prefix(prompt, blocks[:2])
    with pytest.raises(ValueError, match="cached prefix"):
        pool.truncate(list(blocks), 4)         # would release published [1]
    tail = pool.truncate(blocks, 8)            # the request's own tail
    assert len(tail) == 1
    pool.check_consistent()


# ---------------------------------------------------------------------------
# scheduler metrics surface
# ---------------------------------------------------------------------------


def test_stats_tokens_per_round_and_spec_block(setup):
    _, cfg, _, tp = setup
    eng = ServeEngine(tp, cfg, slots=2, max_len=32, kan_deploy=True,
                      spec_decode=2, device="cpu", **PAGED)
    sched = Scheduler(eng)
    for r in make_reqs(cfg):
        sched.submit(r)
    sched.run_until_idle()
    s = sched.stats()
    sp = s["spec"]
    assert sp["k"] == 2 and sp["rounds"] > 0
    assert 0 < sp["drafted"] <= 2 * eng.slots * sp["rounds"]
    assert 0 <= sp["accepted"] <= sp["drafted"]
    assert 0.0 <= sp["accept_rate"] <= 1.0
    assert sp["draft_s"]["p50"] > 0 and sp["verify_s"]["p50"] > 0
    # accepted drafts make rounds emit > 1 token per active slot on
    # average (bounded by the k+1 rows a verify pass scores)
    assert 1.0 <= s["tokens_per_round"] <= 3.0
    # ITL is per EMITTED token: one gap per token after each first token
    assert s["itl_s"]["n"] == s["tokens"] - s["completed"]

    # spec off: the same surface degenerates exactly
    eng0 = ServeEngine(tp, cfg, slots=2, max_len=32, kan_deploy=True,
                       device="cpu", **PAGED)
    sched0 = Scheduler(eng0)
    for r in make_reqs(cfg):
        sched0.submit(r)
    sched0.run_until_idle()
    s0 = sched0.stats()
    assert s0["spec"] is None
    assert s0["tokens_per_round"] == 1.0
    assert s0["itl_s"]["n"] == s0["tokens"] - s0["completed"]


def test_spec_with_sampled_requests_emits_one_token_per_round(setup):
    """Sampled slots ride spec rounds but emit exactly one token from the
    verify row (the classic per-position draw), excluded from the
    accept-rate counters; their streams reproduce the spec-off sampler."""
    _, cfg, _, tp = setup
    sp = SamplingParams(temperature=0.9, top_k=16, seed=7)
    prompts = make_prompts(cfg, n=2, seed=43)

    def sampled(k):
        eng = ServeEngine(tp, cfg, slots=2, max_len=32, kan_deploy=True,
                          spec_decode=k, device="cpu", **PAGED)
        sched = Scheduler(eng)
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=4, sampling=sp)
                for i, p in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        sched.run_until_idle()
        return {r.rid: r.output for r in reqs}, sched.stats()

    base, _ = sampled(0)
    out, s = sampled(2)
    assert out == base
    assert s["spec"]["drafted"] == 0           # sampled slots never counted
    assert s["tokens_per_round"] == 1.0


# ---------------------------------------------------------------------------
# DraftSpec parsing / resolution; inconsistent engine kwargs
# ---------------------------------------------------------------------------


def test_draft_spec_parse_and_resolve(setup):
    _, cfg, _, _ = setup
    full = DraftSpec.parse("grid=4, order=2, bits=6, backend=ref")
    assert full == DraftSpec(grid=4, order=2, n_bits=6, backend="ref")
    assert DraftSpec.parse("n_bits=6") == DraftSpec(n_bits=6)
    assert DraftSpec.parse(None) == DraftSpec()
    assert DraftSpec.parse("") == DraftSpec()
    # defaults: halved grid (floored at 2), inherited order / bits
    g, o, b = DraftSpec().resolve(cfg)
    assert g == max(2, cfg.kan_grid // 2)
    assert (o, b) == (cfg.kan_order, cfg.kan_n_bits)
    tiny = dataclasses.replace(cfg, kan_grid=3)
    assert DraftSpec().resolve(tiny)[0] == 2
    with pytest.raises(ValueError, match="unknown"):
        DraftSpec.parse("grids=4")
    with pytest.raises(ValueError, match="key=value"):
        DraftSpec.parse("grid:4")
    with pytest.raises(ValueError, match=">= 1"):
        DraftSpec(grid=0).resolve(cfg)


def test_engine_rejects_inconsistent_spec_kwargs(setup):
    _, cfg, _, tp = setup
    with pytest.raises(ValueError, match="spec_decode"):
        ServeEngine(tp, cfg, slots=2, max_len=32, kan_deploy=True,
                    spec_decode=2, device="cpu")    # no paged KV
    with pytest.raises(ValueError, match="draft_spec"):
        ServeEngine(tp, cfg, slots=2, max_len=32, kan_deploy=True,
                    draft_spec="grid=4", device="cpu", **PAGED)  # spec off
    with pytest.raises(ValueError, match="kan_deploy"):
        ServeEngine(tp, cfg, slots=2, max_len=32, spec_decode=2,
                    device="cpu", **PAGED)          # float target
    with pytest.raises(ValueError, match=">= 0"):
        ServeEngine(tp, cfg, slots=2, max_len=32, kan_deploy=True,
                    spec_decode=-1, device="cpu", **PAGED)


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


def _ref_margins(jp, jcfg, prompt, tokens):
    """The reference's top-2 logit margin at each generated step, teacher
    forced on its own stream."""
    logits, cache = JM.prefill(jp, {"tokens": jnp.asarray([prompt])}, jcfg,
                               max_len=64)
    rows = [np.asarray(logits[0])]
    for i, tok in enumerate(tokens[:-1]):
        logits, cache = JM.decode_step(jp, cache, jnp.asarray([tok]),
                                       jnp.asarray([len(prompt) + i]), jcfg)
        rows.append(np.asarray(logits[0]))
    return [float(np.diff(np.sort(r)[-2:])[0]) for r in rows]


@pytest.mark.parametrize("k", [2, 4])
def test_spec_streams_match_reference_engine(setup, k):
    """The port's spec stream against the reference's spec stream (both
    engines paged and chunked, kan_deploy, the default drafter) on the same
    converted weights, under the TIE rule; the port's stream also equals
    its own k = 0 stream."""
    jcfg, cfg, jp, tp = setup
    prompts = make_prompts(cfg, n=3, seed=5)
    jeng = JServeEngine(jp, jcfg, slots=2, max_len=32, kan_deploy=True,
                        spec_decode=k, **PAGED)
    want = {r.rid: list(r.output)
            for r in jeng.run(make_reqs(cfg, req_cls=JRequest,
                                        prompts=prompts))}
    got, _ = serve(tp, cfg, k, reqs=make_reqs(cfg, prompts=prompts))
    base, _ = serve(tp, cfg, 0, reqs=make_reqs(cfg, prompts=prompts))
    assert got == base
    ties = 0
    for rid, w in want.items():
        g = got[rid]
        diff = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if diff is None:
            assert len(g) == len(w), (rid, g, w)
            continue
        margin = _ref_margins(jp, jcfg, prompts[rid], w)[diff]
        assert margin < TIE, (rid, diff, g, w, margin)
        ties += 1
    print(f"k={k}: tie steps {ties}")


# ---------------------------------------------------------------------------
# serve.cardcheck: the card's spec-vs-plain gate, run on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_verify_decode_delta_is_zero_on_the_cpu(setup, k):
    """The check ``chip_smoke.py`` runs on the card: on the CPU every
    verify row equals its sequential decode row bit for bit, and the
    engine's pool is left as it was."""
    from repro_torch.serve import cardcheck as sc

    _, cfg, _, tp = setup
    eng = ServeEngine(tp, cfg, slots=2, max_len=32, kan_deploy=True,
                      device="cpu", **PAGED)
    st = sc.verify_decode_delta(eng, make_prompts(cfg, n=2), k)
    assert st == {"max_abs_delta": 0.0, "rows": 2 * (k + 1),
                  "rows_bit_equal": 2 * (k + 1)}
    assert eng.pool.blocks_in_use() == 0 and eng._free_slots == [0, 1]
    eng.pool.check_consistent()


def test_spec_divergences_excuse_only_near_ties(setup):
    """Margins recorded on a plain run line up with its emitted tokens;
    a parted stream is excused only at a step whose plain margin is within
    twice the measured difference, and is returned for counting."""
    from repro_torch.serve import cardcheck as sc

    _, cfg, _, tp = setup
    eng = ServeEngine(tp, cfg, slots=2, max_len=32, kan_deploy=True,
                      device="cpu", **PAGED)
    margins = sc.record_step_margins(eng)
    base = {r.rid: list(r.output) for r in eng.run(make_reqs(cfg))}
    assert {r: len(m) for r, m in margins.items()} == \
        {r: len(o) for r, o in base.items()}
    assert all(m >= 0 for ms in margins.values() for m in ms)
    assert sc.spec_divergences(base, base, margins, 0.0) == []
    parted = {**base, 1: base[1][:2] + [base[1][2] + 1] + base[1][3:]}
    m = margins[1][2]
    assert sc.spec_divergences(base, parted, margins, m / 2) == [(1, 2, m)]
    with pytest.raises(AssertionError, match="exceeds twice"):
        sc.spec_divergences(base, parted, margins, m / 2.01)
    with pytest.raises(AssertionError, match="lengths"):
        sc.spec_divergences(base, {**base, 0: base[0][:-1]}, margins, 1.0)
