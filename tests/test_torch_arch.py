"""The sliding-window and MoE decoders (gemma2, mixtral, olmoe) and the
dense llama3 and phi3 in the port vs the reference on the same weights.

Weights are drawn by the reference (``init_params``, ``init_moe``) and
carried over with ``repro_torch.convert.lm_params_from_numpy``; tokens and
activations come from numpy seeds.  Smoke sizes (``smoke_config``), f32
unless a test says bf16; phi3 keeps its published ``head_pad_multiple=16``
(4 / 2 heads padded to 16 / 16).  Tolerances:

  * logits (forward, prefill, decode): ``1e-4 * max|logit| + 1e-5``, as in
    ``test_torch_lm.py`` (f32 sums in another order over a few layers);
  * ``loss_fn``: the loss within 1e-5, each gradient leaf within
    ``1e-5 * max|g_ref| + 1e-6`` of ``jax.value_and_grad``;
  * MoE in f32: expert ids, ranks and drops equal; outputs within 1e-5 *
    max|out| + 1e-6;
  * MoE in bf16 at top-8: the combine of a token's k expert outputs is
    bit-equal to the reference's scatter-add; the whole layer is within 4
    bf16 ulps of max|out|, because XLA's ``logistic`` (inside
    ``jax.nn.silu``) and PyTorch's ``silu`` differ by f32 ulps, which moves
    some bf16 roundings of silu(g) * h by one ulp;
  * served token streams: equal to the reference engine's.
"""

import contextlib
import dataclasses
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs.registry import smoke_config as j_smoke
from repro.core.kan_ffn_deploy import (
    quantize_kan_ffn_params_tree as j_quantize_tree,
)
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import train_state as JT
from repro_torch import convert, runtime
from repro_torch.configs import smoke_config
from repro_torch.core.kan_ffn_deploy import quantize_kan_ffn_params_tree
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.cardcheck import check_moe_layer
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import train_state as TT
from repro_torch.train.checkpoint import flatten
from repro_torch.train.optimizer import tree_leaves, tree_unflatten

torch.set_num_threads(1)

# name -> (arch, kan_variant, config overrides)
MODELS = {
    "gemma2": ("gemma2-27b", False, {}),
    "gemma2_kan": ("gemma2-27b", True, {}),
    "mixtral": ("mixtral-8x7b", False, {}),
    "olmoe": ("olmoe-1b-7b", False, {}),
    "llama3": ("llama3-405b", False, {}),
    "phi3": ("phi3-medium-14b", False, {"head_pad_multiple": 16}),
}
BF16_ULPS = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(a):
    return torch.from_numpy(np.array(a, copy=True))


def _configs(name, **kw):
    arch, kan, upd = MODELS[name]
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    if kan:
        jcfg, cfg = jcfg.kan_variant(), cfg.kan_variant()
    return (dataclasses.replace(jcfg, **upd, **kw),
            dataclasses.replace(cfg, **upd, **kw))


def _weights(name, seed=0, **kw):
    jcfg, cfg = _configs(name, **kw)
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                               for f in cfg.__dataclass_fields__})
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, convert.lm_params_from_numpy(_np(jp), device="cpu")


@pytest.fixture(scope="module")
def models():
    return {name: _weights(name) for name in MODELS}


def _logit_close(got, want):
    want = np.asarray(want)
    tol = 1e-4 * np.abs(want).max() + 1e-5
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol, (err, tol)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        3, cfg.vocab_size, (b, s)).astype(np.int32)


def _caches_close(tcache, jcache):
    for tg, jg in zip(tcache, jcache):
        assert set(tg) == set(jg)
        for key in jg:
            for n in ("k", "v"):
                np.testing.assert_allclose(tg[key][n].numpy(),
                                           np.asarray(jg[key][n]),
                                           rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------------------
# model entry points
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_reference(models, name):
    jcfg, cfg, jp, tp = models[name]
    toks = _tokens(cfg, 2, 12, seed=1)
    _logit_close(M.forward(tp, {"tokens": _torch(toks)}, cfg),
                 JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg))


def _prefill_and_decode(jp, tp, jcfg, cfg, toks, s0, max_len, steps):
    """Prefill ``toks[:, :s0]`` in both packages, then ``steps`` decode
    steps; logits compared at every step, caches at the end."""
    jl, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :s0])}, jcfg,
                            max_len=max_len)
    tl, tcache = M.prefill(tp, {"tokens": _torch(toks[:, :s0])}, cfg,
                           max_len=max_len)
    _logit_close(tl, jl)
    pos = np.full(toks.shape[0], s0, np.int32)
    for i in range(steps):
        jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(toks[:, s0 + i]),
                                    jnp.asarray(pos + i), jcfg)
        tl, tcache = M.decode_step(tp, tcache, _torch(toks[:, s0 + i]),
                                   _torch(pos + i), cfg)
        _logit_close(tl, jl)
    _caches_close(tcache, jcache)


@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_match_reference(models, name):
    """Prefill 9 tokens and decode 3 (local layers: a 32-slot ring, the
    smoke window, not yet wrapped)."""
    jcfg, cfg, jp, tp = models[name]
    _prefill_and_decode(jp, tp, jcfg, cfg, _tokens(cfg, 2, 12, 2), s0=9,
                        max_len=32, steps=3)


def test_quantized_gemma2_kan_variant_matches_reference(models):
    """The kan_variant() with every KAN-FFN block quantized: the port's
    "fused" backend (B1's plain version here) against the reference's
    Pallas pipeline in interpret mode, forward and prefill + 3 decodes."""
    jcfg, cfg, jp, tp = models["gemma2_kan"]
    jq, tq = j_quantize_tree(jp, jcfg), quantize_kan_ffn_params_tree(tp, cfg)
    toks = _tokens(cfg, 2, 12, seed=3)
    with jrt.use_backend("pallas"), runtime.use_backend("fused"):
        runtime.reset_dispatch_counts()
        _logit_close(M.forward(tq, {"tokens": _torch(toks)}, cfg),
                     JM.forward(jq, {"tokens": jnp.asarray(toks)}, jcfg))
        _prefill_and_decode(jq, tq, jcfg, cfg, toks, s0=9, max_len=32,
                            steps=3)
    assert runtime.dispatch_counts() == {"fused": 5 * cfg.num_layers}


@pytest.mark.parametrize("name,window,prompt", [("mixtral", 8, 4),
                                                ("gemma2", 8, 13)])
def test_window_cache_decodes_past_the_wrap(name, window, prompt):
    """A window of 8 (the reference's ``test_rolling_window_cache_exceeding_
    window``): prefill ``prompt`` tokens, then decode to position 23, 16
    steps past the window.  A 13-token prompt wraps the ring in prefill
    (the last 8 positions kept, rolled to slot = pos % 8).  Each step
    equals the reference's decode and the port's own forward (capacity 16:
    no MoE drop, so the forward computes the same function)."""
    jcfg, cfg, jp, tp = _weights(name, seed=1, window_size=window,
                                 moe_capacity_factor=16.0)
    toks = _tokens(cfg, 1, 24, seed=4)
    full = M.forward(tp, {"tokens": _torch(toks)}, cfg)
    jl, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :prompt])},
                            jcfg, max_len=24)
    tl, tcache = M.prefill(tp, {"tokens": _torch(toks[:, :prompt])}, cfg,
                           max_len=24)
    _logit_close(tl, jl)
    _caches_close(tcache, jcache)
    for i in range(prompt, 24):
        pos = np.array([i], np.int32)
        jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(toks[:, i]),
                                    jnp.asarray(pos), jcfg)
        tl, tcache = M.decode_step(tp, tcache, _torch(toks[:, i]),
                                   _torch(pos), cfg)
        _logit_close(tl, jl)
        _logit_close(tl, full[:, i])
    _caches_close(tcache, jcache)
    assert tcache[0]["l0_kv"]["k"].shape[2] == window


def test_ring_refuses_a_multi_token_decode(models):
    jcfg, cfg, jp, tp = models["mixtral"]
    _, cache = M.prefill(tp, {"tokens": _torch(_tokens(cfg, 1, 4, 5))}, cfg,
                         max_len=32)
    attn = tp["decoder"][0]["l0_attn"]
    x = torch.zeros(1, 2, cfg.d_model)
    kv = {n: t[0] for n, t in cache[0]["l0_kv"].items()}
    with pytest.raises(ValueError, match="one token per step"):
        L.attention_decode({k: v[0] for k, v in attn.items()}, x, kv,
                           torch.tensor([4]), cfg, "local")


# ----------------------------------------------------------------------------
# training: loss_fn's value and gradients, AdamW steps
# ----------------------------------------------------------------------------


def _batch(cfg, seed, b=4, s=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("name", MODELS)
def test_loss_and_gradients_match_reference(models, name):
    """At the default capacity (MoE drops happen at 64 tokens): the
    gradients of dropped assignments are zero in both packages."""
    jcfg, cfg, jp, tp = models[name]
    batch = _batch(cfg, seed=6)
    with jrt.use_attn_backend("ref"):
        want, jgrads = jax.value_and_grad(JM.loss_fn)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    with runtime.use_attn_backend("ref"):
        loss = M.loss_fn(tree_unflatten(tp, leaves),
                         {k: _torch(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    loss = float(loss.detach())
    assert abs(loss - float(want)) <= 1e-5, (loss, float(want))
    ref = jax.tree.leaves(jgrads)
    got = flatten(tree_unflatten(tp, list(grads)))
    assert len(got) == len(ref)
    for i, (g, w) in enumerate(zip(got, ref)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-6, (i, err)


@pytest.mark.parametrize("name", MODELS)
def test_three_adamw_steps_lower_the_loss(models, name):
    """Three AdamW steps on one batch (``tests/test_arch_smoke.py``: lr
    3e-3, MoE capacity 8): the loss falls at every step, and each step's
    loss equals the reference's jitted train step's."""
    jcfg, cfg = _configs(name, optimizer="adamw", learning_rate=3e-3,
                         moe_capacity_factor=8.0)
    jst = JT.init_state(jax.random.PRNGKey(2), jcfg)
    tst = {"params": convert.lm_params_from_numpy(_np(jst["params"]),
                                                  device="cpu")}
    tst["opt"] = TT.make_optimizer(cfg).init(tst["params"])
    for k in ("step", "good_steps", "skipped_steps"):
        tst[k] = torch.zeros((), dtype=torch.int32)
    jstep, tstep = jax.jit(JT.make_train_step(jcfg)), TT.make_train_step(cfg)
    batch = _batch(cfg, seed=7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _torch(v) for k, v in batch.items()}
    losses = []
    for _ in range(3):
        with jrt.use_attn_backend("ref"):
            jst, jm = jstep(jst, jb)
        tst, tm = tstep(tst, tb)
        assert bool(tm["ok"])
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
        losses.append(float(tm["loss"]))
    assert losses[0] > losses[1] > losses[2], losses


# ----------------------------------------------------------------------------
# MoE units
# ----------------------------------------------------------------------------


def _moe_configs(e, k, dispatch, dtype="float32"):
    upd = dict(num_experts=e, num_experts_per_tok=k, moe_dispatch=dispatch,
               dtype=dtype)
    return (dataclasses.replace(j_smoke("olmoe-1b-7b"), **upd),
            dataclasses.replace(smoke_config("olmoe-1b-7b"), **upd))


def _moe_inputs(jcfg, seed, b=2, s=24):
    """The reference's init_moe weights and activations with a shared
    offset (every token leans to the same experts, so capacity drops)."""
    jp = JL.init_moe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, s, jcfg.d_model))
         + rng.normal(size=(jcfg.d_model,))).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = _torch(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16 if jcfg.dtype == "bfloat16" else torch.float32)
    return jp, convert.lm_params_from_numpy(_np(jp), device="cpu"), jx, tx


def _ref_route(jp, jx, jcfg):
    """The reference's routing (``repro.models.layers.moe``, its lines up
    to ``dest``) as numpy: expert ids, ranks and the capacity."""
    t = jx.shape[0] * jx.shape[1]
    e, k = jcfg.num_experts, jcfg.num_experts_per_tok
    logits = jx.reshape(t, -1).astype(jnp.float32) @ jp["router"]
    _, topi = jax.lax.top_k(logits, k)
    flat_e = topi.reshape(t * k)
    if jcfg.moe_dispatch == "sort":
        order = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        first = jnp.searchsorted(sorted_e, sorted_e, side="left")
        inv = jnp.zeros_like(order).at[order].set(jnp.arange(t * k))
        pos = (jnp.arange(t * k) - first)[inv]
    else:
        onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1,
                                  flat_e[:, None], axis=1)[:, 0]
    cap = int(max(1, math.ceil(t * k * jcfg.moe_capacity_factor / e)))
    return np.asarray(flat_e), np.asarray(pos), cap


@pytest.mark.parametrize("e,k", [(8, 2), (64, 8)])
@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
def test_moe_dispatch_matches_reference(dispatch, e, k):
    """Both dispatches at the default capacity 1.25, at mixtral's (8, 2)
    and olmoe's (64, 8) routing: the reference's expert ids and ranks, its
    drops (which occur), and its outputs."""
    jcfg, cfg = _moe_configs(e, k, dispatch)
    jp, tp, jx, tx = _moe_inputs(jcfg, seed=e)
    want_e, want_pos, cap = _ref_route(jp, jx, jcfg)
    flat_e, _, pos, tcap = L.moe_route(tp, tx.reshape(-1, cfg.d_model), cfg)
    assert tcap == cap
    np.testing.assert_array_equal(flat_e.numpy(), want_e)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    drops = int((want_pos >= cap).sum())
    assert drops > 0, "no capacity drop: the test would not see them"
    want = np.asarray(JL.moe(jp, jx, jcfg))
    got = L.moe(tp, tx, cfg).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max() + 1e-6
    print(f"{dispatch} E={e} k={k}: cap {cap}, {drops} of {want_e.size} "
          f"assignments dropped")


def test_moe_sort_equals_cumsum_in_the_port():
    out = {}
    for dispatch in ("sort", "cumsum"):
        jcfg, cfg = _moe_configs(64, 8, dispatch, dtype="bfloat16")
        _, tp, _, tx = _moe_inputs(jcfg, seed=3)
        route = L.moe_route(tp, tx.reshape(-1, cfg.d_model), cfg)
        out[dispatch] = (route, L.moe(tp, tx, cfg))
    (rs, ys), (rc, yc) = out["sort"], out["cumsum"]
    for a, b in zip(rs[:3], rc[:3]):
        assert torch.equal(a, b)
    assert torch.equal(ys, yc)


def test_moe_combine_is_the_reference_scatter_add_in_bf16():
    """A token's k = 8 gated expert outputs summed in index order in bf16:
    bit-equal to the reference's ``.at[tok_id].add``."""
    t, k, d = 96, 8, 64
    c = np.random.default_rng(8).normal(size=(t * k, d)).astype(np.float32)
    jc = jnp.asarray(c).astype(jnp.bfloat16)
    want = jnp.zeros((t, d), jnp.bfloat16).at[jnp.repeat(jnp.arange(t), k)] \
        .add(jc)
    got = L.moe_combine(_torch(np.asarray(jc.astype(jnp.float32)))
                        .to(torch.bfloat16).reshape(t, k, d), torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_moe_bf16_top8_matches_reference():
    """olmoe's routing (64 experts, top-8) in bf16: routing equal, outputs
    within 4 bf16 ulps of max|out| (the measured difference is printed;
    see the module docstring for where it comes from)."""
    jcfg, cfg = _moe_configs(64, 8, "cumsum", dtype="bfloat16")
    jp, tp, jx, tx = _moe_inputs(jcfg, seed=9)
    want_e, want_pos, _ = _ref_route(jp, jx, jcfg)
    flat_e, _, pos, _ = L.moe_route(tp, tx.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(flat_e.numpy(), want_e)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    want = np.asarray(JL.moe(jp, jx, jcfg).astype(jnp.float32))
    got = L.moe(tp, tx, cfg).float().numpy()
    top = np.abs(want).max()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    err = np.abs(got - want).max()
    print(f"bf16 top-8: max |port - reference| {err} = {err / ulp} ulps of "
          f"max|out| {top}; {int((got != want).sum())} of {got.size} differ")
    assert err <= BF16_ULPS * ulp


def test_moe_topk_ties_take_the_lower_index():
    """Equal router logits: the lower expert first, as ``lax.top_k`` (where
    ``torch.topk`` promises no order)."""
    jcfg, cfg = _moe_configs(8, 2, "sort")
    router = np.zeros((cfg.d_model, 8), np.float32)
    router[0] = [1.0, 2.0, 2.0, 0.5, 2.0, 1.0, 3.0, 3.0]
    x = np.zeros((3, cfg.d_model), np.float32)
    x[:, 0] = [1.0, 0.0, -1.0]          # ties at 3, all equal, at -1
    _, want = jax.lax.top_k(jnp.asarray(x @ router), 2)
    flat_e, gates, _, _ = L.moe_route({"router": _torch(router)}, _torch(x),
                                      cfg)
    np.testing.assert_array_equal(flat_e.numpy().reshape(3, 2),
                                  np.asarray(want))
    assert flat_e.tolist() == [6, 7, 0, 1, 3, 0]
    np.testing.assert_allclose(gates.numpy()[:4], 0.5)


def test_moe_gradients_reach_only_kept_assignments():
    """The dispatch differentiated: gradients within 1e-5 of
    ``jax.grad`` for every input; a token whose k assignments were all
    dropped gets no gradient through the layer."""
    jcfg, cfg = _moe_configs(8, 2, "sort")
    jp, tp, jx, tx = _moe_inputs(jcfg, seed=10, s=40)
    dy = np.random.default_rng(10).normal(size=jx.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(JL.moe(p, x, jcfg) * dy)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
    x = tx.detach().requires_grad_()
    (L.moe(leaves, x, cfg) * _torch(dy)).sum().backward()
    for key in leaves:
        w = np.asarray(jg_p[key])
        err = np.abs(leaves[key].grad.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-6, (key, err)
    w = np.asarray(jg_x)
    assert np.abs(x.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max() + 1e-6
    _, pos, cap = _ref_route(jp, jx, jcfg)
    dropped = (pos.reshape(-1, cfg.num_experts_per_tok) >= cap).all(axis=1)
    assert dropped.any(), "no token lost all its assignments"
    assert not x.grad.reshape(-1, cfg.d_model)[_torch(dropped)].any()


@pytest.mark.parametrize("name", ["mixtral", "olmoe"])
def test_moe_card_check_runs_on_the_cpu(name):
    """``models.cardcheck.check_moe_layer`` (phase 10 of ``chip_smoke.py``)
    with both copies on the CPU: equal routing, no excuse, exact outputs."""
    cfg = dataclasses.replace(_configs(name)[1], dtype="bfloat16")
    st = check_moe_layer("cpu", cfg, tokens=64)
    assert st["flipped"] == st["displaced"] == 0 and st["max_abs_err"] == 0
    assert st["cap"] == L.moe_capacity(64, cfg)


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------


def _run(engine_cls, req_cls, params, cfg, prompts, max_new=6, **kw):
    eng = engine_cls(params, cfg, slots=2, max_len=64, **kw)
    reqs = [req_cls(rid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    return eng, {r.rid: list(r.output) for r in eng.run(reqs)}


def _prompts(cfg, lens=(5, 40, 17)):
    """A 40-token prompt wraps a 32-slot ring in prefill and keeps
    wrapping it in decode."""
    rng = np.random.default_rng(11)
    return [rng.integers(3, cfg.vocab_size, n).tolist() for n in lens]


@pytest.mark.parametrize("name,kan_deploy", [("gemma2", False),
                                             ("gemma2_kan", True),
                                             ("mixtral", False),
                                             ("olmoe", False)])
def test_engine_streams_match_reference_engine(models, name, kan_deploy):
    """The contiguous engine (2 slots, max_len 64): window-sized ring
    caches spliced per slot; MoE routes every pooled decode row, idle
    slots included, against capacities from the pooled shapes, as the
    reference's engine does."""
    jcfg, cfg, jp, tp = models[name]
    prompts = _prompts(cfg)
    _, want = _run(JServeEngine, JRequest, jp, jcfg, prompts,
                   kan_deploy=kan_deploy)
    runtime.reset_attn_dispatch_counts()
    eng, got = _run(ServeEngine, Request, tp, cfg, prompts, device="cpu",
                    kan_deploy=kan_deploy)
    assert got == want
    st = eng.compile_stats()
    calls = st["prefill_calls"] + st["decode_traces"]
    assert runtime.attn_dispatch_counts() == {"flash": calls * cfg.num_layers}
    assert eng.prefill_buckets == (name == "olmoe")


@pytest.mark.parametrize("mode", [{"kv_block_size": 8},
                                  {"kv_block_size": 8, "prefill_chunk": 8}])
def test_paged_olmoe_streams_match_reference_engine(models, mode):
    jcfg, cfg, jp, tp = models["olmoe"]
    prompts = _prompts(cfg)
    _, want = _run(JServeEngine, JRequest, jp, jcfg, prompts, **mode)
    _, got = _run(ServeEngine, Request, tp, cfg, prompts, device="cpu",
                  **mode)
    assert got == want


def test_engine_refuses_to_page_a_window_decoder(models):
    _, cfg, _, tp = models["gemma2"]
    with pytest.raises(ValueError, match="pure global-attention"):
        ServeEngine(tp, cfg, kv_block_size=8, device="cpu")


@pytest.mark.parametrize("arch", ["gemma2-27b", "mixtral-8x7b",
                                  "olmoe-1b-7b"])
def test_serve_cli_serves_the_new_archs_on_the_cpu(arch):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["--arch", arch, "--requests", "2", "--slots", "2",
                        "--max-new", "3", "--device", "cpu"]
                       + (["--kan-ffn"] if arch == "gemma2-27b" else []))
    assert "served requests=2" in buf.getvalue(), buf.getvalue()


def test_train_cli_trains_a_moe_decoder_on_the_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loop, hist = train_cli.main(["--arch", "mixtral-8x7b", "--smoke",
                                     "--steps", "2", "--seq-len", "16",
                                     "--global-batch", "4", "--device", "cpu",
                                     "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 2 and all(math.isfinite(m["loss"]) for m in hist)
    assert "l0_moe" in loop.state["params"]["decoder"][0]


# ----------------------------------------------------------------------------
# what stays refused, and its label
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch,item", [("recurrentgemma-9b", "A7b"),
                                       ("mamba2-370m", "A7b"),
                                       ("whisper-base", "A7c"),
                                       ("pixtral-12b", "A7c")])
def test_refusals_cite_their_roadmap_items(arch, item):
    cfg = smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        M.init_params(gen, cfg, device="cpu")
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        serve_cli.main(["--arch", arch, "--device", "cpu"])
    if item == "A7c":
        with pytest.raises(NotImplementedError, match="ROADMAP A7c"):
            L.init_kv_cache(cfg, 1, 8, "cross")
