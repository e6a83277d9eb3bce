"""The recurrent decoders (recurrentgemma-9b's RG-LRU, mamba2-370m's SSD)
in the port vs the reference on the same weights.

Weights are drawn by the reference (``init_params``, ``init_rglru``,
``init_mamba2``) and carried over with
``repro_torch.convert.lm_params_from_numpy``; tokens and activations come
from numpy seeds.  The reference runs as its own tests run it (its KAN-FFN
through the Pallas pipeline in interpret mode, attention on "ref").
Tolerances:

  * ``_causal_conv1d`` in bf16: bit-equal (one rounding per product and
    per partial sum, in the reference's order);
  * ``_rglru_scan`` (a doubling scan) against ``lax.associative_scan``:
    within 1e-6 x max|h| (f32 products in another association);
  * one layer in bf16 (``rglru``, ``rglru_prefill``, its decode,
    ``_ssd_chunked``, ``mamba2`` prefill and decode): outputs and conv
    states within 2 bf16 ulps of their max|.|, f32 states within 1e-5 of
    their max|.| (bf16 projections round alike but for sums in another
    order);
  * models (smoke sizes, f32): logits within ``1e-4 * max|logit| + 1e-5``,
    the loss within 1e-5 and each gradient leaf within ``1e-5 *
    max|g_ref| + 1e-6``, as in ``test_torch_arch.py``;
  * served token streams: equal to the reference engine's.
"""

import contextlib
import dataclasses
import io
import math
import sys

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
from repro.launch import serve as j_serve_cli
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert, runtime
from repro_torch.configs import smoke_config
from repro_torch.core.kan_ffn_deploy import quantize_kan_ffn_params_tree
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.cardcheck import check_recurrent_layer
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.checkpoint import flatten
from repro_torch.train.optimizer import tree_leaves, tree_unflatten

torch.set_num_threads(1)

# name -> (arch, kan_variant)
MODELS = {
    "rgemma": ("recurrentgemma-9b", False),
    "rgemma_kan": ("recurrentgemma-9b", True),
    "mamba2": ("mamba2-370m", False),
}
ULPS = 2
STATE_REL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port(tree):
    """A reference tree (bf16 leaves by bit pattern) as CPU tensors."""
    return convert.lm_params_from_numpy(_np(tree), device="cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulp(top):
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def _bf16_close(got, want, ulps=ULPS):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    top = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= ulps * _ulp(top), (err / _ulp(top), "ulps of", top)


def _state_close(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= STATE_REL * np.abs(want).max()


def _states_close(tstate, jstate):
    assert set(tstate) == set(jstate)
    _bf16_close(tstate["conv"], jstate["conv"])
    for name in set(jstate) - {"conv"}:
        _state_close(tstate[name], jstate[name])


def _configs(name, **kw):
    arch, kan = MODELS[name]
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    if kan:
        jcfg, cfg = jcfg.kan_variant(), cfg.kan_variant()
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _weights(name, seed=0, **kw):
    jcfg, cfg = _configs(name, **kw)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, _port(jp)


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
            assert set(tg[key]) == set(jg[key])
            for n in jg[key]:
                np.testing.assert_allclose(tg[key][n].float().numpy(),
                                           _f32(jg[key][n]),
                                           rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------------------
# the blocks, in bf16
# ----------------------------------------------------------------------------


def _bf16(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).normal(size=shape) * scale
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    return jx, _port({"x": jx})["x"]


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_is_bit_equal_in_bf16(with_state):
    jx, tx = _bf16((2, 40, 64), seed=1)
    jw, tw = _bf16((4, 64), seed=2, scale=0.3)
    js, ts = _bf16((2, 3, 64), seed=3) if with_state else (None, None)
    jout, jstate = JL._causal_conv1d(jx, jw, js)
    tout, tstate = L._causal_conv1d(tx, tw, ts)
    np.testing.assert_array_equal(_f32(tout), _f32(jout))
    np.testing.assert_array_equal(_f32(tstate), _f32(jstate))


@pytest.mark.parametrize("s", [1, 7, 300])
def test_rglru_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 48)).astype(np.float32)
    b = rng.normal(size=(2, s, 48)).astype(np.float32)
    want = np.asarray(JL._rglru_scan(jnp.asarray(a), jnp.asarray(b)))
    got = L._rglru_scan(_torch(a), _torch(b)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _layer(kind, seed, **kw):
    arch = "recurrentgemma-9b" if kind == "rglru" else "mamba2-370m"
    jcfg = dataclasses.replace(j_smoke(arch), dtype="bfloat16", **kw)
    cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16", **kw)
    init = JL.init_rglru if kind == "rglru" else JL.init_mamba2
    jp = init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, _port(jp)


def _decode_steps(jfn, tfn, jp, tp, jcfg, cfg, jx, tx, s0, jstate, tstate):
    """Decode positions s0.. one at a time from the given states."""
    for i in range(s0, jx.shape[1]):
        jy, jstate = jfn(jp, jx[:, i:i + 1], jcfg, state=jstate)
        ty, tstate = tfn(tp, tx[:, i:i + 1], cfg, tstate)
        _bf16_close(ty, jy)
        _states_close(tstate, jstate)


def test_rglru_forward_prefill_and_decode_match_reference():
    jcfg, cfg, jp, tp = _layer("rglru", seed=4)
    jx, tx = _bf16((2, 23, cfg.d_model), seed=5)
    jy, _ = JL.rglru(jp, jx, jcfg)
    ty, _ = L.rglru(tp, tx, cfg)
    _bf16_close(ty, jy)
    jy, jstate = JL.rglru_prefill(jp, jx[:, :20], jcfg)
    ty, tstate = L.rglru_prefill(tp, tx[:, :20], cfg)
    _bf16_close(ty, jy)
    _states_close(tstate, jstate)
    _decode_steps(JL.rglru, L.rglru, jp, tp, jcfg, cfg, jx, tx, 20, jstate,
                  tstate)


@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 24)])
def test_ssd_chunked_matches_reference(s, chunk):
    """S a multiple of the chunk: several chunks carrying a state, and
    one chunk alone."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 4, 8, 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    a_log = rng.normal(size=(h,)).astype(np.float32) * 0.5
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, n)).astype(np.float32)
    jy, jst = JL._ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bb, cc)),
                              chunk)
    ty, tst = L._ssd_chunked(*map(_torch, (x, dt, a_log, bb, cc)), chunk)
    for got, want in ((ty, jy), (tst, jst)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= (
            STATE_REL * np.abs(want).max())


def test_ssd_chunk_with_a_long_decay_stays_finite():
    """A chunk whose decay spans more than f32 exp's range: the
    reference's ``exp(rel) * tril`` makes inf * 0 = NaN above the
    diagonal (its ``mamba2`` prefill then returns NaN, as at mamba2-370m's
    published widths on a 300-token prompt); the port masks before the
    exp and equals the reference's own step-by-step recurrence (its
    decode path, which never forms the difference)."""
    jcfg, cfg, jp, tp = _layer("ssm", seed=8)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], 8.0))
    tp = dict(tp, dt_bias=torch.full_like(tp["dt_bias"], 8.0))
    jx, tx = _bf16((1, 16, cfg.d_model), seed=9)
    jy, _ = JL.mamba2(jp, jx, jcfg)
    assert not bool(jnp.isfinite(jy.astype(jnp.float32)).all())
    ty, tstate = L.mamba2(tp, tx, cfg)
    assert bool(torch.isfinite(ty.float()).all())
    jstate = JL.init_mamba2_state(jcfg, 1)
    steps = []
    for i in range(16):
        y, jstate = JL.mamba2(jp, jx[:, i:i + 1], jcfg, state=jstate)
        steps.append(y)
    _bf16_close(ty, jnp.concatenate(steps, axis=1))
    _states_close(tstate, jstate)


@pytest.mark.parametrize("s", [37, 32])
def test_mamba2_prefill_and_decode_match_reference(s):
    """A prompt of 37 (not a multiple of the 16-step chunk: padded to 48)
    or 32 (two whole chunks), then 3 decode steps."""
    jcfg, cfg, jp, tp = _layer("ssm", seed=6)
    jx, tx = _bf16((2, s + 3, cfg.d_model), seed=7)
    jy, jstate = JL.mamba2_prefill(jp, jx[:, :s], jcfg)
    ty, tstate = L.mamba2_prefill(tp, tx[:, :s], cfg)
    _bf16_close(ty, jy)
    _states_close(tstate, jstate)
    _decode_steps(JL.mamba2, L.mamba2, jp, tp, jcfg, cfg, jx, tx, s, jstate,
                  tstate)


@pytest.mark.parametrize("kind", ["rglru", "ssm"])
def test_recurrent_card_check_runs_on_the_cpu(kind):
    """``models.cardcheck.check_recurrent_layer`` (phase 11 of
    ``chip_smoke.py``) with both copies on the CPU: no difference."""
    _, cfg, _, _ = _layer(kind, seed=0)
    st = check_recurrent_layer("cpu", cfg, kind, tokens=40)
    assert st["out_ulps"] == st["state_ulps"] == st["conv_diff"] == 0


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
    jl, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :s0])}, jcfg,
                            max_len=max_len)
    tl, tcache = M.prefill(tp, {"tokens": _torch(toks[:, :s0])}, cfg,
                           max_len=max_len)
    _logit_close(tl, jl)
    _caches_close(tcache, jcache)
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
    """Prefill 19 tokens (mamba2: a 16-step chunk and a padded one) and
    decode 3; the caches, recurrent states included, equal the
    reference's after each."""
    jcfg, cfg, jp, tp = models[name]
    _prefill_and_decode(jp, tp, jcfg, cfg, _tokens(cfg, 2, 22, 2), s0=19,
                        max_len=32, steps=3)


def test_quantized_recurrentgemma_kan_variant_matches_reference(models):
    """The kan_variant() with every KAN-FFN block quantized (the RG-LRU
    layers' FFNs too): the port's "fused" backend (B1's plain version
    here) against the reference's Pallas pipeline in interpret mode,
    forward and prefill + 3 decodes."""
    jcfg, cfg, jp, tp = models["rgemma_kan"]
    jq, tq = j_quantize_tree(jp, jcfg), quantize_kan_ffn_params_tree(tp, cfg)
    toks = _tokens(cfg, 2, 12, seed=3)
    with jrt.use_backend("pallas"), runtime.use_backend("fused"):
        runtime.reset_dispatch_counts()
        _logit_close(M.forward(tq, {"tokens": _torch(toks)}, cfg),
                     JM.forward(jq, {"tokens": jnp.asarray(toks)}, jcfg))
        _prefill_and_decode(jq, tq, jcfg, cfg, toks, s0=9, max_len=32,
                            steps=3)
    assert runtime.dispatch_counts() == {"fused": 5 * cfg.num_layers}


def test_local_ring_decodes_past_the_wrap():
    """recurrentgemma at a window of 8: a 13-token prompt wraps the local
    layer's ring in prefill, and decode runs to position 23; each step
    equals the reference's decode and the port's own forward."""
    jcfg, cfg, jp, tp = _weights("rgemma", seed=1, window_size=8)
    toks = _tokens(cfg, 1, 24, seed=4)
    full = M.forward(tp, {"tokens": _torch(toks)}, cfg)
    jl, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :13])}, jcfg,
                            max_len=24)
    tl, tcache = M.prefill(tp, {"tokens": _torch(toks[:, :13])}, cfg,
                           max_len=24)
    _logit_close(tl, jl)
    for i in range(13, 24):
        pos = np.array([i], np.int32)
        jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(toks[:, i]),
                                    jnp.asarray(pos), jcfg)
        tl, tcache = M.decode_step(tp, tcache, _torch(toks[:, i]),
                                   _torch(pos), cfg)
        _logit_close(tl, jl)
        _logit_close(tl, full[:, i])
    _caches_close(tcache, jcache)
    assert tcache[0]["l2_kv"]["k"].shape[2] == 8


def _decode_from_zeros(jp, jcfg, toks, max_len):
    """The reference's token-by-token decode from its initial (zero)
    cache: one row of logits per position."""
    cache = JM.init_cache(jp, jcfg, toks.shape[0], max_len)
    rows = []
    for i in range(toks.shape[1]):
        lg, cache = JM.decode_step(jp, cache, jnp.asarray(toks[:, i]),
                                   jnp.full((toks.shape[0],), i, jnp.int32),
                                   jcfg)
        rows.append(np.asarray(lg))
    return rows, cache


@pytest.mark.parametrize("name", ["rgemma", "mamba2"])
@pytest.mark.parametrize("plen", [1, 2])
def test_prompt_shorter_than_the_conv_keeps_zero_state(models, name, plen):
    """A prompt shorter than the conv's K - 1 = 3 rows: the reference's
    prefill keeps only ``plen`` conv rows (and its engine then fails to
    splice them); the port left-pads the conv state with zeros, which is
    the state the reference's own decode from its zero cache reaches.
    Prefill and 4 decode steps equal that decode."""
    jcfg, cfg, jp, tp = models[name]
    toks = _tokens(cfg, 2, plen + 4, seed=12)
    want, jcache = _decode_from_zeros(jp, jcfg, toks, max_len=16)
    _, jshort = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :plen])}, jcfg,
                           max_len=16)
    key = "l0_rnn" if name == "rgemma" else "l0_ssm"
    assert jshort[0][key]["conv"].shape[2] == plen
    tl, tcache = M.prefill(tp, {"tokens": _torch(toks[:, :plen])}, cfg,
                           max_len=16)
    assert tcache[0][key]["conv"].shape[2] == 3
    _logit_close(tl, want[plen - 1])
    for i in range(plen, toks.shape[1]):
        tl, tcache = M.decode_step(tp, tcache, _torch(toks[:, i]),
                                   torch.full((2,), i), cfg)
        _logit_close(tl, want[i])
    _caches_close(tcache, jcache)


# ----------------------------------------------------------------------------
# training: loss_fn's value and gradients
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rgemma", "mamba2"])
def test_loss_and_gradients_match_reference(models, name):
    jcfg, cfg, jp, tp = models[name]
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    with jrt.use_attn_backend("ref"):
        want, jgrads = jax.value_and_grad(JM.loss_fn)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    with runtime.use_attn_backend("ref"):
        loss = M.loss_fn(tree_unflatten(tp, leaves),
                         {k: _torch(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want)) <= 1e-5
    ref = jax.tree.leaves(jgrads)
    got = flatten(tree_unflatten(tp, list(grads)))
    assert len(got) == len(ref)
    for i, (g, w) in enumerate(zip(got, ref)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-6, (i, err)


def test_train_cli_trains_recurrentgemma_on_the_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loop, hist = train_cli.main(["--arch", "recurrentgemma-9b", "--smoke",
                                     "--steps", "2", "--seq-len", "16",
                                     "--global-batch", "4", "--device", "cpu",
                                     "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 2 and all(math.isfinite(m["loss"]) for m in hist)
    assert "l0_rnn" in loop.state["params"]["decoder"][0]


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------


def _run(engine_cls, req_cls, params, cfg, prompts, max_new=6, **kw):
    eng = engine_cls(params, cfg, slots=2, max_len=64, **kw)
    reqs = [req_cls(rid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    return eng, {r.rid: list(r.output) for r in eng.run(reqs)}


@pytest.mark.parametrize("name,kan_deploy", [("rgemma", False),
                                             ("rgemma_kan", True),
                                             ("mamba2", False)])
def test_engine_streams_match_reference_engine(models, name, kan_deploy):
    """The contiguous engine (2 slots, max_len 64; prompts of 5, 40 and 17
    tokens: the 40-token prompt wraps recurrentgemma's 32-slot ring and
    runs mamba2's SSD over 3 chunks of 16, the last one padded): every
    state leaf spliced per slot, exact-length prefill."""
    jcfg, cfg, jp, tp = models[name]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
               for n in (5, 40, 17)]
    _, want = _run(JServeEngine, JRequest, jp, jcfg, prompts,
                   kan_deploy=kan_deploy)
    runtime.reset_attn_dispatch_counts()
    eng, got = _run(ServeEngine, Request, tp, cfg, prompts, device="cpu",
                    kan_deploy=kan_deploy)
    assert got == want
    assert not eng.prefill_buckets
    st = eng.compile_stats()
    calls = st["prefill_calls"] + st["decode_traces"]
    attn_layers = cfg.layer_kinds.count("local")
    assert runtime.attn_dispatch_counts() == (
        {"flash": calls * attn_layers} if attn_layers else {})


def test_engine_serves_a_prompt_shorter_than_the_conv(models):
    """A 2-token prompt (the reference's engine fails to splice its
    2-row conv state) beside a longer one: each stream equals the greedy
    stream of the reference's token-by-token decode."""
    jcfg, cfg, jp, tp = models["mamba2"]
    prompts = [[7, 9], _tokens(cfg, 1, 6, seed=13)[0].tolist()]
    with pytest.raises(ValueError, match="Incompatible shapes"):
        _run(JServeEngine, JRequest, jp, jcfg, prompts[:1], max_new=2)
    _, got = _run(ServeEngine, Request, tp, cfg, prompts, max_new=4,
                  device="cpu")
    for rid, prompt in enumerate(prompts):
        seq = list(prompt)
        for _ in range(4):
            rows, _ = _decode_from_zeros(jp, jcfg, np.asarray([seq]), 64)
            seq.append(int(np.argmax(rows[-1][0])))
        assert got[rid] == seq[len(prompt):]


def _cli(main, argv, monkeypatch=None):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if monkeypatch is None:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["serve"] + argv)
            main()
    return buf.getvalue()


@pytest.mark.parametrize("arch,kan", [("recurrentgemma-9b", True),
                                      ("recurrentgemma-9b", False),
                                      ("mamba2-370m", False),
                                      ("mamba2-370m", True)])
def test_serve_cli_serves_the_recurrent_archs_on_the_cpu(arch, kan):
    """mamba2's kan_variant() has no FFN layer (an "ssm" layer has none):
    ``--kan-ffn`` serves it with nothing to quantize, as the reference's
    CLI does."""
    runtime.reset_dispatch_counts()
    out = _cli(serve_cli.main, ["--arch", arch, "--requests", "2", "--slots",
                                "2", "--max-new", "3", "--device", "cpu"]
               + (["--kan-ffn"] if kan else []))
    assert "served requests=2" in out, out
    assert bool(runtime.dispatch_counts()) == (kan and arch != "mamba2-370m")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-370m"])
@pytest.mark.parametrize("extra", [[], ["--kan-ffn", "--spec-decode", "2"]])
def test_paging_and_spec_decode_stay_refused(arch, extra, monkeypatch):
    """The engine refuses a paged cache for recurrent stacks (and so
    speculative decoding, which needs one) with the reference's message,
    from either CLI."""
    argv = ["--arch", arch, "--kv-block-size", "8"] + extra
    msgs = []
    for main, mp in ((j_serve_cli.main, monkeypatch),
                     (serve_cli.main, None)):
        with pytest.raises(ValueError) as e:
            _cli(main, argv + ([] if mp else ["--device", "cpu"]), mp)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "pure global-attention decoder" in msgs[1]
    cfg = smoke_config(arch)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    with pytest.raises(ValueError, match="pure global-attention"):
        ServeEngine(params, cfg, kv_block_size=8, device="cpu")
