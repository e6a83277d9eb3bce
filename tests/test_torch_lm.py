"""The port's LM (layers, decoder stack, model entry points, KAN-FFN deploy)
vs the reference on the same weights.

Weights are drawn by the reference (``init_params``) and carried over with
``repro_torch.convert.lm_params_from_numpy``; token and activation inputs
come from numpy seeds.  Both configs of the serving suites run in f32: the
smoke ``qwen2.5-14b`` (SwiGLU FFN) and its ``kan_variant()`` (float
KAN-FFN; quantized blocks checked on their own).  Tolerances:

  * layers: 2e-5 abs + rel (the same f32 terms in another order);
  * logits: ``1e-4 * max|logit| + 1e-5`` (two decoder layers of such
    differences, relative to the logit scale);
  * quantized KAN-FFN blocks: ``repro_torch.parity.compare_runs`` (outputs
    1e-5, boundary codes equal up to excused near-ties, counted);
  * ``quantize_kan_ffn_params_tree``: byte-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs.registry import smoke_config as j_smoke
from repro.core.kan_ffn_deploy import (
    kan_ffn_apply_quantized as j_kan_ffn_apply,
)
from repro.core.kan_ffn_deploy import (
    quantize_kan_ffn_params_tree as j_quantize_tree,
)
from repro.core.kan_network_deploy import deploy_kan_ffn_stack as j_deploy_ffn
from repro.models import layers as JL
from repro.models import model as JM
from repro.runtime.executor import _entry_codes as j_entry_codes
from repro_torch import convert, parity, runtime
from repro_torch.configs import smoke_config
from repro_torch.core.kan_ffn_deploy import (
    deploy_kan_ffn,
    deploy_kan_ffn_params_tree,
    kan_ffn_apply_quantized,
    quantize_kan_ffn_params_tree,
)
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.transformer import tree_layer
from repro_torch.runtime.executor import _entry_codes as t_entry_codes

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
CONFIGS = ("qwen", "qwen_kan")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(d: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in CONFIGS:
        jcfg, cfg = j_smoke("qwen2.5-14b"), smoke_config("qwen2.5-14b")
        if name == "qwen_kan":
            jcfg, cfg = jcfg.kan_variant(), cfg.kan_variant()
        # every field of the reference's config equal, and the port's
        # own fields (MLA, the routed MoE) at their defaults
        assert cfg == type(cfg)(**{f: getattr(jcfg, f) for f in
                                   jcfg.__dataclass_fields__})
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (jcfg, cfg, jp,
                     convert.lm_params_from_numpy(_np(jp), device="cpu"))
    return out


def _logit_close(got, want):
    want = np.asarray(want)
    tol = 1e-4 * np.abs(want).max() + 1e-5
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol, (err, tol)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        3, cfg.vocab_size, (b, s)).astype(np.int32)


def _attn_params(models, name="qwen"):
    jcfg, cfg, jp, tp = models[name]
    return jcfg, cfg, jax.tree.map(lambda a: a[0], jp["decoder"][0]["l0_attn"]), \
        tree_layer(tp["decoder"][0], 0)["l0_attn"]


# ----------------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------------


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        L.rmsnorm({"scale": _torch(scale)}, _torch(x), 1e-6).numpy(),
        np.asarray(JL.rmsnorm({"scale": scale}, x, 1e-6)), **TOL)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        L.rope(_torch(x), _torch(pos), 1e6).numpy(),
        np.asarray(JL.rope(x, jnp.asarray(pos), 1e6)), **TOL)


def test_attention_matches_reference(models):
    jcfg, cfg, jattn, tattn = _attn_params(models)
    x = np.random.default_rng(1).normal(size=(2, 11, 64)).astype(np.float32)
    want = JL.attention(jattn, x, jcfg, "global")
    for backend in ("ref", "flash"):
        with runtime.use_attn_backend(backend):
            got = L.attention(tattn, _torch(x), cfg, "global")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("paged", [False, True])
def test_attention_decode_matches_reference(models, s, paged):
    """Contiguous and paged decode (S=1) and verify (S=3); the new K/V
    land in the cache in place, equal to the reference's new cache."""
    jcfg, cfg, jattn, tattn = _attn_params(models)
    rng = np.random.default_rng(2 + s)
    b, t, bs = 2, 32, 8
    x = rng.normal(size=(b, s, 64)).astype(np.float32) * 0.3
    pos = np.array([5, 13], np.int32)
    if paged:
        nb = 9
        table = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
        cache = {k: rng.normal(size=(nb, bs, 2, 16)).astype(np.float32)
                 for k in ("k", "v")}
        want, wcache = JL.attention_decode(jattn, x, _jnp(cache),
                                           jnp.asarray(pos), jcfg, "global",
                                           block_table=jnp.asarray(table))
        tcache = {k: _torch(v) for k, v in cache.items()}
        got, gcache = L.attention_decode(tattn, _torch(x), tcache,
                                         _torch(pos), cfg, "global",
                                         block_table=_torch(table))
    else:
        cache = {k: rng.normal(size=(b, t, 2, 16)).astype(np.float32)
                 for k in ("k", "v")}
        want, wcache = JL.attention_decode(jattn, x, _jnp(cache),
                                           jnp.asarray(pos), jcfg, "global")
        tcache = {k: _torch(v) for k, v in cache.items()}
        got, gcache = L.attention_decode(tattn, _torch(x), tcache,
                                         _torch(pos), cfg, "global")
    assert gcache is tcache  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(gcache[k].numpy(), np.asarray(wcache[k]),
                                   **TOL)


def test_paged_prefill_update_drops_the_padded_tail():
    """A chunk that ends mid-block: rows past real_end are dropped (the
    reference's mode="drop"), in place, and nothing else moves."""
    rng = np.random.default_rng(4)
    nb, bs = 6, 8
    kv = {k: rng.normal(size=(nb, bs, 2, 4)).astype(np.float32)
          for k in ("k", "v")}
    k = rng.normal(size=(1, 8, 2, 4)).astype(np.float32)
    v = rng.normal(size=(1, 8, 2, 4)).astype(np.float32)
    table = np.array([2, 5, 1, 0], np.int32)
    start, real_end = 5, 10  # rows 0..4 kept (positions 5..9), 5..7 dropped
    wkv, wk, wv = JL.paged_prefill_update(_jnp(kv), k, v, jnp.asarray(table),
                                          jnp.int32(start), jnp.int32(real_end))
    tkv = {n: _torch(a) for n, a in kv.items()}
    gkv, gk, gv = L.paged_prefill_update(tkv, _torch(k), _torch(v),
                                         _torch(table), start, real_end)
    assert gkv is tkv
    for n in ("k", "v"):
        np.testing.assert_array_equal(gkv[n].numpy(), np.asarray(wkv[n]))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # position 10 would land in block 5 at offset 2: untouched
    np.testing.assert_array_equal(gkv["k"][5, 2].numpy(), kv["k"][5, 2])


def test_float_kan_ffn_matches_reference(models):
    jcfg, cfg, jp, tp = models["qwen_kan"]
    jffn = jax.tree.map(lambda a: a[1], jp["decoder"][0]["l0_ffn"])
    tffn = tree_layer(tp["decoder"][0], 1)["l0_ffn"]
    x = np.random.default_rng(5).normal(size=(2, 7, 64)).astype(np.float32)
    np.testing.assert_allclose(L.ffn(tffn, _torch(x), cfg).numpy(),
                               np.asarray(JL.ffn(jffn, x, jcfg)),
                               rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------------
# model entry points
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_prefill_decode_verify_match_reference(models, name):
    jcfg, cfg, jp, tp = models[name]
    toks = _tokens(cfg, 2, 12, seed=6)
    _logit_close(M.forward(tp, {"tokens": _torch(toks)}, cfg),
                 JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg))

    s0, max_len = 9, 32
    last = np.array([8, 6], np.int32)
    jl, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :s0])}, jcfg,
                            max_len=max_len, last_index=jnp.asarray(last))
    tl, tcache = M.prefill(tp, {"tokens": _torch(toks[:, :s0])}, cfg,
                           max_len=max_len, last_index=_torch(last))
    _logit_close(tl, jl)
    pos = np.array([s0, s0], np.int32)
    for i in range(2):
        jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(toks[:, s0 + i]),
                                    jnp.asarray(pos + i), jcfg)
        tl, tcache = M.decode_step(tp, tcache, _torch(toks[:, s0 + i]),
                                   _torch(pos + i), cfg)
        _logit_close(tl, jl)
    # verify: S=3 tokens in one pass over the same (paged) cache view
    nb, bs = 9, 8
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jpc = JM.init_paged_cache(jp, jcfg, nb, bs)
    tpc = M.init_paged_cache(tp, cfg, nb, bs)
    vt = toks[:, :3]
    jl, _ = JM.verify_step(jp, jpc, jnp.asarray(vt), jnp.zeros(2, jnp.int32),
                           jcfg, jnp.asarray(table))
    tl, _ = M.verify_step(tp, tpc, _torch(vt), torch.zeros(2, dtype=torch.int32),
                          cfg, _torch(table))
    assert tl.shape == (2, 3, cfg.vocab_size)
    _logit_close(tl, jl)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_chunk_matches_reference(models, name):
    """Two chunks of a 13-token prompt into the paged pool; the second is
    bucket-padded to 8 and ends mid-block (its pad writes are dropped)."""
    jcfg, cfg, jp, tp = models[name]
    toks = _tokens(cfg, 1, 13, seed=7)[0]
    nb, bs = 6, 8
    table = np.array([3, 1, 0, 0], np.int32)
    jc = JM.init_paged_cache(jp, jcfg, nb, bs)
    tc = M.init_paged_cache(tp, cfg, nb, bs)
    for start, take, c in ((0, 8, 8), (8, 5, 8)):
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :take] = toks[start:start + take]
        jl, jc = JM.prefill_chunk(jp, jnp.asarray(chunk), jc,
                                  jnp.asarray(table), jnp.int32(start),
                                  jnp.int32(start + take), jcfg,
                                  jnp.int32(12))
        tl, tc = M.prefill_chunk(tp, _torch(chunk), tc, _torch(table), start,
                                 start + take, cfg, 12)
    _logit_close(tl, jl)
    for jg, tg in zip(jc, tc):
        for key in jg:
            for n in ("k", "v"):
                np.testing.assert_allclose(tg[key][n].numpy(),
                                           np.asarray(jg[key][n]), **TOL)


# ----------------------------------------------------------------------------
# quantized KAN-FFN
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quantized(models):
    jcfg, cfg, jp, tp = models["qwen_kan"]
    return j_quantize_tree(jp, jcfg), quantize_kan_ffn_params_tree(tp, cfg)


def test_quantize_params_tree_is_byte_equal(quantized):
    jq, tq = quantized
    jblk, tblk = jq["decoder"][0]["l0_ffn"], tq["decoder"][0]["l0_ffn"]
    assert set(tblk) == {"l1", "l2", "deployed"}
    for half in ("l1", "l2"):
        assert set(tblk[half]) == set(jblk[half])
        for k, v in jblk[half].items():
            want = np.asarray(v)
            got = tblk[half][k].numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert got.tobytes() == want.tobytes(), (half, k)
    assert len(tblk["deployed"]) == jblk["l1"]["c_q"].shape[0]


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("rows", [5, 40])
def test_quantized_kan_ffn_block_matches_reference(models, quantized, layer,
                                                   rows):
    jcfg, cfg, _, _ = models["qwen_kan"]
    jq, tq = quantized
    jblk = jax.tree.map(lambda a: a[layer], jq["decoder"][0]["l0_ffn"])
    tblk = tree_layer(tq["decoder"][0], layer)["l0_ffn"]
    specs = JL.kan_ffn_specs(jcfg)
    jdep = j_deploy_ffn([jblk["l1"], jblk["l2"]], (64, 128, 64), specs,
                        batch=rows)
    x = (np.random.default_rng(rows + layer).normal(size=(rows, 64)) * 0.7
         ).astype(np.float32)
    jy, jcodes = jrt.execute(jdep, x, backend="pallas", interpret=True,
                             return_intermediates=True)
    dep = tblk["deployed"].replan(rows)
    ty, tcodes = runtime.execute(dep, _torch(x), return_intermediates=True)
    j_entry, j_raw = j_entry_codes(jdep, jnp.asarray(x), None)
    t_entry, _ = t_entry_codes(dep, _torch(x), None)
    want = [_torch(np.asarray(c)) for c in (j_entry, *jcodes)]
    pre = [parity.entry_preround(dep, x)] + parity.boundary_prerounds(
        dep, want[0], _torch(np.asarray(j_raw)), want[1:])
    stats = parity.compare_runs([t_entry, *tcodes], want, pre, ty,
                                np.asarray(jy))
    print(f"layer {layer} rows {rows}: {stats}")
    # the model-level call: the bundle deployed once gives the executor's
    # output and the reference's; a block without its bundle is refused
    x3 = _torch(x).reshape(1, rows, 64)
    once = kan_ffn_apply_quantized(tblk, x3, cfg)
    with pytest.raises(ValueError, match="deploy_kan_ffn_params_tree"):
        kan_ffn_apply_quantized({"l1": tblk["l1"], "l2": tblk["l2"]}, x3, cfg)
    assert torch.equal(once.reshape(rows, 64), ty)
    if stats["rows_left_out"] == 0:
        np.testing.assert_allclose(
            once.numpy(), np.asarray(j_kan_ffn_apply(jblk, x3.numpy(), jcfg,
                                                     interpret=True)),
            atol=1e-5, rtol=1e-5)


def test_converted_quantized_tree_deploys_to_the_same_bundles(quantized,
                                                              models):
    _, cfg, _, _ = models["qwen_kan"]
    jq, tq = quantized
    conv = deploy_kan_ffn_params_tree(
        convert.lm_params_from_numpy(_np(jq), device="cpu"), cfg)
    for a, b in zip(conv["decoder"][0]["l0_ffn"]["deployed"],
                    tq["decoder"][0]["l0_ffn"]["deployed"]):
        assert a.plan == b.plan
        for la, lb in zip(a.layers, b.layers):
            assert all(torch.equal(la[k], lb[k]) for k in lb)
    blk = tree_layer(conv["decoder"][0], 0)["l0_ffn"]
    assert deploy_kan_ffn(blk, cfg).dims == (64, 128, 64)
