"""The encoder-decoder (whisper-base) and patch-prefix (pixtral-12b) models
in the port vs the reference on the same weights.

Weights are drawn by the reference (``init_params``) and carried over with
``repro_torch.convert.lm_params_from_numpy``; tokens and stub embeddings
(``enc_embeds`` / ``patch_embeds``) come from numpy seeds.  Smoke sizes
(``smoke_config``: 2 encoder + 2 decoder layers over 24 frames; 8 patches
of 32 features), f32.  Tolerances:

  * logits (forward, prefill, decode, the quantized ``kan_variant()``):
    ``1e-4 * max|logit| + 1e-5``, as in ``test_torch_arch.py`` (f32 sums
    in another order over a few layers).  In the quantized model's prefill
    and decode a batch row is left out, and counted, from the call on
    where the two packages' inputs to a KAN-FFN block quantize to other
    codes (an input one f32 ulp apart at a rounding boundary: the near-tie
    of ``repro_torch.parity``); every call keeps at least one row;
  * caches (self and cross K/V): within 2e-5;
  * ``loss_fn``: within 1e-5, each gradient leaf within
    ``1e-5 * max|g_ref| + 1e-6`` of ``jax.value_and_grad``;
  * the quantized tree: equal to the reference's byte for byte; the
    drafter's refit coefficients within 1e-5 (a least-squares solve in
    another order), every other leaf equal;
  * attention: "ref" against the "flash" backend's plain version and the
    reference's "ref" within 2e-5;
  * sinusoidal positions: within 1e-6 of the reference's (XLA's ``pow``,
    ``sin`` and ``cos`` against PyTorch's; 6e-8 measured, up to angle
    1499).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs.registry import smoke_config as j_smoke
from repro.core import kan_ffn_deploy as j_kan_ffn_deploy
from repro.core.kan_ffn_deploy import (
    quantize_kan_ffn_params_tree as j_quantize_tree,
)
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve.spec import refit_kan_ffn_params_tree as j_refit_tree
from repro_torch import convert, runtime
from repro_torch.configs import smoke_config
from repro_torch.core import kan_ffn_deploy
from repro_torch.core.kan_ffn_deploy import quantize_kan_ffn_params_tree
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.transformer import tree_layer
from repro_torch.runtime.executor import _entry_codes
from repro_torch.serve.spec import refit_kan_ffn_params_tree
from repro_torch.train.checkpoint import flatten
from repro_torch.train.optimizer import tree_leaves, tree_unflatten

torch.set_num_threads(1)

# name -> (arch, kan_variant)
MODELS = {
    "whisper": ("whisper-base", False),
    "pixtral": ("pixtral-12b", False),
    "whisper_kan": ("whisper-base", True),
    "pixtral_kan": ("pixtral-12b", True),
}
FLOAT = ("whisper", "pixtral")
KAN = ("whisper_kan", "pixtral_kan")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(a):
    return torch.from_numpy(np.array(a, copy=True))


def _configs(name, **kw):
    arch, kan = MODELS[name]
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    if kan:
        jcfg, cfg = jcfg.kan_variant(), cfg.kan_variant()
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _weights(name, seed=0, **kw):
    jcfg, cfg = _configs(name, **kw)
    # every field of the reference's config equal, and the port's own
    # fields (MLA, the routed MoE) at their defaults
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                               for f in jcfg.__dataclass_fields__})
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, convert.lm_params_from_numpy(_np(jp), device="cpu")


@pytest.fixture(scope="module")
def models():
    return {name: _weights(name) for name in MODELS}


def _batch(cfg, b, s, seed, targets=False):
    """numpy tokens (and targets) with the config's stub embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if targets:
        batch["targets"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.normal(
            size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.num_patches, cfg.patch_embed_dim)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: _torch(v) for k, v in batch.items()}


def _logit_close(got, want):
    want = np.asarray(want)
    tol = 1e-4 * np.abs(want).max() + 1e-5
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol, (err, tol)


def _caches_close(tcache, jcache):
    for tg, jg in zip(tcache, jcache):
        assert set(tg) == set(jg)
        for key in jg:
            for n in ("k", "v"):
                np.testing.assert_allclose(tg[key][n].numpy(),
                                           np.asarray(jg[key][n]),
                                           rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", FLOAT)
def test_init_params_has_the_reference_tree(name):
    """The port's own init draws a tree of the reference's keys, shapes and
    dtypes: encoder, enc_norm, the decoder's cross sublayers (no QKV bias),
    patch_proj."""
    jcfg, cfg = _configs(name)
    want = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
    got = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    fg = flatten(got)
    assert len(fg) == len(fw)
    for (path, w), g in zip(fw, fg):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    keys = set(got)
    if cfg.encoder_layers:
        assert {"encoder", "enc_norm"} <= keys
        assert {"l0_xattn", "l0_lnx"} <= set(got["decoder"][0])
        assert "bq" not in got["decoder"][0]["l0_xattn"]
    else:
        assert "patch_proj" in keys


@pytest.mark.parametrize("name", FLOAT)
def test_lm_params_from_numpy_carries_the_prefix_leaves(models, name):
    """encoder (its stacked groups), enc_norm, patch_proj, l{i}_xattn and
    l{i}_lnx pass through the conversion value for value, also in bf16."""
    jcfg, cfg, jp, tp = models[name]
    for dtype in ("float32", "bfloat16"):
        src = jax.tree.map(lambda a: np.asarray(a.astype(dtype)), jp)
        got = convert.lm_params_from_numpy(src, device="cpu")
        leaves = jax.tree_util.tree_flatten_with_path(src)[0]
        tl = flatten(got)
        assert len(tl) == len(leaves)
        for (path, w), g in zip(leaves, tl):
            assert np.array_equal(g.float().numpy(), w.astype(np.float32)), \
                jax.tree_util.keystr(path)
    prefix = ({"encoder", "enc_norm"} if cfg.encoder_layers
              else {"patch_proj"})
    assert prefix <= set(tp)
    if cfg.encoder_layers:
        assert len(tp["encoder"]) == len(jp["encoder"])
        assert tp["encoder"][0]["l0_attn"]["wq"].shape[0] == \
            cfg.encoder_layers


def test_paged_cache_refuses_an_encoder_prefix(models):
    _, cfg, _, tp = models["whisper"]
    with pytest.raises(ValueError, match="encoder prefixes"):
        M.init_paged_cache(tp, cfg, 8, 8)


# ----------------------------------------------------------------------------
# model entry points
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("attn", ["ref", "flash"])
@pytest.mark.parametrize("name", FLOAT)
def test_forward_matches_reference(models, name, attn):
    """"flash" runs B2's plain version on the CPU, the reference its Pallas
    kernel in interpret mode."""
    jcfg, cfg, jp, tp = models[name]
    batch = _batch(cfg, 2, 12, seed=1)
    with jrt.use_attn_backend(attn), runtime.use_attn_backend(attn):
        got = M.forward(tp, _t(batch), cfg)
        want = JM.forward(jp, _j(batch), jcfg)
    assert tuple(got.shape) == (2, 12, cfg.vocab_size)
    _logit_close(got, want)


def _prefill_and_decode(jp, tp, jcfg, cfg, batch, s0, steps, flips=None):
    """Prefill ``tokens[:, :s0]`` in both packages, then ``steps`` decode
    steps (a vlm's positions past its patch rows); logits compared with the
    reference's and with the port's own forward at every step, caches at
    the end.  Decode leaves the cross cache as the prefill wrote it.

    With ``flips`` (a :class:`_CodeFlips` recording both packages'
    quantized KAN-FFN calls) the comparison is with the reference only,
    over the rows whose codes have not parted yet; returns the rows left
    out."""
    npfx = cfg.num_patches if cfg.family == "vlm" else 0
    max_len = npfx + s0 + steps + 4
    toks = batch["tokens"]
    full = None if flips else M.forward(tp, _t(batch), cfg)
    keep = np.ones(toks.shape[0], bool)

    def close(got, want, i):
        nonlocal keep
        if flips is not None:
            keep &= ~flips.rows()
            assert keep.any(), f"every row's codes parted by step {i}"
        _logit_close(got[keep], np.asarray(want)[keep])
        if full is not None:
            _logit_close(got, full[:, i])

    pb = {**batch, "tokens": toks[:, :s0]}
    jl, jcache = JM.prefill(jp, _j(pb), jcfg, max_len=max_len)
    tl, tcache = M.prefill(tp, _t(pb), cfg, max_len=max_len)
    close(tl, jl, s0 - 1)
    xkv = {key: {n: t.clone() for n, t in leaf.items()}
           for key, leaf in tcache[0].items() if key.endswith("_xkv")}
    assert bool(xkv) == bool(cfg.encoder_layers)
    for i in range(s0, s0 + steps):
        pos = np.full(toks.shape[0], npfx + i, np.int32)
        jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(toks[:, i]),
                                    jnp.asarray(pos), jcfg)
        tl, tcache = M.decode_step(tp, tcache, _torch(toks[:, i]),
                                   _torch(pos), cfg)
        close(tl, jl, i)
    if keep.all():
        _caches_close(tcache, jcache)
    for key, leaf in xkv.items():
        for n, t in leaf.items():
            assert torch.equal(tcache[0][key][n], t), (key, n)
    return int((~keep).sum())


class _CodeFlips:
    """While open, records the inputs of every quantized KAN-FFN call of
    both packages (they call in the same order); :meth:`rows` marks the
    batch rows where some pair of calls so far quantizes to other entry or
    boundary codes: the port's executor run on the port's input against the
    same executor on the reference's input."""

    def __init__(self, monkeypatch):
        self.mp, self.port, self.ref, self.flipped = monkeypatch, [], [], None

    def __enter__(self):
        port_apply = kan_ffn_deploy.kan_ffn_apply_quantized
        ref_apply = j_kan_ffn_deploy.kan_ffn_apply_quantized

        def port(p, x, cfg, backend=None):
            self.port.append((p, x.detach().clone()))
            return port_apply(p, x, cfg, backend)

        def ref(p, x, cfg, *a, **kw):
            self.ref.append(np.asarray(x, np.float32))
            return ref_apply(p, x, cfg, *a, **kw)

        self.mp.setattr(kan_ffn_deploy, "kan_ffn_apply_quantized", port)
        self.mp.setattr(j_kan_ffn_deploy, "kan_ffn_apply_quantized", ref)
        return self

    def __exit__(self, *exc):
        self.mp.undo()
        return False

    @staticmethod
    def _codes(p, x):
        b, s, d = x.shape
        dep = p["deployed"].replan(b * s)
        x2 = x.reshape(b * s, d).to(torch.float32)
        entry, _ = _entry_codes(dep, x2, None)
        _, codes = runtime.execute(dep, x2, return_intermediates=True)
        return [c.reshape(b, s, -1) for c in (entry, *codes)]

    def rows(self) -> np.ndarray:
        assert len(self.port) == len(self.ref)
        for (p, x), xr in zip(self.port, self.ref):
            got, want = self._codes(p, x), self._codes(p, _torch(xr))
            flip = np.zeros(x.shape[0], bool)
            for g, w in zip(got, want):
                flip |= (g != w).flatten(1).any(dim=1).numpy()
            self.flipped = flip if self.flipped is None else (
                self.flipped | flip)
        self.port.clear()
        self.ref.clear()
        return (np.zeros(0, bool) if self.flipped is None
                else self.flipped.copy())


@pytest.mark.parametrize("name", FLOAT)
def test_prefill_then_decode_match_reference_and_forward(models, name):
    """The reference's ``test_prefill_then_decode_matches_forward``: prefill
    9 tokens, decode 3."""
    jcfg, cfg, jp, tp = models[name]
    _prefill_and_decode(jp, tp, jcfg, cfg, _batch(cfg, 2, 12, seed=2), s0=9,
                        steps=3)


@pytest.mark.parametrize("name", FLOAT)
def test_prefill_reads_the_first_token_at_last_index(models, name):
    """``last_index`` counts tokens; a vlm's patch rows are added to it."""
    jcfg, cfg, jp, tp = models[name]
    batch = _batch(cfg, 2, 10, seed=8)
    idx = np.array([4, 9], np.int32)
    jl, _ = JM.prefill(jp, _j(batch), jcfg, max_len=32,
                       last_index=jnp.asarray(idx))
    tl, _ = M.prefill(tp, _t(batch), cfg, max_len=32,
                      last_index=_torch(idx))
    _logit_close(tl, jl)
    full = M.forward(tp, _t(batch), cfg)
    _logit_close(tl, full[torch.arange(2), _torch(idx).long()])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", FLOAT)
def test_loss_and_gradients_match_reference(models, name, remat):
    """Every gradient leaf (encoder, enc_norm, patch_proj and the cross
    sublayers included) against ``jax.value_and_grad``; with remat the
    blocks run under ``torch.utils.checkpoint``, the encoder output an
    explicit input of each decoder block."""
    jcfg, cfg, jp, tp = models[name]
    cfg = dataclasses.replace(cfg, remat=remat)
    batch = _batch(cfg, 2, 10, seed=6, targets=True)
    with jrt.use_attn_backend("ref"):
        want, jgrads = jax.value_and_grad(JM.loss_fn)(jp, _j(batch), jcfg)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    with runtime.use_attn_backend("ref"):
        loss = M.loss_fn(tree_unflatten(tp, leaves), _t(batch), cfg)
    grads = torch.autograd.grad(loss, leaves)
    loss = float(loss.detach())
    assert abs(loss - float(want)) <= 1e-5, (loss, float(want))
    ref = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got = flatten(tree_unflatten(tp, list(grads)))
    assert len(got) == len(ref)
    for g, (path, w) in zip(got, ref):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-6, (
            jax.tree_util.keystr(path), err)
    prefix = (tp["encoder"][0]["l0_attn"]["wq"] if cfg.encoder_layers
              else tp["patch_proj"])
    i = next(i for i, t in enumerate(tree_leaves(tp)) if t is prefix)
    assert float(grads[i].abs().max()) > 0


# ----------------------------------------------------------------------------
# the kan_variant(): quantized tree, fused forward, drafter refit
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quantized(models):
    out = {}
    for name in KAN:
        jcfg, cfg, jp, tp = models[name]
        out[name] = (j_quantize_tree(jp, jcfg),
                     quantize_kan_ffn_params_tree(tp, cfg))
    return out


@pytest.mark.parametrize("name", KAN)
def test_quantized_tree_is_byte_equal_to_reference(models, quantized, name):
    """Every quantized ``l{i}_ffn`` block, the encoder's included."""
    _, cfg, _, _ = models[name]
    jq, tq = quantized[name]
    stacks = ("decoder", "encoder") if cfg.encoder_layers else ("decoder",)
    assert set(tq) == set(jq)
    blocks = 0
    for stack in stacks:
        for jg, tg in zip(jq[stack], tq[stack]):
            for key, jblk in jg.items():
                if not key.endswith("_ffn"):
                    continue
                blocks += 1
                tblk = tg[key]
                assert set(tblk) == {"l1", "l2", "deployed"}
                assert len(tblk["deployed"]) == jblk["l1"]["c_q"].shape[0]
                for half in ("l1", "l2"):
                    assert set(tblk[half]) == set(jblk[half])
                    for k, v in jblk[half].items():
                        want, got = np.asarray(v), tblk[half][k].numpy()
                        assert got.dtype == want.dtype, (stack, key, k)
                        assert got.tobytes() == want.tobytes(), (stack, key,
                                                                 k)
    assert blocks == len(stacks)


@pytest.mark.parametrize("name", KAN)
def test_quantized_kan_variant_matches_reference(models, quantized, name,
                                                 monkeypatch):
    """The fused backend (B1's plain version here) against the reference's
    Pallas pipeline in interpret mode: forward, then prefill + 3 decodes
    (rows whose KAN-FFN codes part at a near-tie left out, module
    docstring); B1 on every layer of both stacks."""
    jcfg, cfg, _, _ = models[name]
    jq, tq = quantized[name]
    batch = _batch(cfg, 2, 12, seed=3)
    with jrt.use_backend("pallas"), runtime.use_backend("fused"):
        runtime.reset_dispatch_counts()
        _logit_close(M.forward(tq, _t(batch), cfg),
                     JM.forward(jq, _j(batch), jcfg))
        assert runtime.dispatch_counts() == {
            "fused": cfg.num_layers + cfg.encoder_layers}
        # the reference unrolled (no lax.scan), so its calls see values
        with _CodeFlips(monkeypatch) as flips:
            left_out = _prefill_and_decode(
                jq, tq, dataclasses.replace(jcfg, scan_layers=False), cfg,
                batch, s0=9, steps=3, flips=flips)
    print(f"{name}: {left_out} of 2 rows left out after a code flip")


@pytest.mark.parametrize("name", KAN)
def test_drafter_refit_matches_reference(models, name):
    """The drafter's refit walks the encoder too."""
    jcfg, cfg, jp, tp = models[name]
    hidden = L.kan_ffn_hidden(cfg)
    jd = dataclasses.replace(jcfg, kan_grid=4, kan_d_hidden=hidden)
    td = dataclasses.replace(cfg, kan_grid=4, kan_d_hidden=hidden)
    want = j_refit_tree(jp, jcfg, jd)
    got = refit_kan_ffn_params_tree(tp, cfg, td)
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    fg = flatten(got)
    assert len(fg) == len(fw)
    refit = 0
    for (path, w), g in zip(fw, fg):
        w, key = np.asarray(w), jax.tree_util.keystr(path)
        assert tuple(g.shape) == w.shape, key
        if "_ffn" in key and ("'c1'" in key or "'c2'" in key):
            refit += 1
            assert w.shape[-2] == 4 + cfg.kan_order
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                       err_msg=key)
        else:
            assert np.array_equal(g.numpy(), w), key
    assert refit == 2 * (2 if cfg.encoder_layers else 1)
    if cfg.encoder_layers:
        assert got["encoder"][0]["l0_ffn"]["c1"].shape[-2] == \
            4 + cfg.kan_order


# ----------------------------------------------------------------------------
# layers: attention kinds, positions, one cross layer
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("kind,s,t", [
    ("bidir", 30, 30),
    ("bidir", 1100, 1100),   # past ATTN_CHUNK: padded query chunks
    ("cross", 7, 24),
    ("cross", 40, 24),       # S > T: right-aligned qpos run negative
    ("cross", 1, 24),
])
def test_sdpa_ref_matches_flash_plain_and_reference(kind, s, t):
    """``_sdpa`` on "ref" against "flash" (B2's plain version: every key
    admitted under "full", also at the negative default qpos of S > T)
    and the reference's "ref"; and the cross decode path."""
    jcfg, cfg = _configs("whisper")
    rng = np.random.default_rng(s * 100 + t)
    q = rng.normal(size=(1, s, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, t, 2, 16)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = map(_torch, (q, k, v))
    ref = L._sdpa(tq, tk, tv, cfg, kind, backend="ref")
    flash = L._sdpa(tq, tk, tv, cfg, kind, backend="flash")
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg,
                    kind, backend="ref")
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(flash.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    if s == 1:
        for backend in ("ref", "flash"):
            dec = L._sdpa_decode(tq, tk, tv, cfg, kind, None, None,
                                 backend=backend)
            np.testing.assert_allclose(dec.numpy(), ref.numpy(), rtol=2e-5,
                                       atol=2e-5)


@pytest.mark.parametrize("seq,d", [(24, 64), (1500, 512)])
def test_sinusoidal_positions_match_reference(seq, d):
    got = L.sinusoidal_positions(seq, d)
    want = np.asarray(JL.sinusoidal_positions(seq, d))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_cross_attention_layer_matches_reference(models):
    """One cross sublayer: the full-sequence path against the reference's,
    and the decode path over the K/V the prefill writes."""
    jcfg, cfg, jp, tp = models["whisper"]
    jxp = jax.tree.map(lambda a: a[0], jp["decoder"][0]["l0_xattn"])
    txp = tree_layer(tp["decoder"][0], 0)["l0_xattn"]
    assert "bq" not in txp
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    want = JL.attention(jxp, jnp.asarray(x), jcfg, "cross",
                        enc_out=jnp.asarray(enc))
    got = L.attention(txp, _torch(x), cfg, "cross", enc_out=_torch(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    cache = {n: L._proj(_torch(enc), txp[f"w{n}"]) for n in ("k", "v")}
    out, same = L.attention_decode(txp, _torch(x[:, -1:]), cache, None, cfg,
                                   "cross")
    assert same is cache
    np.testing.assert_allclose(out.numpy(), got[:, -1:].numpy(), rtol=2e-5,
                               atol=2e-5)


def test_encdec_layer_card_check_runs_on_the_cpu():
    """The card check of one encoder and one cross-attention decoder layer
    (``models.cardcheck``), on two CPU copies at smoke widths in bf16: its
    shapes and bookkeeping (the card itself: ``tests/test_torch_gpu.py``)."""
    from repro_torch.models.cardcheck import check_encdec_layers

    cfg = dataclasses.replace(smoke_config("whisper-base"), dtype="bfloat16")
    st = check_encdec_layers(torch.device("cpu"), cfg, batch=2, prompt=3,
                             steps=2)
    assert st["xkv_unchanged"] and st["dec_ulps"] == st["enc_ulps"] == 0.0
