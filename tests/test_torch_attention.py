"""Kernel B2's plain version and the port's attention paths vs the reference.

The cases mirror ``tests/test_attention_parity.py``: the same q, k, v
(drawn with numpy) go through the reference's ``flash_attention`` (Pallas
interpret mode) and ``_sdpa_ref`` / ``_sdpa_decode``, and through the
port's counterparts on CPU tensors, where ``flash_attention`` takes the
kernel's plain version (``kernels/attention/ref.py``).  Tolerance
``TOL`` = 2e-5 abs + rel: the reference holds its own flash kernel to its
composition at the same 2e-5 (both compute in f32 but associate the
reductions differently).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs.registry import smoke_config as j_smoke
from repro.kernels.attention import flash_attention as j_flash
from repro.models import layers as JL
from repro_torch import runtime
from repro_torch.configs import smoke_config
from repro_torch.kernels import cuda
from repro_torch.kernels.attention import (
    call_kv_splits,
    flash_attention,
    flash_attention_plain,
    kv_split_count,
)
from repro_torch.models import layers as L

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, s, hq, hkv, d, t=None, seed=0):
    t = s if t is None else t
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for shape in
                 ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _cfgs(name="qwen2.5-14b", **upd):
    return (dataclasses.replace(j_smoke(name), **upd),
            dataclasses.replace(smoke_config(name), **upd))


@pytest.mark.parametrize("kind", ["global", "local", "bidir"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_kinds_and_gqa_match_reference(kind, hq, hkv):
    jcfg, cfg = _cfgs(window_size=7)
    q, k, v = _qkv(2, 33, hq, hkv, 16, seed=hq * 10 + hkv)
    want_ref = JL._sdpa_ref(q, k, v, jcfg, kind)
    want_flash = j_flash(q, k, v, kind=JL._FLASH_KIND[kind],
                         window=jcfg.window_size, interpret=True)
    got_ref = L._sdpa_ref(*_t(q, k, v), cfg, kind)
    with runtime.use_attn_backend("flash"):
        got_flash = L._sdpa(*_t(q, k, v), cfg, kind)
    _close(got_ref, want_ref)
    _close(got_flash, want_flash)
    _close(got_flash, want_ref)


def test_softcap_and_cross_lengths_match_reference():
    """Softcap before masking; cross attention has S != T and no mask."""
    jcfg, cfg = _cfgs("gemma2-27b", window_size=0)
    assert cfg.attn_logit_softcap > 0.0
    q, k, v = _qkv(2, 9, 4, 2, 16, t=24, seed=3)
    for kind in ("cross", "global"):
        want = JL._sdpa_ref(q, k, v, jcfg, kind)
        with jrt.use_attn_backend("flash"):
            want_flash = JL._sdpa(q, k, v, jcfg, kind)
        with runtime.use_attn_backend("flash"):
            got = L._sdpa(*_t(q, k, v), cfg, kind)
        _close(got, want_flash)
        _close(got, want)
        _close(L._sdpa_ref(*_t(q, k, v), cfg, kind), want)


def test_fully_masked_rows_are_exact_zeros():
    jcfg, cfg = _cfgs()
    q, k, v = _qkv(1, 8, 4, 2, 16, seed=11)
    qpos = np.concatenate([np.arange(5), np.full(3, -1)]).astype(np.int32)
    want = JL._sdpa_ref(q, k, v, jcfg, "global", qpos=jnp.asarray(qpos))
    tq = _t(q, k, v)
    ref = L._sdpa_ref(*tq, cfg, "global", qpos=torch.from_numpy(qpos))
    with runtime.use_attn_backend("flash"):
        flash = L._sdpa(*tq, cfg, "global", qpos=torch.from_numpy(qpos))
    for o in (ref, flash):
        assert bool(torch.isfinite(o).all())
        assert o[:, -3:].abs().max().item() == 0.0
        _close(o, want)
    # every key invalid under "full": the whole output is exact zeros
    kpos = np.full((1, 8), -1, np.int32)
    out = flash_attention(*tq, kind="full", kpos=torch.from_numpy(kpos))
    assert out.abs().max().item() == 0.0
    _close(out, j_flash(q, k, v, kind="full", kpos=kpos, interpret=True))
    # decode-path variant: a batch row whose key mask is all-False
    od = L._sdpa_batch_masked(tq[0][:, :1], tq[1], tq[2],
                              torch.zeros(1, 8, dtype=torch.bool), cfg)
    assert od.abs().max().item() == 0.0


@pytest.mark.parametrize("s,t", [(1, 7), (5, 37), (65, 63)])
def test_odd_lengths_and_positions_match_reference(s, t):
    """Odd S and T (ragged against the 32-key tile), explicit positions
    with invalid keys, and the local window."""
    q, k, v = _qkv(2, s, 4, 2, 32, t=t, seed=s + t)
    rng = np.random.default_rng(s)
    qpos = (np.arange(s) + t - s).astype(np.int32)[None].repeat(2, 0)
    kpos = np.arange(t, dtype=np.int32)[None].repeat(2, 0)
    kpos[1, rng.integers(0, t, 3)] = -1
    for kind, window in (("causal", 0), ("local", 5), ("full", 0)):
        want = j_flash(q, k, v, kind=kind, qpos=qpos, kpos=kpos,
                       window=window, interpret=True)
        got = flash_attention(*_t(q, k, v), kind=kind,
                              qpos=torch.from_numpy(qpos),
                              kpos=torch.from_numpy(kpos), window=window)
        _close(got, want)


def test_chunked_ref_remainder_matches_reference(monkeypatch):
    """``_sdpa_ref`` above ATTN_CHUNK pads the last chunk (qpos -1 rows)."""
    monkeypatch.setattr(L, "ATTN_CHUNK", 16)
    monkeypatch.setattr(JL, "ATTN_CHUNK", 16)
    jcfg, cfg = _cfgs()
    q, k, v = _qkv(1, 37, 4, 2, 16, seed=5)
    _close(L._sdpa_ref(*_t(q, k, v), cfg, "global"),
           JL._sdpa_ref(q, k, v, jcfg, "global"))


@pytest.mark.parametrize("backend", ["ref", "flash"])
@pytest.mark.parametrize("s", [1, 3])
def test_decode_and_verify_attention_match_reference(backend, s):
    """``_sdpa_decode`` at S=1 (decode) and S=3 (verify) over a cache whose
    unwritten tail carries kpos = -1."""
    jcfg, cfg = _cfgs()
    b, t = 2, 12
    q, k, v = _qkv(b, s, 4, 2, 16, t=t, seed=7 + s)
    pos = np.array([4, 8], np.int32)
    qpos = (pos[:, None] + np.arange(s)).astype(np.int32)
    kpos = np.where(np.arange(t)[None] <= qpos[:, -1:], np.arange(t)[None], -1)
    kpos = kpos.astype(np.int32)
    want = JL._sdpa_decode(q, k, v, jcfg, "global", jnp.asarray(qpos),
                           jnp.asarray(kpos), backend=backend)
    got = L._sdpa_decode(*_t(q, k, v), cfg, "global", torch.from_numpy(qpos),
                         torch.from_numpy(kpos), backend=backend)
    _close(got, want)


def test_plain_version_is_the_cpu_path_and_counts_no_launch():
    q, k, v = _t(*_qkv(1, 5, 4, 1, 16, seed=2))
    before = cuda.launch_counts().get("flash_attention", 0)
    out = flash_attention(q, k, v)
    qpos = torch.arange(5, dtype=torch.int32)[None]
    plain = flash_attention_plain(q, k, v, qpos, qpos, kind="causal",
                                  window=0, softcap=0.0, scale=0.25)
    assert torch.equal(out, plain)
    assert cuda.launch_counts().get("flash_attention", 0) == before


def test_wrapper_rejects_bad_args():
    q, k, v = _t(*_qkv(1, 8, 4, 2, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, kind="sideways")
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 8, 3, 16), k, v)


def test_backend_resolution_precedence(monkeypatch):
    """explicit arg > use_attn_backend scope > REPRO_ATTN_BACKEND > the
    default ("flash", the kernel); unknown names raise."""
    monkeypatch.delenv(runtime.ENV_ATTN_BACKEND_VAR, raising=False)
    assert runtime.resolve_attn_backend() == runtime.default_attn_backend()
    assert runtime.default_attn_backend() == "flash"
    monkeypatch.setenv(runtime.ENV_ATTN_BACKEND_VAR, "ref")
    assert runtime.resolve_attn_backend() == "ref"
    with runtime.use_attn_backend("flash"):
        assert runtime.resolve_attn_backend() == "flash"        # scope > env
        assert runtime.resolve_attn_backend("ref") == "ref"     # arg > scope
        with runtime.use_attn_backend(None):                    # passthrough
            assert runtime.resolve_attn_backend() == "flash"
    assert runtime.resolve_attn_backend() == "ref"
    with pytest.raises(ValueError):
        runtime.resolve_attn_backend("sdpa-magic")
    with pytest.raises(ValueError):
        with runtime.use_attn_backend("sdpa-magic"):
            pass
    assert set(runtime.available_attn_backends()) == {"ref", "flash"}


def test_dispatch_counts_follow_the_backend():
    _, cfg = _cfgs()
    q, k, v = _t(*_qkv(1, 4, 4, 2, 16))
    runtime.reset_attn_dispatch_counts()
    L._sdpa(q, k, v, cfg, "global", backend="ref")
    with runtime.use_attn_backend("flash"):
        L._sdpa(q, k, v, cfg, "global")
    assert runtime.attn_dispatch_counts() == {"ref": 1, "flash": 1}


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("kind,window", [("causal", 0), ("local", 50),
                                         ("full", 0)])
def test_plain_kv_splits_match_reference(splits, kind, window):
    """The plain version with the tensor-core kernel's split KV axis (runs
    of whole 64-key tiles, merged in split order) against the reference
    kernel.  Batch row 1 has keys 0..191 invalid, which covers a whole
    split at every count here; batch row 2 has no admitted key in any
    split (qpos -1, or every kpos -1 under "full"): exact zeros."""
    b, s, t = 3, 2, 300
    q, k, v = _qkv(b, s, 4, 2, 16, t=t, seed=splits)
    qpos = (np.arange(s) + t - s).astype(np.int32)[None].repeat(b, 0)
    kpos = np.arange(t, dtype=np.int32)[None].repeat(b, 0)
    kpos[1, :192] = -1
    if kind == "full":
        kpos[2] = -1
    else:
        qpos[2] = -1
    want = j_flash(q, k, v, kind=kind, qpos=qpos, kpos=kpos, window=window,
                   interpret=True)
    got = flash_attention_plain(*_t(q, k, v), torch.from_numpy(qpos),
                                torch.from_numpy(kpos), kind=kind,
                                window=window, softcap=0.0, scale=0.25,
                                kv_splits=splits)
    _close(got, want)
    assert got[2].abs().max().item() == 0.0


def test_plain_kv_splits_with_softcap_and_an_empty_split():
    """More splits than the keys fill (the last run is empty) and softcap
    before the mask: the same answer as one run."""
    q, k, v = _t(*_qkv(2, 3, 6, 2, 16, t=130, seed=4))
    qpos = torch.tensor([[127, 128, 129]] * 2, dtype=torch.int32)
    kpos = torch.arange(130, dtype=torch.int32)[None].repeat(2, 1)
    args = dict(kind="causal", window=0, softcap=2.0, scale=0.25)
    one = flash_attention_plain(q, k, v, qpos, kpos, **args)
    for splits in (2, 3, 8):
        got = flash_attention_plain(q, k, v, qpos, kpos, kv_splits=splits,
                                    **args)
        _close(got, one)


def test_kv_split_count_is_a_function_of_the_call_shapes():
    """Decode and verify at the serving geometry split; prefill does not;
    a call with one KV tile never splits; no split is ever empty of tiles
    and there are never more splits than tiles.  The count ignores the
    data and, at equal shapes, the batch contents."""
    assert kv_split_count(4, 1, 1024, 8, 6, 128) == 8
    assert kv_split_count(4, 3, 1023, 8, 6, 128) == 8
    assert kv_split_count(4, 1, 4096, 8, 6, 128) == 8
    assert kv_split_count(1, 1000, 1000, 8, 6, 128) == 1
    assert kv_split_count(1, 256, 1024, 8, 6, 128) == 2
    assert kv_split_count(4, 1, 60, 8, 6, 128) == 1
    for t in range(1, 2000, 37):
        n = kv_split_count(1, 1, t, 2, 1, 64)
        tiles = -(-t // 64)
        per = -(-tiles // n)
        assert 1 <= n <= tiles and (n - 1) * per < tiles
    q, k = (4, 1, 48, 128), (4, 1024, 8, 128)
    assert call_kv_splits(q, k, torch.bfloat16) == 8
    assert call_kv_splits(q, k, torch.float32) == 1          # CUDA-core
    assert call_kv_splits((4, 1, 48, 256), (4, 1024, 8, 256),
                          torch.bfloat16) == 1                # CUDA-core


def test_cpu_path_takes_the_kernels_split_count():
    """bf16 operands on the CPU run the plain version with the split count
    the card's tensor-core instance would use."""
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_qkv(1, 1, 12, 2, 64,
                                                       t=300, seed=9)))
    assert call_kv_splits(q.shape, k.shape, q.dtype) == 5
    qpos = torch.tensor([[299]], dtype=torch.int32)
    kpos = torch.arange(300, dtype=torch.int32)[None]
    out = flash_attention(q, k, v, qpos=qpos, kpos=kpos)
    plain = flash_attention_plain(q, k, v, qpos, kpos, kind="causal",
                                  window=0, softcap=0.0, scale=64 ** -0.5,
                                  kv_splits=5)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_wrapper_refuses_autograd(which):
    """B2 has no backward: with grad enabled and any of q, k, v requiring
    grad the wrapper raises on the CPU as on the card (where the kernel's
    output would carry no gradient); without grad it answers as before."""
    q, k, v = _t(*_qkv(2, 5, 4, 2, 16, seed=3))
    want = flash_attention(q, k, v)
    args = {"q": q, "k": k, "v": v}
    args[which] = args[which].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(**args)
    with torch.no_grad():
        assert torch.equal(flash_attention(**args), want)
