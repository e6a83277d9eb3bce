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
    b2_instance,
    call_kv_splits,
    flash_attention,
    flash_attention_plain,
    kv_split_count,
    mma_block_k,
)
from repro_torch.kernels.attention.ref import kv_split_runs
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
    # bf16 at D = 256 runs the tensor cores (32-key tiles) and splits; f32
    # at D = 256 and bf16 at D = 32 stay on the CUDA-core instance
    assert call_kv_splits((4, 1, 48, 256), (4, 1024, 8, 256),
                          torch.bfloat16) == 8
    assert call_kv_splits((4, 1, 48, 256), (4, 1024, 8, 256),
                          torch.float32) == 1                 # CUDA-core
    assert call_kv_splits((4, 1, 48, 32), (4, 1024, 8, 32),
                          torch.bfloat16) == 1                # CUDA-core
    # recurrentgemma's local layer (16 query heads over one KV head): ring
    # decode over 2048 keys splits into 64 one-tile runs; the 2300-token
    # windowed prefill (575 blocks) fills the card
    assert kv_split_count(4, 1, 2048, 1, 16, 256) == 64
    assert kv_split_count(1, 2300, 2300, 1, 16, 256) == 1
    assert call_kv_splits((4, 1, 16, 256), (4, 2048, 1, 256),
                          torch.bfloat16) == 64
    assert call_kv_splits((1, 2300, 16, 256), (1, 2300, 1, 256),
                          torch.bfloat16) == 1


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


def test_instances_follow_dtype_and_head_dim():
    """bf16 at D = 64, 128 and 256 runs the tensor-core instance; f32 at
    every head dim and bf16 at D = 16 / 32 the CUDA-core one."""
    for d in (64, 128, 256):
        assert b2_instance(d, torch.bfloat16) == "mma"
        assert b2_instance(d, torch.float32) == "cuda_core"
    for d in (16, 32):
        assert b2_instance(d, torch.bfloat16) == "cuda_core"
        assert b2_instance(d, torch.float32) == "cuda_core"


@pytest.mark.parametrize("d", [64, 128, 256])
def test_kv_splits_fall_on_the_instances_tile_boundaries(d):
    """The split runs are whole tiles of the instance (64 keys, 32 at
    D = 256), one run per split, covering every key once in order."""
    bk = mma_block_k(d)
    assert bk == (32 if d == 256 else 64)
    for t in range(1, 3000, 61):
        n = kv_split_count(1, 1, t, 1, 16, d)
        runs = kv_split_runs(t, d, n)
        assert len(runs) == n and runs[0][0] == 0 and runs[-1][1] == t
        for (a0, a1), (b0, _) in zip(runs, runs[1:]):
            assert a1 == b0 and a0 % bk == 0 and b0 % bk == 0 and a1 > a0
    assert kv_split_runs(2048, 256, 64) == [(i, i + 32)
                                            for i in range(0, 2048, 32)]
    assert kv_split_runs(2047, 256, 64)[-1] == (2016, 2047)
    assert kv_split_runs(2048, 128, 32)[1] == (64, 128)


def _rgemma_operands(case: str):
    """recurrentgemma-9b's local layer (16 query heads over one KV head,
    D = 256) narrowed in length, numpy seeded: a 40-row prefill over 200
    keys whose 64-key window excludes keys, or one decode step over wrapped
    128-slot rings (slot j holds the largest position <= pos with
    position % 128 == j; non-monotone kpos, and the short ring's unwritten
    slots negative).  Returns (q, k, v, qpos, kpos, kind, window)."""
    if case == "local_prefill":
        b, s, t, window, kind = 2, 40, 200, 64, "local"
        qpos = (np.arange(s) + t - s).astype(np.int32)[None].repeat(b, 0)
        kpos = np.arange(t, dtype=np.int32)[None].repeat(b, 0)
    else:
        b, s, t, window, kind = 4, 1, 128, 0, "causal"
        pos = np.array([215, 300, 511, 50])
        qpos = pos[:, None].astype(np.int32)
        kpos = (pos[:, None] - ((pos % t)[:, None] - np.arange(t)) % t) \
            .astype(np.int32)
    q, k, v = _qkv(b, s, 16, 1, 256, t=t, seed=21 + s)
    return q, k, v, qpos, kpos, kind, window


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["local_prefill", "ring_decode"])
def test_recurrentgemma_local_geometry_matches_reference(case, dtype):
    """The same operands through the reference kernel (Pallas interpret
    mode) and the port's CPU path at the split count that path takes (bf16:
    the tensor-core instance's 32-key runs; f32: one run).  bf16 operands
    reach the reference as the f32 values of the bf16 inputs, which is
    what its kernel computes on; the port is compared in f32, and its bf16
    answer is that f32 result rounded once."""
    q, k, v, qpos, kpos, kind, window = _rgemma_operands(case)
    if case == "local_prefill":
        qp, kp = qpos[..., :, None], kpos[..., None, :]
        assert ((kp >= 0) & (kp <= qp - window)).any()  # the window bites
    else:
        assert (kpos[:, 1:] < kpos[:, :-1]).any()       # the ring wrapped
        assert (kpos < 0).any()                         # unwritten slots
    tq, tk, tv = (x.to(dtype) for x in _t(q, k, v))
    want = j_flash(*(np.asarray(x.to(torch.float32)) for x in (tq, tk, tv)),
                   kind=kind, qpos=qpos, kpos=kpos, window=window,
                   interpret=True)
    splits = call_kv_splits(tq.shape, tk.shape, dtype)
    assert splits == (1 if dtype == torch.float32 else
                      {"local_prefill": 7, "ring_decode": 4}[case])
    tqp, tkp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    got = flash_attention_plain(tq, tk, tv, tqp, tkp, kind=kind,
                                window=window, softcap=0.0,
                                scale=256 ** -0.5, out_dtype=torch.float32,
                                kv_splits=splits)
    _close(got, want)
    out = flash_attention(tq, tk, tv, kind=kind, qpos=tqp, kpos=tkp,
                          window=window)
    assert out.dtype == dtype
    assert torch.equal(out, got.to(dtype))


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
