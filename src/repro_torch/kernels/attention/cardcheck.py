"""Kernel B2 held against its plain version on the card.

The one definition of the B2 card check, shared by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``.  Each case draws q, k, v from a seeded
``torch.Generator`` on the card, runs the kernel (through
:func:`.ops.flash_attention`) and the plain recurrence
(:func:`.ref.flash_attention_plain`, in f32 on the same inputs), and raises
on disagreement:

  * f32 operands: within ``F32_TOL + F32_TOL * |plain|`` (the same f32
    terms summed in another order, and ``expf``/``tanhf`` against
    PyTorch's; the reference package holds its own flash kernel to its
    composition at the same 2e-5);
  * bf16 operands: within one bf16 ulp of the plain f32 result, plus the
    f32 term above (the kernel computes in f32 and rounds once to bf16);
  * rows with no admitted key are exact zeros in both;
  * each kernel call adds exactly one to ``cuda.LAUNCHES["flash_attention"]``
    (also when it splits the KV axis and runs the merge kernel too).

The plain version runs with the kernel's KV split count
(:func:`.ops.call_kv_splits`), so both merge the same key runs.
``B2_SPLIT`` holds the bf16 tensor-core instance at the serving geometry
where it splits the KV axis (decode at T = 1023 and 4096, verify at S = 3
and 5; recurrentgemma's D = 256 decode at T = 2048 and a ragged 2047),
with one split's keys all invalid for one batch row and rows masked in
every split.

:func:`check_b2` draws small cases with masked rows and keys;
:func:`check_b2_path` holds the kernel to the same gate at the serving
path's own shapes (``PATH_SHAPES``), with the positions the path sets;
``B2_A7A`` and :func:`check_b2_ring` at the sliding-window and MoE
decoders' prefill and decode geometry (a 4096-key window that excludes
keys, softcap 50, rings whose slot positions are not monotone);
``B2_A7B`` and ``B2_RING_A7B`` at recurrentgemma's local layer (D = 256,
16 query heads over one KV head: the tensor-core instance's 32-key tiles,
the ring decode with its KV axis split); ``B2_A7C`` at
whisper-base's encoder and cross attention and pixtral-12b's prefill over
its patch prefix, with a "full" case of more queries than keys.

``B2_MLA`` and :func:`check_mla` hold the latent (MLA) decode instance
(:func:`.ops.mla_attention`, 16 heads over one 576-value latent head whose
first 512 values are the value) against the same plain recurrence with
that one head as K and V: within ``F32_TOL + F32_TOL * |plain|`` plus
2^-15 of max |value| (the kernel keeps each probability as hi + lo bf16,
about 2^-17 of it, and returns f32), at Moonlight's decode geometry (256
slots, random lengths up to a cache of 4096, the KV axis split two ways),
a small batch whose KV axis splits many ways, a verify step (S = 3) and a
cache shorter than one tile, each counted once in
``cuda.LAUNCHES["flash_attention.mla"]``.
"""

from __future__ import annotations

import itertools

import torch

from .. import cuda
from .ops import (MLA_DIMS, b2_instance, call_kv_splits, flash_attention,
                  mla_attention, mla_split_count)
from .ref import flash_attention_plain

__all__ = ["F32_TOL", "DTYPES", "KINDS", "GQA", "HEAD_DIMS", "B2_CASES",
           "B2_EXTRA", "B2_SPLIT", "B2_A7A", "B2_RING", "B2_A7B",
           "B2_RING_A7B", "B2_A7C", "RING_POS",
           "PATH_SHAPES", "bf16_ulp", "b2_inputs", "path_inputs",
           "ring_inputs", "window_excluded_pairs", "check_b2",
           "check_b2_case", "check_b2_path", "check_b2_ring", "B2_MLA",
           "check_mla"]

F32_TOL = 2e-5
DTYPES = (torch.float32, torch.bfloat16)
KINDS = ("causal", "local", "full")
GQA = ((4, 4), (4, 2), (4, 1))
HEAD_DIMS = (16, 64, 128, 256)
# dtype x kind x (Hq, Hkv) x D, at odd S and T with masked rows and keys
B2_CASES = tuple(itertools.product(DTYPES, KINDS, GQA, HEAD_DIMS))
# the serving geometry (48 query heads over 8 KV heads, D=128, bf16) at a
# decode step and a prefill chunk of odd lengths, softcap under two kinds,
# and the D=32 instance: keyword arguments of check_b2
B2_EXTRA = (
    dict(dtype=torch.bfloat16, kind="causal", hq=48, hkv=8, d=128, b=3, s=1,
         t=1023),
    dict(dtype=torch.bfloat16, kind="causal", hq=48, hkv=8, d=128, b=1,
         s=257, t=1023),
    dict(dtype=torch.float32, kind="local", hq=4, hkv=2, d=64, softcap=2.0),
    dict(dtype=torch.bfloat16, kind="full", hq=4, hkv=1, d=32, softcap=2.0),
)
# the tensor-core instance with its KV axis split (keyword arguments of
# check_b2; ``dead`` = keys (lo, hi) made invalid in the last batch row,
# one whole split of it in the first four cases): decode at T = 1023 and
# 4096, verify at S = 3 and S = 5 (speculative k = 2 and 4), a local window
# (most splits masked by position) and D = 64 under "full" (the last batch
# row has no valid key at all); then recurrentgemma's local layer (bf16,
# D = 256, 16 query heads over one KV head: 64 splits of one 32-key tile
# each): decode over 2048 keys with one whole split of the last batch row
# dead, a ragged T = 2047 (the last tile one key short, its split dead)
# and a local window of 100 keys, which masks 60 of its 64 splits by
# position
B2_SPLIT = (
    dict(dtype=torch.bfloat16, kind="causal", hq=48, hkv=8, d=128, b=4, s=1,
         t=1023, dead=(128, 256)),
    dict(dtype=torch.bfloat16, kind="causal", hq=48, hkv=8, d=128, b=4, s=1,
         t=4096, dead=(512, 1024)),
    dict(dtype=torch.bfloat16, kind="causal", hq=48, hkv=8, d=128, b=4, s=3,
         t=1023, dead=(0, 128)),
    dict(dtype=torch.bfloat16, kind="causal", hq=48, hkv=8, d=128, b=4, s=5,
         t=1023, dead=(0, 128)),
    dict(dtype=torch.bfloat16, kind="local", hq=48, hkv=8, d=128, b=2, s=1,
         t=1023, window=100),
    dict(dtype=torch.bfloat16, kind="full", hq=8, hkv=2, d=64, b=2, s=1,
         t=700),
    dict(dtype=torch.bfloat16, kind="causal", hq=16, hkv=1, d=256, b=4, s=1,
         t=2048, dead=(64, 96)),
    dict(dtype=torch.bfloat16, kind="causal", hq=16, hkv=1, d=256, b=4, s=1,
         t=2047, dead=(2016, 2047)),
    dict(dtype=torch.bfloat16, kind="local", hq=16, hkv=1, d=256, b=2, s=1,
         t=2047, window=100),
)
# the serving path's shapes at the full-width qwen2.5-14b config (48 query
# heads, 8 KV heads, D=128, bf16): (name, B, S, T, kind)
PATH_SHAPES = (
    ("decode", 4, 1, 1024, "causal"),
    ("prefill", 1, 1000, 1000, "causal"),
    ("paged_chunk", 1, 256, 1024, "causal"),
)


# the sliding-window and MoE decoders' prefill geometry (bf16, D=128, one
# prompt of S = T keys, no masked rows): gemma2's local layer (32 query
# heads over 16 KV heads, window 4096, softcap 50) and mixtral's (32 over
# 8, window 4096) at a 4200-token prompt, where rows 4096.. exclude keys;
# olmoe's causal layer (16 over 16) at 1000 tokens: keyword arguments of
# check_b2
B2_A7A = (
    dict(dtype=torch.bfloat16, kind="local", hq=32, hkv=16, d=128, b=1,
         s=4200, t=4200, window=4096, softcap=50.0, masked=False),
    dict(dtype=torch.bfloat16, kind="local", hq=32, hkv=8, d=128, b=1,
         s=4200, t=4200, window=4096, masked=False),
    dict(dtype=torch.bfloat16, kind="causal", hq=16, hkv=16, d=128, b=1,
         s=1000, t=1000, masked=False),
)
# decode over a full rolling-window ring (4 slots, T = window = 4096, bf16,
# D=128): (name, Hq, Hkv, softcap) of gemma2's and mixtral's local layers
B2_RING = (("ring_gemma2", 32, 16, 50.0), ("ring_mixtral", 32, 8, 0.0))
# recurrentgemma-9b's local layer (16 query heads over one KV head, D=256,
# bf16, window 2048: the tensor-core instance) at a 2300-token prompt,
# where rows 2048.. exclude keys: keyword arguments of check_b2
B2_A7B = (
    dict(dtype=torch.bfloat16, kind="local", hq=16, hkv=1, d=256, b=1,
         s=2300, t=2300, window=2048, masked=False),
)
# and its decode over full 2048-slot rings: (name, Hq, Hkv, softcap, D,
# window) of check_b2_ring
B2_RING_A7B = (("ring_rgemma", 16, 1, 0.0, 256, 2048),)
# whisper-base (8 query heads over 8 KV heads, D=64) and pixtral-12b (32
# over 8, D=128), bf16: (name, keyword arguments of check_b2).  The
# encoder's bidirectional layer over 4 clips of 1500 frames ("full": the
# tensor-core instance with tail tiles at 1500); cross attention of the
# decoder's longest context (448 tokens) and of one decode step (the KV
# split) over the 1500 encoder keys; pixtral's causal prefill of 256
# patches and a 1000-token prompt; and "full" with more queries than keys,
# where the right-aligned default qpos runs negative and every valid key is
# still admitted (masked: every fifth key of batch 0 invalid, the last
# batch row all invalid)
B2_A7C = (
    ("whisper_encoder", dict(dtype=torch.bfloat16, kind="full", hq=8, hkv=8,
                             d=64, b=4, s=1500, t=1500, masked=False)),
    ("whisper_cross_prefill", dict(dtype=torch.bfloat16, kind="full", hq=8,
                                   hkv=8, d=64, b=4, s=448, t=1500,
                                   masked=False)),
    ("whisper_cross_decode", dict(dtype=torch.bfloat16, kind="full", hq=8,
                                  hkv=8, d=64, b=4, s=1, t=1500,
                                  masked=False)),
    ("pixtral_prefill", dict(dtype=torch.bfloat16, kind="causal", hq=32,
                             hkv=8, d=128, b=1, s=1256, t=1256,
                             masked=False)),
    ("full_s_gt_t", dict(dtype=torch.bfloat16, kind="full", hq=8, hkv=8,
                         d=64, b=2, s=100, t=60)),
)
# the latent instance's cases: (name, B, S, T); positions drawn per slot
B2_MLA = (("mla_decode_256", 256, 1, 4096), ("mla_decode_3", 3, 1, 1000),
          ("mla_verify", 2, 3, 1000), ("mla_short", 2, 1, 20))
# the slots' positions: wrapped (non-monotone kpos) at 4215, 4300 and
# 8191, and one slot short of the window (its upper slots never written)
RING_POS = (4215, 4300, 8191, 100)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), as f32."""
    ax = x.abs().to(torch.float32)
    e = torch.floor(torch.log2(torch.clamp_min(ax, 2.0 ** -126)))
    return torch.exp2(e - 7)


def b2_inputs(dev, gen, *, dtype, hq, hkv, d, b, s, t, kind, masked=True,
              dead=None):
    """Random operands of one B2 call.  With ``masked``: three query rows
    of batch 0 have qpos = -1 (no admitted key under causal / local), every
    fifth key of batch 0 is invalid (kpos = -1), and under "full" the last
    batch row has every key invalid (all its rows are then exact zeros).
    ``dead = (lo, hi)``: keys lo..hi-1 of the last batch row are invalid.
    Returns ``(q, k, v, qpos, kpos, zero_rows)``; ``zero_rows`` is a (B, S)
    bool mask of the rows that must be exact zeros."""
    q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dtype)
    qpos = (torch.arange(s, device=dev, dtype=torch.int32) + (t - s)) \
        .expand(b, s).clone()
    kpos = torch.arange(t, device=dev, dtype=torch.int32).expand(b, t).clone()
    zero = torch.zeros(b, s, dtype=torch.bool, device=dev)
    if masked:
        kpos[0, ::5] = -1
        if kind == "full":
            kpos[-1] = -1
            zero[-1] = True
        else:
            qpos[0, -3:] = -1
            zero[0, -3:] = True
    if dead is not None:
        kpos[-1, dead[0]:dead[1]] = -1
    return q, k, v, qpos, kpos, zero


def path_inputs(dev, name: str, b: int, s: int, t: int):
    """bf16 operands of one ``PATH_SHAPES`` entry at the serving geometry,
    with the positions the path sets (decode, also as ``decode_t<T>``:
    every slot at the last position of a full cache; verify: the last S
    positions; prefill: right-aligned; paged chunk: the third 256-token
    chunk of a prompt over the gathered view).  Returns
    ``(q, k, v, qpos, kpos)``."""
    gen = torch.Generator(device=dev).manual_seed(5)
    hq, hkv, d = 48, 8, 128
    q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(torch.bfloat16)
    start = {"decode": t - 1, "verify": t - s, "prefill": 0,
             "paged_chunk": 512}[name.split("_t")[0]]
    qpos = (start + torch.arange(s, device=dev, dtype=torch.int32)).expand(b, s)
    kpos = torch.arange(t, device=dev, dtype=torch.int32).expand(b, t)
    return q, k, v, qpos.contiguous(), kpos.contiguous()


def ring_inputs(dev, hq: int, hkv: int, window: int = 4096, seed: int = 6,
                d: int = 128):
    """bf16 operands of one decode step over rolling-window rings (one per
    slot of ``RING_POS``), head dim ``d``: slot j of a ring holds the
    largest position <= pos with position % window == j, negative where
    never written (the positions ``models.layers._window_positions`` gives
    the decode step).  Returns ``(q, k, v, qpos, kpos)``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(RING_POS)
    q = torch.randn(b, 1, hq, d, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(b, window, hkv, d, generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn(b, window, hkv, d, generator=gen, device=dev).to(
        torch.bfloat16)
    pos = torch.tensor(RING_POS, device=dev, dtype=torch.int64)
    slots = torch.arange(window, device=dev)[None, :]
    kpos = pos[:, None] - ((pos % window)[:, None] - slots) % window
    return (q, k, v, pos[:, None].to(torch.int32).contiguous(),
            kpos.to(torch.int32).contiguous())


def window_excluded_pairs(qpos, kpos, window: int) -> int:
    """(query, key) pairs that the causal predicate admits and the window
    excludes (kpos <= qpos - window), per head; 0 means the window never
    masks a key on these positions."""
    qp = qpos.to(torch.int64)[..., :, None]
    kp = kpos.to(torch.int64)[..., None, :]
    return int(((kp >= 0) & (kp <= qp - window)).sum().item())


def check_b2_ring(dev, name: str, hq: int, hkv: int, softcap: float,
                  d: int = 128, window: int = 4096) -> dict:
    """One ``B2_RING`` (or ``B2_RING_A7B``) entry, kernel (the decode
    step's causal kind over the ring's positions) against plain; returns
    the stats of :func:`check_b2` and ``non_monotone_slots``, the slots
    whose kpos is below the slot before it (must be > 0)."""
    q, k, v, qpos, kpos = ring_inputs(dev, hq, hkv, window=window, d=d)
    st = _compare((name,), q, k, v, qpos, kpos, None, kind="causal",
                  window=0, softcap=softcap)
    st["non_monotone_slots"] = int((kpos[:, 1:] < kpos[:, :-1]).sum().item())
    if st["non_monotone_slots"] == 0:
        raise AssertionError(f"B2 {name}: no ring wrapped")
    return st


def _compare(case, q, k, v, qpos, kpos, zero, *, kind, window, softcap):
    """Kernel against plain on one set of operands (see the module
    docstring); returns ``{"max_abs_err", "max_err_over_tol", "kv_splits",
    "instance"}`` (``instance``: :func:`.ops.b2_instance`)."""
    dtype, d = q.dtype, q.shape[-1]
    splits = call_kv_splits(q.shape, k.shape, dtype)
    before = cuda.launch_counts().get("flash_attention", 0)
    out = flash_attention(q, k, v, kind=kind, qpos=qpos, kpos=kpos,
                          window=window, softcap=softcap)
    if cuda.launch_counts()["flash_attention"] != before + 1:
        raise AssertionError(f"B2 {case}: launch not counted once")
    plain = flash_attention_plain(q, k, v, qpos, kpos, kind=kind,
                                  window=window, softcap=softcap,
                                  scale=d ** -0.5, out_dtype=torch.float32,
                                  kv_splits=splits)
    torch.cuda.synchronize()
    if out.dtype != dtype or out.shape != q.shape:
        raise AssertionError(f"B2 {case}: out {out.dtype} {tuple(out.shape)}")
    got = out.to(torch.float32)
    err = (got - plain).abs()
    tol = F32_TOL + F32_TOL * plain.abs()
    if dtype == torch.bfloat16:
        tol = tol + bf16_ulp(plain)
    if not bool((err <= tol).all()):
        raise AssertionError(f"B2 {case}: max err {err.max().item():.3e}, "
                             f"worst err/tol {(err / tol).max().item():.3f}")
    if zero is not None and zero.any() and (
            got[zero].abs().max().item() != 0.0
            or plain[zero].abs().max().item() != 0.0):
        raise AssertionError(f"B2 {case}: fully masked rows are not exact 0")
    return {"max_abs_err": err.max().item(),
            "max_err_over_tol": (err / tol).max().item(), "kv_splits": splits,
            "instance": b2_instance(d, dtype)}


def check_b2_case(dev, gen, *, dtype, kind, hq, hkv, d, b=2, s=33, t=47,
                  window=7, softcap=0.0, masked=True, dead=None) -> tuple:
    """One B2 case, kernel against plain; returns ``{"max_abs_err",
    "max_err_over_tol", "kv_splits", "instance", "window_excluded"}`` (the
    last: the pairs :func:`window_excluded_pairs` counts, 0 unless
    "local") and the operands ``(q, k, v, qpos, kpos)``."""
    q, k, v, qpos, kpos, zero = b2_inputs(dev, gen, dtype=dtype, hq=hq,
                                          hkv=hkv, d=d, b=b, s=s, t=t,
                                          kind=kind, masked=masked, dead=dead)
    window = window if kind == "local" else 0
    st = _compare((str(dtype), kind, hq, hkv, d, b, s, t), q, k, v, qpos,
                  kpos, zero, kind=kind, window=window, softcap=softcap)
    st["window_excluded"] = (window_excluded_pairs(qpos, kpos, window)
                             if window else 0)
    return st, (q, k, v, qpos, kpos)


def check_b2(dev, gen, **case) -> dict:
    """One B2 case (:func:`check_b2_case`'s arguments), kernel against
    plain; returns its stats."""
    return check_b2_case(dev, gen, **case)[0]


def check_b2_path(dev, name: str, b: int, s: int, t: int, kind: str):
    """One ``PATH_SHAPES`` entry, kernel against plain; returns the stats
    of :func:`check_b2` and the operands ``(q, k, v, qpos, kpos)``."""
    ops = path_inputs(dev, name, b, s, t)
    return _compare((name, b, s, t), *ops, None, kind=kind, window=0,
                    softcap=0.0), ops


def check_mla(dev, gen, name: str, b: int, s: int, t: int) -> dict:
    """One latent-instance case (see the module docstring): q (B, S, 16,
    576) and a cache (B, T, 576) in bf16 from ``gen``, each slot's last
    query at a random position below T (slot 0 at 0: one admitted key),
    kernel against plain; returns ``{"max_abs_err", "max_err_over_tol",
    "kv_splits", "keys"}`` (``keys``: the admitted cache rows, each slot's
    length)."""
    dqk, dv = MLA_DIMS
    h = 16
    q = torch.randn(b, s, h, dqk, generator=gen, device=dev).to(torch.bfloat16)
    ckv = torch.randn(b, t, dqk, generator=gen, device=dev) \
        .to(torch.bfloat16)
    last = torch.randint(s - 1, t, (b,), generator=gen, device=dev)
    last[0] = s - 1
    qpos = (last[:, None] - (s - 1) + torch.arange(s, device=dev)) \
        .to(torch.int32)
    scale = (dqk - 64) ** -0.5
    before = cuda.launch_counts().get("flash_attention.mla", 0)
    out = mla_attention(q, ckv, qpos, dv=dv, scale=scale)
    if cuda.launch_counts()["flash_attention.mla"] != before + 1:
        raise AssertionError(f"B2 {name}: launch not counted once")
    kv = ckv[:, :, None]
    kpos = torch.arange(t, dtype=torch.int32, device=dev).expand(b, t)
    plain = flash_attention_plain(q, kv, kv, qpos, kpos, kind="causal",
                                  window=0, softcap=0.0, scale=scale,
                                  out_dtype=torch.float32)[..., :dv]
    torch.cuda.synchronize()
    if out.dtype != torch.float32 or out.shape != (b, s, h, dv):
        raise AssertionError(f"B2 {name}: out {out.dtype} "
                             f"{tuple(out.shape)}")
    err = (out - plain).abs()
    tol = (F32_TOL + F32_TOL * plain.abs()
           + 2.0 ** -15 * ckv[..., :dv].float().abs().max())
    if not bool((err <= tol).all()):
        raise AssertionError(f"B2 {name}: max err {err.max().item():.3e}, "
                             f"worst err/tol {(err / tol).max().item():.3f}")
    return {"max_abs_err": err.max().item(),
            "max_err_over_tol": (err / tol).max().item(),
            "kv_splits": mla_split_count(b, s, h, t),
            "keys": int((last + 1).sum().item())}
