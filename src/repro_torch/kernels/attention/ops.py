"""Model-facing wrapper of kernel B2 (flash attention).

Port of ``repro.kernels.attention.ops.flash_attention``: the same GQA
layout (q (B, S, Hq, D), k and v (B, T, Hkv, D)), position operands and
defaults.  CUDA tensors launch the hand-written kernel
(``csrc/flash_attention.cu``, entry point ``flash_attention_fwd``), which
masks its ragged edges itself, so nothing is padded or sliced; CPU tensors
take the plain version :func:`.ref.flash_attention_plain`.  There is no
fallback between the two: a CUDA call the kernel cannot take raises.
B2 has no backward, so a call that autograd would have to differentiate
(grad enabled and q, k or v requiring grad) raises on either device
instead of returning a result without a gradient; training attends on
the ``"ref"`` backend (``runtime.use_attn_backend("ref")``).

bf16 operands at a head dim in :data:`MMA_HEAD_DIMS` run the tensor-core
instance (:func:`b2_instance`); f32 operands, and bf16 at D = 16 / 32, run
the CUDA-core instance.  The tensor-core instance splits the KV axis over
blocks when the call's shapes leave the card under-filled
(:func:`call_kv_splits`); the wrapper then allocates the splits' workspace
and the one C call launches the split kernel and the merge.  The plain
version on CPU tensors takes the same split count, so both sides run one
recurrence.

:func:`mla_attention` is B2's latent instance (``flash_kernel_mla``), the
absorbed decode of latent attention (MLA): every query head attends over
ONE latent KV head of the cache (the normed latent, then the shared
rotary key), whose first ``dv`` values are also the value.  It reads each
cached row once a block, up to the block's last query position, and
returns f32.  Its plain version is :func:`.ref.flash_attention_plain`
with that one head as K and V.
"""

from __future__ import annotations

import math

import torch

from .. import cuda
from .ref import NEG_INF, _cdiv, flash_attention_plain, kv_split_count

__all__ = ["KINDS", "MLA_DIMS", "MMA_HEAD_DIMS", "NEG_INF",
           "SUPPORTED_HEAD_DIMS", "b2_instance", "call_kv_splits",
           "flash_attention", "mla_attention", "mla_split_count"]

KINDS = ("causal", "local", "full")
_KIND_CODE = {"causal": 0, "local": 1, "full": 2}
# the kernel's template instances
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256)
# bf16 head dims of the tensor-core instance (the others, and f32, run the
# CUDA-core instance, which never splits the KV axis)
MMA_HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
# (q . k dims, value dims) of the latent instance: kv_lora_rank 512 plus
# qk_rope_head_dim 64, and the latent as the value
MLA_DIMS = (576, 512)
MLA_ROWS = 16  # (query, head) rows of one block of the latent instance
MLA_KEYS = 32  # keys of one staged tile of the latent instance


def b2_instance(d: int, dtype) -> str:
    """The kernel instance a call of head dim ``d`` and ``dtype`` runs:
    "mma" (bf16 on the tensor cores) or "cuda_core" (f32, and bf16 at a
    head dim outside :data:`MMA_HEAD_DIMS`).  The C entry point makes the
    same choice; a call never moves from one instance to the other."""
    if dtype == torch.bfloat16 and d in MMA_HEAD_DIMS:
        return "mma"
    return "cuda_core"


def call_kv_splits(q_shape, k_shape, dtype) -> int:
    """KV splits of one call: :func:`.ref.kv_split_count` of its shapes on
    the tensor-core instance, else 1."""
    b, s, hq, d = q_shape
    t, hkv = k_shape[1], k_shape[2]
    if b2_instance(d, dtype) != "mma":
        return 1
    return kv_split_count(b, s, t, hkv, hq // hkv, d)


def _positions(p, b: int, n: int, offset: int, device) -> torch.Tensor:
    """Normalize a position operand to (B, n) int32; None = arange+offset."""
    if p is None:
        p = torch.arange(n, dtype=torch.int32, device=device) + offset
    p = torch.as_tensor(p, device=device).to(torch.int32)
    if p.ndim == 1:
        p = p[None]
    return p.expand(b, n)


def flash_attention(q, k, v, *, kind: str = "causal", qpos=None, kpos=None,
                    window: int = 0, softcap: float = 0.0,
                    scale: float | None = None) -> torch.Tensor:
    """Fused attention over GQA layouts.

    Args:
      q: (B, S, Hq, D); k, v: (B, T, Hkv, D) with Hq % Hkv == 0.
      kind: "causal" (kpos <= qpos), "local" (causal and
        kpos > qpos - window), or "full" (no positional mask).
      qpos / kpos: int32 absolute positions, (S,) / (B, S) and (T,) /
        (B, T).  None means right-aligned ``arange(S) + (T - S)`` and
        ``arange(T)``.  Negative kpos marks an invalid key under every
        kind; a query row with no admitted key returns exactly 0.
      window: sliding-window size for kind="local" (<= 0 disables it).
      softcap: logit soft-cap, applied before masking (0 disables).
      scale: logit scale; defaults to 1/sqrt(D).

    Returns (B, S, Hq, D) in q's dtype.
    """
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention (kernel B2) has no backward; attend on the "
            "'ref' backend where gradients are needed "
            "(runtime.use_attn_backend('ref'))")
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qpos = _positions(qpos, b, s, t - s, q.device)
    kpos = _positions(kpos, b, t, 0, q.device)
    if not q.is_cuda:
        return flash_attention_plain(
            q, k, v, qpos, kpos, kind=kind, window=int(window),
            softcap=float(softcap), scale=float(scale),
            kv_splits=call_kv_splits(q.shape, k.shape, q.dtype))
    return _flash_attention_cuda(q, k, v, qpos, kpos, kind, int(window),
                                 float(softcap), float(scale))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned, as cp.async reads it (a view
    may start mid-row; a copy of it does not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _flash_attention_cuda(q, k, v, qpos, kpos, kind, window, softcap, scale):
    """Launch B2 on the card; raises for anything the kernel does not take."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not in {_DTYPES}")
    for name, x, shape in (("k", k, (b, t, hkv, d)), ("v", v, (b, t, hkv, d)),
                           ("qpos", qpos, (b, s)), ("kpos", kpos, (b, t))):
        if tuple(x.shape) != shape or x.device != q.device:
            raise ValueError(f"{name}: got {tuple(x.shape)} on {x.device}, "
                             f"want {shape} on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes differ: q {q.dtype}, k {k.dtype}, "
                         f"v {v.dtype}")
    if q.numel() == 0:  # the kernel launches nothing for an empty query
        return torch.empty_like(q)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    qpos, kpos = qpos.contiguous(), kpos.contiguous()
    out = torch.empty_like(q)
    g = hq // hkv
    splits = call_kv_splits(q.shape, k.shape, q.dtype)
    ws_o = ws_ml = None
    if splits > 1:
        ws_o = torch.empty((splits, b, hkv, s * g, d), dtype=torch.float32,
                           device=q.device)
        ws_ml = torch.empty((splits, b, hkv, s * g, 2), dtype=torch.float32,
                            device=q.device)
    status = cuda.library().flash_attention_fwd(
        cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(qpos),
        cuda.ptr(kpos), cuda.ptr(out), cuda.ptr(ws_o), cuda.ptr(ws_ml),
        b, s, t, hkv, g, d, int(q.dtype == torch.bfloat16), _KIND_CODE[kind],
        window, splits, softcap, scale, *cuda.stream_args(q.device),
    )
    cuda.check(status)
    cuda.LAUNCHES["flash_attention"] += 1
    return out


def mla_split_count(b: int, s: int, h: int, t: int) -> int:
    """KV splits of a latent-instance call: 1 when its ``B * ceil(S*H/16)``
    blocks fill the card, else enough to (at most one per 32-key tile of
    the cache).  A function of the call's shapes alone; each block cuts
    its own live tiles (those up to its last query position) into that
    many runs."""
    blocks = b * _cdiv(s * h, MLA_ROWS)
    tiles = _cdiv(t, MLA_KEYS)
    if blocks <= 0 or blocks >= cuda.FILL_BLOCKS or tiles <= 1:
        return 1
    return min(_cdiv(cuda.FILL_BLOCKS, blocks), tiles)


def mla_attention(q, ckv, qpos, *, dv: int, scale: float) -> torch.Tensor:
    """Attention of q (B, S, H, Dqk) over one latent KV head ``ckv`` (B, T,
    Dqk), whose first ``dv`` values are the value: cache slot t is admitted
    for a query at position qpos (B, S) when t <= qpos.  Returns (B, S, H,
    dv) f32.  CUDA tensors (bf16, (Dqk, dv) = :data:`MLA_DIMS`) launch
    ``flash_kernel_mla``; CPU tensors take the plain version."""
    b, s, h, dqk = q.shape
    t = ckv.shape[1]
    if tuple(ckv.shape) != (b, t, dqk) or not 0 < dv <= dqk:
        raise ValueError(f"ckv {tuple(ckv.shape)} / dv {dv} do not fit q "
                         f"{tuple(q.shape)}")
    qpos = _positions(qpos, b, s, t - s, q.device)
    if not q.is_cuda:
        kv = ckv[:, :, None]
        kpos = torch.arange(t, dtype=torch.int32, device=q.device)[None]
        out = flash_attention_plain(
            q, kv, kv, qpos, kpos.expand(b, t), kind="causal", window=0,
            softcap=0.0, scale=float(scale), out_dtype=torch.float32)
        return out[..., :dv]
    if (dqk, dv) != MLA_DIMS or q.dtype != torch.bfloat16 \
            or ckv.dtype != torch.bfloat16 or ckv.device != q.device:
        raise ValueError(f"the latent instance takes bf16 q and ckv at "
                         f"{MLA_DIMS}, got {q.dtype} / {ckv.dtype} at "
                         f"({dqk}, {dv})")
    q, ckv, qpos = _aligned(q), _aligned(ckv), qpos.contiguous()
    out = torch.empty((b, s, h, dv), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    splits = mla_split_count(b, s, h, t)
    ws_o = ws_ml = None
    if splits > 1:
        ws_o = torch.empty((splits, b, s * h, dv), dtype=torch.float32,
                           device=q.device)
        ws_ml = torch.empty((splits, b, s * h, 2), dtype=torch.float32,
                            device=q.device)
    status = cuda.library().flash_attention_mla_fwd(
        cuda.ptr(q), cuda.ptr(ckv), cuda.ptr(qpos), cuda.ptr(out),
        cuda.ptr(ws_o), cuda.ptr(ws_ml), b, s, t, h, dqk, dv, splits,
        float(scale), *cuda.stream_args(q.device))
    cuda.check(status)
    cuda.LAUNCHES["flash_attention.mla"] += 1
    return out
