"""The plain PyTorch version of kernel B2, in the kernel's recurrence.

Port of what ``repro/kernels/attention/kernel.py::_flash_kernel`` computes:
the GQA group is folded next to the query rows (row = s * G + g), the keys
are walked in tiles of :data:`BLOCK_K`, and a running max ``m``,
denominator ``l`` and accumulator are rescaled tile by tile (the
FlashAttention recurrence).  Every kind masks ``kpos < 0``; ``causal`` adds
``kpos <= qpos``, ``local`` also ``kpos > qpos - window``; softcap comes
before masking, masked scores are the finite ``-1e30`` and their exp is
forced to 0, and a row with no admitted key finalizes to exact zeros.
All math is f32.  The CPU path of :func:`..ops.flash_attention` and the
card check of the CUDA kernel both run this.

With ``kv_splits`` > 1 it follows the tensor-core kernel's split KV axis:
the keys are cut at whole kernel tiles (:func:`mma_block_k` keys) into
``kv_splits`` runs, each run keeps its own (m, l, acc), and the runs are
merged in split order: ``M = max m_s``, ``w_s = exp(m_s - M)`` where
``l_s > 0`` and 0 where it is not, ``out = sum w_s acc_s / sum w_s l_s``
(exact zeros where no run admitted a key).  :func:`kv_split_count` is the
kernel's split count, a function of the call's shapes alone.
"""

from __future__ import annotations

import torch

from ..cuda import FILL_BLOCKS

__all__ = ["BLOCK_K", "MMA_ROWS", "NEG_INF", "kv_split_count",
           "kv_split_runs", "flash_attention_plain", "mma_block_k"]

NEG_INF = -1e30  # finite mask constant shared with models.layers
BLOCK_K = 32     # keys per tile, as in the CUDA-core kernel
MMA_ROWS = 64     # (query, group) rows per block of the tensor-core kernel


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def mma_block_k(d: int) -> int:
    """Keys per KV tile of the tensor-core kernel at head dim ``d``
    (``TcShape<D>::kKeys``): 64, or 32 at D = 256, where a warp's f32
    output fragments already take 128 registers a thread."""
    return 32 if d > 128 else 64


def kv_split_count(b: int, s: int, t: int, hkv: int, g: int, d: int) -> int:
    """KV splits of the tensor-core kernel for a call of these shapes: 1
    when its ``B * Hkv * ceil(S*G/64)`` blocks fill the card, else enough
    to (at most one per key tile of :func:`mma_block_k` keys), with no
    empty split.  A function of the whole call shape and of nothing
    else."""
    blocks = b * hkv * _cdiv(s * g, MMA_ROWS)
    tiles = _cdiv(t, mma_block_k(d))
    if blocks <= 0 or blocks >= FILL_BLOCKS or tiles <= 1:
        return 1
    splits = min(_cdiv(FILL_BLOCKS, blocks), tiles)
    return _cdiv(tiles, _cdiv(tiles, splits))


def kv_split_runs(t: int, d: int, splits: int) -> list:
    """The key runs ``(k0, k1)`` of a call of ``t`` keys at head dim ``d``
    cut ``splits`` ways, as the kernel cuts them: ceil(tiles / splits)
    whole tiles of :func:`mma_block_k` keys each (the last run may be
    short; a split past the last tile has no run)."""
    bk = mma_block_k(d)
    per = max(1, _cdiv(_cdiv(t, bk), max(int(splits), 1))) * bk
    return [(k0, min(t, k0 + per)) for k0 in range(0, max(t, 1), per)]


def flash_attention_plain(q, k, v, qpos, kpos, *, kind: str, window: int,
                          softcap: float, scale: float,
                          out_dtype: torch.dtype | None = None,
                          kv_splits: int = 1):
    """q (B, S, Hq, D); k, v (B, T, Hkv, D); qpos (B, S) and kpos (B, T)
    int32.  Returns (B, S, Hq, D) in ``out_dtype`` (default q's dtype);
    ``kv_splits`` as in the module docstring."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    rows = s * g
    qr = (q.reshape(b, s, hkv, g, d).permute(0, 2, 1, 3, 4)
          .reshape(b, hkv, rows, d).to(torch.float32))
    kr = k.permute(0, 2, 1, 3).to(torch.float32)
    vr = v.permute(0, 2, 1, 3).to(torch.float32)
    qp = qpos.to(torch.int64).repeat_interleave(g, dim=1)[:, None, :, None]
    kp_all = kpos.to(torch.int64)
    parts = []
    for k0, k1 in kv_split_runs(t, d, kv_splits):
        m = torch.full((b, hkv, rows, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, rows, d), dtype=torch.float32,
                          device=q.device)
        for t0 in range(k0, k1, BLOCK_K):
            t1 = min(k1, t0 + BLOCK_K)
            kt, vt = kr[:, :, t0:t1], vr[:, :, t0:t1]
            kp = kp_all[:, None, None, t0:t1]
            sc = (qr @ kt.transpose(-1, -2)) * scale
            if softcap > 0.0:
                sc = torch.tanh(sc / softcap) * softcap
            mask = kp >= 0
            if kind in ("causal", "local"):
                mask = mask & (kp <= qp)
            if kind == "local" and window > 0:
                mask = mask & (kp > qp - window)
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            e = torch.where(mask, torch.exp(sc - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + e.sum(dim=-1, keepdim=True)
            acc = acc * alpha + e @ vt
            m = m_new
        parts.append((m, l, acc))
    if len(parts) == 1:
        _, l, acc = parts[0]
    else:
        mmax = parts[0][0]
        for m, _, _ in parts[1:]:
            mmax = torch.maximum(mmax, m)
        l = torch.zeros_like(mmax)
        acc = torch.zeros_like(parts[0][2])
        for m, ls, a in parts:  # in split order, as the combine kernel
            w = torch.where(ls > 0.0, torch.exp(m - mmax), 0.0)
            l = l + ls * w
            acc = acc + a * w
    out = torch.where(l > 0.0, acc / torch.clamp_min(l, 1e-30), 0.0)
    out = out.reshape(b, hkv, s, g, d).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, hq, d).to(out_dtype or q.dtype)
