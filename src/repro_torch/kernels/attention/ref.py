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
"""

from __future__ import annotations

import torch

__all__ = ["BLOCK_K", "NEG_INF", "flash_attention_plain"]

NEG_INF = -1e30  # finite mask constant shared with models.layers
BLOCK_K = 32     # keys per tile, as in the CUDA kernel


def flash_attention_plain(q, k, v, qpos, kpos, *, kind: str, window: int,
                          softcap: float, scale: float,
                          out_dtype: torch.dtype | None = None):
    """q (B, S, Hq, D); k, v (B, T, Hkv, D); qpos (B, S) and kpos (B, T)
    int32.  Returns (B, S, Hq, D) in ``out_dtype`` (default q's dtype)."""
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
    m = torch.full((b, hkv, rows, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, rows, d), dtype=torch.float32, device=q.device)
    for t0 in range(0, t, BLOCK_K):
        kt, vt = kr[:, :, t0:t0 + BLOCK_K], vr[:, :, t0:t0 + BLOCK_K]
        kp = kp_all[:, None, None, t0:t0 + BLOCK_K]
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
    out = torch.where(l > 0.0, acc / torch.clamp_min(l, 1e-30), 0.0)
    out = out.reshape(b, hkv, s, g, d).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, hq, d).to(out_dtype or q.dtype)
