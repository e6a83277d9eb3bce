"""Transformer layers of the attention decoders: norms, RoPE, GQA attention
with contiguous, rolling-window and paged KV caches, the SwiGLU / GeLU /
KAN FFNs and the top-k MoE FFN.

Port of the attention-decoder subset of ``repro.models.layers``.  Params are
plain nested dicts of tensors; init functions take an explicit
``torch.Generator`` and ``device``.  Activations are (B, S, D) in the
config's dtype, with reductions and softmax in f32, following the
reference's casts one by one.  KV caches are updated IN PLACE (the
reference returns new arrays; an in-place ``index_put_`` saves a copy of
the whole cache per layer and step) and returned as the same objects.

Cross attention raises ``NotImplementedError`` (ROADMAP A7c); RG-LRU and
Mamba-2 have no layer here yet (A7b).
The reference's ``_grad_safe_barrier`` is an XLA scheduling hint and has
no counterpart here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.asp_quant import ASPQuantSpec, resolve_layer_bits
from ..core.bspline import _cardinal_bump_coeffs, bspline_basis_fast
from ..kernels.attention.ref import NEG_INF

__all__ = [
    "ATTN_CHUNK",
    "torch_dtype",
    "init_rmsnorm",
    "rmsnorm",
    "softcap",
    "rope",
    "init_attention",
    "attention",
    "attention_decode",
    "init_kv_cache",
    "init_paged_kv_cache",
    "paged_prefill_update",
    "init_ffn",
    "ffn",
    "kan_ffn_specs",
    "kan_ffn_spec",
    "kan_ffn_hidden",
    "init_moe",
    "moe_capacity",
    "moe_route",
    "moe_combine",
    "moe",
]

ATTN_CHUNK = 1024  # query-chunk size of the memory-bounded "ref" attention

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# the ROADMAP items that port what is still refused
A7B = "A7b: recurrent layers (recurrentgemma, mamba2)"
A7C = "A7c: encoder and patch prefixes (whisper, pixtral)"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _normal(gen, shape, scale, dtype, device) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32 on ``device``, stored in ``dtype``."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


# ----------------------------------------------------------------------------
# misc
# ----------------------------------------------------------------------------


def init_rmsnorm(d: int, device=None) -> dict:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps: float):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])
    return y.to(x.dtype)


def softcap(x, cap: float):
    if cap and cap > 0.0:
        return torch.tanh(x / cap) * cap
    return x


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) int."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # the base filled on the device: a host-made tensor would cost a
    # host-to-device copy and a wait on every call
    freq = torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=x.device), exps)
    ang = positions[..., None].to(torch.float32) * freq  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Attention (GQA, causal; contiguous and paged KV caches)
# ----------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, *, device=None) -> dict:
    """Physical head counts may be PADDED (cfg.phys_heads); padded wo rows
    start at zero, so the logical function is the published one."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.phys_heads, cfg.phys_kv_heads
    dt = torch_dtype(cfg)
    sc = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (d, hq, hd), sc, dt, device),
        "wk": _normal(gen, (d, hkv, hd), sc, dt, device),
        "wv": _normal(gen, (d, hkv, hd), sc, dt, device),
    }
    wo = _normal(gen, (hq, hd, d), sc, dt, device)
    if hq != cfg.num_heads:  # zero the padded heads' output rows
        wo[cfg.num_heads:] = 0
    p["wo"] = wo
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((hkv, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((hkv, hd), dtype=dt, device=device)
    return p


def _proj(x, w):
    """(B, S, D) x (D, H, K) -> (B, S, H, K)."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).reshape(
        b, s, *w.shape[1:])


def _out_proj(o, wo):
    """(B, S, H, K) x (H, K, D) -> (B, S, D)."""
    b, s, h, k = o.shape
    return (o.reshape(b * s, h * k) @ wo.reshape(h * k, -1)).reshape(b, s, -1)


def _qkv(p, x, cfg: ModelConfig, use_rope: bool, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _masked_softmax(logits, mask):
    """Softmax over the last axis with an explicit validity mask; rows with
    no valid key give exact zeros (the guarded denominator)."""
    if mask is None:
        return torch.softmax(logits, dim=-1)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(logits - m), 0.0)
    return e / torch.clamp_min(e.sum(dim=-1, keepdim=True), 1e-30)


def _sdpa_chunk(qc, qpos, k, v, kpos, cfg: ModelConfig, kind: str):
    """One query chunk.  qc: (B, C, Hkv, G, D); qpos: (C,); k/v:
    (B, T, Hkv, D); kpos: (T,).  Masks are built from positions."""
    d = qc.shape[-1]
    logits = torch.einsum("bchgd,bthd->bhgct", qc.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(d)
    logits = softcap(logits, cfg.attn_logit_softcap)
    m = None
    if kind in ("global", "local"):
        m = kpos[None, :] <= qpos[:, None]                    # causal (C, T)
        if kind == "local" and cfg.window_size > 0:
            m = m & (kpos[None, :] > qpos[:, None] - cfg.window_size)
        m = m[None, None, None]
    probs = _masked_softmax(logits, m)
    return torch.einsum("bhgct,bthd->bchgd", probs.to(v.dtype), v)


# layers.py attention kinds -> kernels.attention mask kinds
_FLASH_KIND = {"global": "causal", "local": "local",
               "bidir": "full", "cross": "full"}


def _sdpa_flash(q, k, v, cfg: ModelConfig, kind: str, qpos, kpos):
    """Kernel B2 (backend "flash")."""
    from ..kernels.attention import flash_attention

    out = flash_attention(
        q, k, v, kind=_FLASH_KIND[kind], qpos=qpos, kpos=kpos,
        window=cfg.window_size, softcap=cfg.attn_logit_softcap,
    )
    return out.to(v.dtype)


def _sdpa_ref(q, k, v, cfg: ModelConfig, kind: str, qpos=None, kpos=None):
    """The chunked composition (backend "ref", the parity oracle).

    Sequences longer than ATTN_CHUNK run in query chunks; a remainder is
    PADDED to a full chunk (padded rows carry qpos = -1, are fully masked
    and give zeros)."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    if qpos is None:
        qpos = torch.arange(s, device=dev) + (t - s)
    if kpos is None:
        kpos = torch.arange(t, device=dev)
    qpos = torch.as_tensor(qpos, device=dev)
    kpos = torch.as_tensor(kpos, device=dev)

    if s <= ATTN_CHUNK:
        out = _sdpa_chunk(q.reshape(b, s, hkv, g, d), qpos, k, v, kpos,
                          cfg, kind)
        return out.reshape(b, s, hq, d)

    pad = (-s) % ATTN_CHUNK
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        qpos = F.pad(qpos, (0, pad), value=-1)
    outs = []
    for c0 in range(0, s + pad, ATTN_CHUNK):
        qc = q[:, c0:c0 + ATTN_CHUNK].reshape(b, ATTN_CHUNK, hkv, g, d)
        outs.append(_sdpa_chunk(qc, qpos[c0:c0 + ATTN_CHUNK], k, v, kpos,
                                cfg, kind))
    out = torch.cat(outs, dim=1).reshape(b, s + pad, hq, d)
    return out[:, :s]


def _sdpa(q, k, v, cfg: ModelConfig, kind: str, qpos=None, kpos=None,
          backend=None):
    """q: (B, S, Hq, D), k/v: (B, T, Hkv, D).  kind: global|local|bidir|
    cross.  Dispatches to the resolved attention backend: "ref" (chunked
    composition) or "flash" (kernel B2)."""
    from ..runtime.attention import ATTN_DISPATCH_COUNTS, resolve_attn_backend

    name = resolve_attn_backend(backend)
    ATTN_DISPATCH_COUNTS[name] += 1
    if name == "flash":
        return _sdpa_flash(q, k, v, cfg, kind, qpos, kpos)
    return _sdpa_ref(q, k, v, cfg, kind, qpos, kpos)


def attention(p, x, cfg: ModelConfig, kind: str, positions=None):
    """Full-sequence self-attention.  kind: global|local|bidir."""
    if kind not in ("global", "local", "bidir"):
        raise not_ported(f"attention kind {kind!r}", A7C)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _qkv(p, x, cfg, kind in ("global", "local"), positions)
    out = _sdpa(q, k, v, cfg, kind)
    return _out_proj(out, p["wo"])


def _sdpa_batch_masked(q, k, v, mask, cfg: ModelConfig):
    """Decode-path attention with a per-batch key mask: (B, T), one row
    shared by every query, or (B, S, T), one row per query (verify)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qr = q.reshape(b, s, hkv, g, d).to(torch.float32)
    logits = torch.einsum("bshgd,bthd->bhgst", qr, k.to(torch.float32))
    logits = logits / math.sqrt(d)
    logits = softcap(logits, cfg.attn_logit_softcap)
    if mask is None:
        m = None
    elif mask.ndim == 3:
        m = mask[:, None, None, :, :]          # (B, 1, 1, S, T)
    else:
        m = mask[:, None, None, None, :]       # (B, 1, 1, 1, T)
    probs = _masked_softmax(logits, m)
    out = torch.einsum("bhgst,bthd->bshgd", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, d)


def _sdpa_decode(q, k, v, cfg: ModelConfig, kind: str, qpos, kpos,
                 backend=None):
    """Decode-step attention from per-batch positions.

    q: (B, S, Hq, D), S=1 for one token, S=k+1 for the verify pass; k/v:
    (B, T, Hkv, D); qpos: (B, S); kpos: (B, T), -1 for unwritten slots.
    "ref" materializes the mask ((B, T) at S=1, (B, S, T) otherwise);
    "flash" hands the positions to kernel B2.  Both mask non-causal and
    unwritten slots."""
    from ..runtime.attention import ATTN_DISPATCH_COUNTS, resolve_attn_backend

    name = resolve_attn_backend(backend)
    ATTN_DISPATCH_COUNTS[name] += 1
    if name == "flash":
        fkind = "bidir" if kind in ("bidir", "cross") else "global"
        return _sdpa_flash(q, k, v, cfg, fkind, qpos, kpos)
    mask = None
    if kind not in ("bidir", "cross"):
        if qpos.shape[1] == 1:
            mask = (kpos >= 0) & (kpos <= qpos)                    # (B, T)
        else:
            mask = ((kpos[:, None, :] >= 0)
                    & (kpos[:, None, :] <= qpos[:, :, None]))      # (B, S, T)
    return _sdpa_batch_masked(q, k, v, mask, cfg)


def _put_rows(dst, idx: tuple, keep, src) -> None:
    """``dst[idx] = src`` IN PLACE for the rows where ``keep`` is true.

    JAX's ``.at[...].set(..., mode="drop")`` drops writes whose index is
    out of range; PyTorch indexing has no such mode and would fault, so the
    dropped rows are filtered out first."""
    idx = tuple(i[keep] for i in idx)
    dst.index_put_(idx, src[keep].to(dst.dtype))


def attention_decode(p, x, cache, pos, cfg: ModelConfig, kind: str,
                     block_table=None):
    """Decode-step attention.  x: (B, S, D), S=1 for one token, S=k+1 for
    the verify pass (positions pos..pos+S-1); cache {"k","v"}: (B, T, Hkv,
    D) contiguous, or with ``block_table`` ((B, nblk) int) the paged pool
    (NB, block_size, Hkv, D).  pos: (B,) int.  kind: global|local.  Writes
    the new K/V into the cache IN PLACE and returns (out, cache).

    Paged: each new row goes to pool block ``block_table[b, pos // bs]`` at
    offset ``pos % bs``; positions at or past the table's coverage are
    dropped.  The table then gathers a (B, nblk*bs, Hkv, D) view equal to
    the contiguous cache at every valid position; stale lanes are masked
    by ``kpos <= qpos``, so paged decode equals contiguous decode.

    Local with ``0 < window <= T`` (the rolling cache, T == window): one
    token per step, written to slot ``pos % T``; each slot's absolute
    position comes from :func:`_window_positions`, and causal + validity
    over the ring is the whole window predicate, since the ring holds only
    the last ``window`` positions."""
    if kind not in ("global", "local"):
        raise not_ported(f"decode attention kind {kind!r}", A7C)
    b, s = x.shape[:2]
    dev = x.device
    positions = pos.to(torch.int64)[:, None] + torch.arange(s, device=dev)
    q, k, v = _qkv(p, x, cfg, True, positions)
    bidx = torch.arange(b, device=dev)[:, None].expand(b, s)
    if block_table is not None:
        nb, bs = cache["k"].shape[:2]
        table = block_table.to(torch.int64)
        nblk = table.shape[1]
        pb = torch.clamp(positions // bs, 0, nblk - 1)
        keep = positions < nblk * bs
        blk = table[bidx, pb]
        off = positions % bs
        # retired slots all map to the scratch block; duplicate targets
        # race there, which is harmless (scratch lanes are never admitted)
        _put_rows(cache["k"], (blk, off), keep, k)
        _put_rows(cache["v"], (blk, off), keep, v)
        gk = cache["k"][table].reshape(b, nblk * bs, *cache["k"].shape[2:])
        gv = cache["v"][table].reshape(b, nblk * bs, *cache["v"].shape[2:])
        kpos = torch.arange(nblk * bs, device=dev)[None].expand(b, nblk * bs)
        out = _sdpa_decode(q, gk, gv, cfg, kind, positions, kpos)
        return _out_proj(out, p["wo"]), cache
    t = cache["k"].shape[1]
    if kind == "local" and 0 < cfg.window_size <= t:
        if s != 1:
            raise ValueError("the rolling-window cache decodes one token "
                             f"per step, got {s}")
        # every slot pos % t lies inside the ring: a plain index_put_
        slot = positions % t
        cache["k"].index_put_((bidx, slot), k.to(cache["k"].dtype))
        cache["v"].index_put_((bidx, slot), v.to(cache["v"].dtype))
        kpos = _window_positions(positions[:, 0], t, t)
    else:
        keep = positions < t
        _put_rows(cache["k"], (bidx, positions), keep, k)
        _put_rows(cache["v"], (bidx, positions), keep, v)
        kpos = torch.arange(t, device=dev)[None].expand(b, t)
    out = _sdpa_decode(q, cache["k"], cache["v"], cfg, kind, positions, kpos)
    return _out_proj(out, p["wo"]), cache


def _window_positions(pos, window: int, t: int):
    """Absolute position held by each rolling-cache slot, (B, T): the
    largest p' <= pos with p' % window == slot (negative: never written)."""
    slots = torch.arange(t, device=pos.device)[None, :]
    delta = ((pos % window)[:, None] - slots) % window
    return pos[:, None] - delta


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, kind: str,
                  *, device=None) -> dict:
    """One layer's contiguous KV cache, (B, T, Hkv, D): T = max_len, or the
    rolling window min(max_len, window) for "local" layers."""
    if kind not in ("global", "local"):
        raise not_ported(f"KV cache of kind {kind!r}", A7C)
    t = min(max_len, cfg.window_size) if kind == "local" else max_len
    shape = (batch, t, cfg.phys_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_paged_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                        *, device=None) -> dict:
    """One layer's paged KV pool: (NB, block_size, Hkv, D), no batch dim."""
    shape = (num_blocks, block_size, cfg.phys_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def paged_prefill_update(kv, k, v, block_table, start, real_end):
    """Scatter a B=1 prefill chunk's K/V into the paged pool (IN PLACE) and
    gather the request's whole contiguous view back.

    kv {"k","v"}: (NB, bs, Hkv, D); k/v: (1, C, Hkv, D); block_table:
    (nblk,) pool ids; chunk row j holds position ``start + j``, and rows at
    positions >= ``real_end`` are bucket padding whose writes are DROPPED,
    so pad garbage never lands in a block another request shares.
    Returns (kv, gathered_k, gathered_v), gathered (1, nblk*bs, Hkv, D)."""
    bs = kv["k"].shape[1]
    table = torch.as_tensor(block_table, device=k.device).to(torch.int64)
    nblk = table.shape[0]
    c = k.shape[1]
    p = int(start) + torch.arange(c, device=k.device)
    pb = torch.clamp(p // bs, 0, nblk - 1)
    keep = p < int(real_end)
    _put_rows(kv["k"], (table[pb], p % bs), keep, k[0])
    _put_rows(kv["v"], (table[pb], p % bs), keep, v[0])
    gk = kv["k"][table].reshape(1, nblk * bs, *kv["k"].shape[2:])
    gv = kv["v"][table].reshape(1, nblk * bs, *kv["v"].shape[2:])
    return kv, gk, gv


# ----------------------------------------------------------------------------
# FFN: SwiGLU / GeLU / KAN
# ----------------------------------------------------------------------------


def init_ffn(gen, cfg: ModelConfig, *, device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg)
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f) if f else 0.0
    if cfg.ffn_kind == "swiglu":
        return {"wi": _normal(gen, (d, f), sc_in, dt, device),
                "wg": _normal(gen, (d, f), sc_in, dt, device),
                "wo": _normal(gen, (f, d), sc_out, dt, device)}
    if cfg.ffn_kind == "gelu":
        return {"wi": _normal(gen, (d, f), sc_in, dt, device),
                "wo": _normal(gen, (f, d), sc_out, dt, device)}
    if cfg.ffn_kind == "kan":
        nb = cfg.kan_grid + cfg.kan_order
        h = kan_ffn_hidden(cfg)
        # KANLinear pair d -> h -> d; c: (in, nb, out), w_b: (in, out)
        return {
            "c1": _normal(gen, (d, nb, h), 0.1 / math.sqrt(d), dt, device),
            "wb1": _normal(gen, (d, h), sc_in, dt, device),
            "c2": _normal(gen, (h, nb, d), 0.1 / math.sqrt(h), dt, device),
            "wb2": _normal(gen, (h, d), 1.0 / math.sqrt(h), dt, device),
        }
    if cfg.ffn_kind == "none":
        return {}
    raise ValueError(cfg.ffn_kind)


def kan_ffn_specs(cfg: ModelConfig) -> tuple:
    """Per-half ASPQuantSpecs of a KAN-FFN block (the d -> h -> d pair):
    ``cfg.kan_layer_bits`` (one width per half) overrides the uniform
    ``cfg.kan_n_bits``; each half's lut_bits is clipped to its width."""
    bits = resolve_layer_bits(
        cfg.kan_layer_bits if cfg.kan_layer_bits else cfg.kan_n_bits,
        2, cfg.kan_grid,
    )
    return tuple(
        ASPQuantSpec(grid_size=cfg.kan_grid, order=cfg.kan_order, n_bits=b,
                     lut_bits=min(cfg.kan_n_bits, b), lo=-1.0, hi=1.0)
        for b in bits
    )


def kan_ffn_spec(cfg: ModelConfig) -> ASPQuantSpec:
    """First-half spec (the bit-independent grid geometry)."""
    return kan_ffn_specs(cfg)[0]


def kan_ffn_hidden(cfg: ModelConfig) -> int:
    """KANLinear hidden width of a KAN-FFN block (the one rule)."""
    nb = cfg.kan_grid + cfg.kan_order
    return cfg.kan_d_hidden or max(1, cfg.d_ff // nb)


def _bump_basis_and_grad(z, lo: float, hi: float, grid_size: int,
                         order: int):
    """Cardinal-bump basis AND d(basis)/dz at z, both (..., G+K) f32.

    The basis is :func:`bspline_basis_fast`'s, bit for bit; the derivative
    is zero where the clip to the grid is active (``interior``), as the
    reference's ``_bump_basis_and_grad`` has it."""
    h = (hi - lo) / grid_size
    r = (z - lo) / h
    tau = torch.clamp(r, 0.0, grid_size * (1 - 1e-7))
    interior = (r > 0.0) & (r < grid_size)
    g = torch.floor(tau)
    u = tau - g
    g = g.to(torch.int32)
    coeffs = _cardinal_bump_coeffs(order)
    nb = grid_size + order
    iota = torch.arange(nb, dtype=torch.int32, device=z.device)
    basis = torch.zeros(z.shape + (nb,), dtype=torch.float32, device=z.device)
    dbasis = torch.zeros_like(basis)
    for d in range(order + 1):
        seg = order - d
        val = torch.zeros_like(u)
        dval = torch.zeros_like(u)
        for p in reversed(range(order + 1)):  # simultaneous Horner: p, p'
            dval = dval * u + val
            val = val * u + float(coeffs[seg, p])
        hit = iota == (g + d)[..., None]
        basis = basis + torch.where(hit, val[..., None], 0.0)
        dbasis = dbasis + torch.where(hit, dval[..., None], 0.0)
    dbasis = dbasis * (interior[..., None] / h)  # clip grad + chain rule
    return basis, dbasis


class _SplineMM(torch.autograd.Function):
    """y = basis(tanh(x)) . c over (..., F) -> (..., O), with the
    reference's custom VJP (``_spline_mm_bwd``): only x and c are saved,
    and the backward rebuilds the basis and its derivative, contracts the
    basis axis at once (dc, and dz per input feature) and applies the
    tanh chain.  Autograd through :func:`bspline_basis_fast` would save
    the (..., F, G+K) one-hot intermediates of every layer instead, and
    its clamp would pass a gradient where a value sits on the clip edge."""

    @staticmethod
    def forward(ctx, x, c, lo, hi, grid_size, order):
        basis = bspline_basis_fast(torch.tanh(x.to(torch.float32)), lo, hi,
                                   grid_size, order)
        f, nb = basis.shape[-2:]
        y = basis.to(c.dtype).reshape(-1, f * nb) @ c.reshape(f * nb, -1)
        ctx.save_for_backward(x, c)
        ctx.spec = (lo, hi, grid_size, order)
        return y.reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, dy):
        x, c = ctx.saved_tensors
        z = torch.tanh(x.to(torch.float32))
        basis, dbasis = _bump_basis_and_grad(z, *ctx.spec)
        f, nb, o = c.shape
        dy2 = dy.reshape(-1, o)
        dx = dc = None
        if ctx.needs_input_grad[1]:
            dc = (basis.to(dy.dtype).reshape(-1, f * nb).T @ dy2).reshape(
                f, nb, o).to(c.dtype)
        if ctx.needs_input_grad[0]:
            t = (dy2 @ c.reshape(f * nb, o).T).to(torch.float32)
            dz = torch.sum(t.reshape(dbasis.shape) * dbasis, dim=-1)
            dx = (dz * (1.0 - z * z)).to(x.dtype)  # tanh chain
        return dx, dc, None, None, None, None


def _kan_linear(c, wb, x, cfg: ModelConfig):
    """Float KANLinear over (B, S, in): cardinal-bump basis of tanh(x),
    banded basis matmul (:class:`_SplineMM`, the reference's custom VJP),
    plus the ReLU branch on the raw input."""
    spec = kan_ffn_spec(cfg)
    y = _SplineMM.apply(x, c, spec.lo, spec.hi, spec.grid_size, spec.order)
    return y + torch.relu(x) @ wb


def ffn(p, x, cfg: ModelConfig):
    if cfg.ffn_kind == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    if cfg.ffn_kind == "gelu":
        return F.gelu(x @ p["wi"], approximate="tanh") @ p["wo"]
    if cfg.ffn_kind == "kan":
        if "l1" in p:
            # ASP-quantized deployed block: both halves through kernel B1
            from ..core.kan_ffn_deploy import kan_ffn_apply_quantized

            return kan_ffn_apply_quantized(p, x, cfg)
        h = _kan_linear(p["c1"], p["wb1"], x, cfg)
        return _kan_linear(p["c2"], p["wb2"], h, cfg)
    if cfg.ffn_kind == "none":
        return torch.zeros_like(x)
    raise ValueError(cfg.ffn_kind)


# ----------------------------------------------------------------------------
# MoE: top-k routing, capacity drop, expert batches
# ----------------------------------------------------------------------------


def init_moe(gen, cfg: ModelConfig, *, device=None) -> dict:
    """Router (D, E) in f32 and SwiGLU experts wi / wg (E, D, F), wo
    (E, F, D) in the config's dtype."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = torch_dtype(cfg)
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "router": _normal(gen, (d, e), sc_in, torch.float32, device),
        "wi": _normal(gen, (e, d, f), sc_in, dt, device),
        "wg": _normal(gen, (e, d, f), sc_in, dt, device),
        "wo": _normal(gen, (e, f, d), sc_out, dt, device),
    }


def moe_capacity(t: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``t`` routed tokens, from static shapes."""
    return int(max(1, math.ceil(t * cfg.num_experts_per_tok
                                * cfg.moe_capacity_factor / cfg.num_experts)))


def moe_route(p, xt, cfg: ModelConfig):
    """Route (T, D) tokens: top-k of the f32 router logits (lower expert
    first on ties, as ``lax.top_k``), softmax over the chosen, and each
    assignment's rank within its expert in token order.  Returns
    ``(flat_e, flat_g, pos, cap)``: (T*k,) expert ids, gates and ranks, and
    the capacity; an assignment with ``pos >= cap`` is dropped.

    Two lowerings of the rank (``cfg.moe_dispatch``), equal in result:
    "sort", a stable argsort and ``searchsorted(side="left")``; "cumsum",
    one-hot prefix sums.  Every index is computed on the device."""
    t = xt.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = xt.to(torch.float32) @ p["router"]
    # a stable descending sort keeps the lower index first among equal
    # logits; torch.topk promises no order for ties
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(topv[:, :k], dim=-1)
    flat_e = topi[:, :k].reshape(t * k)
    flat_g = gates.reshape(t * k)
    if cfg.moe_dispatch == "sort":
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        first = torch.searchsorted(sorted_e, sorted_e, side="left")
        ranks = torch.arange(t * k, device=xt.device) - first
        pos = torch.empty_like(ranks).scatter_(0, order, ranks)
    else:
        onehot = (flat_e[:, None] == torch.arange(e, device=xt.device)).to(
            torch.int32)                                    # (T*k, E)
        pos = torch.cumsum(onehot, dim=0) - 1      # rank per expert, int64
        pos = pos.gather(1, flat_e[:, None])[:, 0]
    return flat_e, flat_g, pos, moe_capacity(t, cfg)


def moe_combine(contrib, dtype):
    """Sum each token's k gated expert outputs, (T, k, D) -> (T, D), in
    index order and in ``dtype`` (each partial sum rounded to it).

    The reference scatter-adds them into zeros of the activations' dtype
    (``.at[tok_id].add`` with ``tok_id = repeat(arange(T), k)``: a token's
    k rows are contiguous); ``index_add_`` on the card would add them in an
    order that changes from run to run, and in bf16 the order shows."""
    out = torch.zeros((contrib.shape[0], contrib.shape[2]), dtype=dtype,
                      device=contrib.device)
    for j in range(contrib.shape[1]):
        out = out + contrib[:, j].to(dtype)
    return out


def moe(p, x, cfg: ModelConfig):
    """Top-k MoE over (B, S, D): tokens scattered into (E, cap, D) expert
    batches (dropped assignments to an extra row ``E*cap``, cut off), the
    SwiGLU experts as batched matmuls, the gate multiplied in the experts'
    dtype and the k outputs of a token summed by :func:`moe_combine`."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = b * s
    xt = x.reshape(t, d)
    flat_e, flat_g, pos, cap = moe_route(p, xt, cfg)
    dest = torch.where(pos < cap, flat_e * cap + pos, e * cap)
    # repeat(arange(T), k): a token's k assignments are contiguous
    tok_id = torch.arange(t, device=x.device)[:, None].expand(t, k).reshape(
        t * k)
    # kept destinations are distinct; the dropped ones race on row e*cap
    xe = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    xe = xe.index_put((dest,), xt[tok_id])[:e * cap].reshape(e, cap, d)
    h = torch.bmm(xe, p["wi"])
    g = torch.bmm(xe, p["wg"])
    ye = torch.bmm(F.silu(g) * h, p["wo"])
    ye_flat = torch.cat([ye.reshape(e * cap, d),
                         torch.zeros((1, d), dtype=ye.dtype, device=x.device)])
    contrib = ye_flat[dest] * flat_g[:, None].to(ye.dtype)
    return moe_combine(contrib.reshape(t, k, d), x.dtype).reshape(b, s, d)
