"""Layers of the transformer stacks: norms, RoPE and sinusoidal positions,
GQA attention (causal, sliding-window, bidirectional and cross) with
contiguous, rolling-window and paged KV caches, latent attention (MLA)
over a latent cache, the SwiGLU / GeLU / KAN FFNs, the top-k MoE FFN and
the dropless routed MoE (sigmoid router, shared experts, SwiGLU or KAN
experts), and the recurrent blocks: RG-LRU (RecurrentGemma) and Mamba-2's
SSD.

MLA and the routed MoE are the port's own (the reference package has
neither): DeepSeek-V2's latent attention (arXiv:2405.04434 §2.1) without
q-LoRA, and DeepSeek-V3's bias-steered sigmoid router (arXiv:2412.19437
§2.1.2), as ``modeling_deepseek.py`` computes them.

Port of ``repro.models.layers``.  Params are
plain nested dicts of tensors; init functions take an explicit
``torch.Generator`` and ``device``.  Activations are (B, S, D) in the
config's dtype, with reductions and softmax in f32, following the
reference's casts one by one.  KV caches are updated IN PLACE (the
reference returns new arrays; an in-place ``index_put_`` saves a copy of
the whole cache per layer and step) and returned as the same objects.

Tensor parallelism (a mesh's ``"model"`` axis): under the
``dist.comm.TPLayout`` that ``models.model.place_params`` recorded and the
engine or the train step binds with ``dist.comm.use_tp``, a layer whose
role was cut (query / KV heads, FFN or expert hidden columns) runs on its
local slab and sums the partial output over the group, through the
collectives of ``dist.comm`` that carry gradients (f at the cut region's
input, g after it), so the same code trains.  Where the query heads are
cut and the KV heads are not, each rank projects only the KV heads its
query heads read (:func:`kv_head_index`).  Under
``dist.comm.use_row_split`` MoE routes this rank's rows as its slab of the
batch split over "data".

The recurrent blocks return their new state (conv rows in the config's
dtype, the recurrence in f32) and the stack writes it into its cache in
place.  Cross attention reads its K/V from the encoder output (full
sequence) or from the cross cache the prefill wrote (decode).  The
reference's ``_grad_safe_barrier`` is an XLA scheduling hint and has
no counterpart here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.asp_quant import ASPQuantSpec, resolve_layer_bits
from ..core.bspline import _cardinal_bump_coeffs, bspline_basis_fast
from ..dist import comm
from ..kernels.attention.ref import NEG_INF
from ..obs.trace import profile_scope

__all__ = [
    "ATTN_CHUNK",
    "torch_dtype",
    "init_rmsnorm",
    "rmsnorm",
    "softcap",
    "rope",
    "sinusoidal_positions",
    "init_attention",
    "attention",
    "attention_decode",
    "init_kv_cache",
    "init_paged_kv_cache",
    "kv_head_index",
    "local_kv_heads",
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
    "moe_dispatch",
    "moe_experts",
    "moe_gather",
    "moe",
    "routed_moe",
    "route_sigmoid",
    "init_routed_moe",
    "rope_pairs",
    "init_mla",
    "mla_attention",
    "mla_attention_decode",
    "mla_absorbed",
    "init_rglru",
    "rglru",
    "rglru_prefill",
    "init_rglru_state",
    "init_mamba2",
    "mamba2",
    "mamba2_prefill",
    "init_mamba2_state",
]

ATTN_CHUNK = 1024  # query-chunk size of the memory-bounded "ref" attention

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


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


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) f32 position table: sin of pos / 10000^(2i/d) over the first
    half of the features, cos over the second (the encoder's)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    base = torch.full((), 10000.0, dtype=torch.float32, device=device)
    ang = pos / torch.pow(base, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------------------
# Attention (GQA; causal / local / bidirectional / cross; KV caches)
# ----------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, *, cross: bool = False,
                   device=None) -> dict:
    """Physical head counts may be PADDED (cfg.phys_heads); padded wo rows
    start at zero, so the logical function is the published one.  A
    ``cross`` attention has no QKV bias.  An MLA config draws
    :func:`init_mla`'s params instead."""
    if cfg.mla and not cross:
        return init_mla(gen, cfg, device=device)
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
    if cfg.qkv_bias and not cross:
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
    """(B, S, H, K) x (H, K, D) -> (B, S, D); with the heads cut over the
    tensor-parallel group (row-parallel ``wo``) the partial outputs are
    summed over it."""
    b, s, h, k = o.shape
    y = (o.reshape(b * s, h * k) @ wo.reshape(h * k, -1)).reshape(b, s, -1)
    tp = comm.tp_layout()
    return comm.tp_reduce(y, tp.group) if tp.heads else y


def _tp_enter(x, cut: bool):
    """``x`` entering weights cut on their output dim (``cut``): its
    gradient is summed over the tensor-parallel group."""
    return comm.tp_copy(x, comm.tp_layout().group) if cut else x


def kv_head_index(cfg: ModelConfig, tp: comm.TPLayout):
    """The KV heads this rank attends with where the bound layout cut the
    query heads but not the KV heads: a ``slice`` where its query heads
    cover whole groups of ``G = Hq / Hkv`` (``Hkv' = Hq' / G``) or fall
    inside one group (one KV head, ``G' = Hq'``), else one KV head per
    query head (``G' = 1``), a list of indices ``h // G``."""
    g = cfg.phys_heads // cfg.phys_kv_heads
    hq = cfg.phys_heads // tp.size
    h0 = tp.rank * hq
    if hq % g == 0:
        return slice(h0 // g, (h0 + hq) // g)
    if g % hq == 0:
        return slice(h0 // g, h0 // g + 1)
    return [(h0 + j) // g for j in range(hq)]


def local_kv_heads(cfg: ModelConfig) -> int:
    """KV heads this rank holds: its slab when the bound layout cut them,
    the heads its query heads read when it cut the query heads alone,
    else all of them."""
    tp = comm.tp_layout()
    if tp.kv:
        return cfg.phys_kv_heads // tp.size
    if tp.heads:
        idx = kv_head_index(cfg, tp)
        return len(range(cfg.phys_kv_heads)[idx]) \
            if isinstance(idx, slice) else len(idx)
    return cfg.phys_kv_heads


def _kv_local(w, cfg: ModelConfig):
    """A whole KV-head weight or bias (heads on dim -2) -> the heads this
    rank's query heads read (see :func:`kv_head_index`), so the projection
    computes only those; every rank's gradient of the whole tensor is
    summed over the group, so ``wk`` / ``wv`` / ``bk`` / ``bv``
    (replicated) get all of it."""
    tp = comm.tp_layout()
    w = comm.tp_copy(w, tp.group)
    idx = kv_head_index(cfg, tp)
    if isinstance(idx, slice):
        return w[..., idx, :]
    return torch.cat([w[..., h:h + 1, :] for h in idx], dim=-2)


def _kv_of(p, x, cfg: ModelConfig, xin=None):
    """K and V (B, S, Hkv', D) of ``x`` (biases added, no RoPE) for this
    rank; ``xin`` is ``x`` already entered into the cut heads."""
    tp = comm.tp_layout()
    wk, wv, bk, bv = p["wk"], p["wv"], p.get("bk"), p.get("bv")
    if tp.kv or tp.heads:
        x = _tp_enter(x, True) if xin is None else xin
    if tp.heads and not tp.kv:
        wk, wv = _kv_local(wk, cfg), _kv_local(wv, cfg)
        if bk is not None:
            bk, bv = _kv_local(bk, cfg), _kv_local(bv, cfg)
    k, v = _proj(x, wk), _proj(x, wv)
    if bk is not None:
        k, v = k + bk, v + bv
    return k, v


def _q_of(p, x, xin=None):
    """The query heads of ``x`` this rank holds (bias added, no RoPE)."""
    if xin is None:
        xin = _tp_enter(x, comm.tp_layout().heads)
    q = _proj(xin, p["wq"])
    return q + p["bq"] if "bq" in p else q


def _qkv(p, x, cfg: ModelConfig, use_rope: bool, positions):
    xin = _tp_enter(x, comm.tp_layout().heads)
    q = _q_of(p, x, xin)
    k, v = _kv_of(p, x, cfg, xin)
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
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
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
        return out.reshape(b, s, hq, dv)

    pad = (-s) % ATTN_CHUNK
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        qpos = F.pad(qpos, (0, pad), value=-1)
    outs = []
    for c0 in range(0, s + pad, ATTN_CHUNK):
        qc = q[:, c0:c0 + ATTN_CHUNK].reshape(b, ATTN_CHUNK, hkv, g, d)
        outs.append(_sdpa_chunk(qc, qpos[c0:c0 + ATTN_CHUNK], k, v, kpos,
                                cfg, kind))
    out = torch.cat(outs, dim=1).reshape(b, s + pad, hq, dv)
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


def attention(p, x, cfg: ModelConfig, kind: str, positions=None,
              enc_out=None):
    """Full-sequence attention.  kind: global|local|bidir|cross; "cross"
    takes q from ``x`` and k / v from ``enc_out`` (B, T, D), without RoPE,
    and "bidir" has no RoPE either."""
    b, s, _ = x.shape
    if cfg.mla and kind != "cross":
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        return mla_attention(p, x, cfg, positions)[0]
    if kind == "cross":
        q = _q_of(p, x)
        k, v = _kv_of(p, enc_out, cfg)
    else:
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
    unwritten slots; kind "bidir" / "cross" (qpos and kpos None) admits
    every key of the cache (B2's "full" mask)."""
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
    if dst.is_meta:
        # a meta tensor holds no values to filter by (the filter's nonzero
        # has no meta kernel): the dry-run writes every row
        dst.index_put_(idx, src.to(dst.dtype))
        return
    idx = tuple(i[keep] for i in idx)
    dst.index_put_(idx, src[keep].to(dst.dtype))


def _put_row_each(dst, pos, src) -> None:
    """``dst[b, pos[b]] = src[b]`` IN PLACE for every b with ``pos[b] <
    dst.shape[1]``, the others dropped, without reading ``pos`` on the
    host (so a decode step can be captured in a CUDA graph): a dropped row
    writes back what its clamped position holds."""
    t = dst.shape[1]
    at = pos.clamp(max=t - 1)
    b = torch.arange(dst.shape[0], device=dst.device)
    keep = (pos < t)[:, None]
    dst[b, at] = torch.where(keep, src.to(dst.dtype), dst[b, at])


def attention_decode(p, x, cache, pos, cfg: ModelConfig, kind: str,
                     block_table=None):
    """Decode-step attention.  x: (B, S, D), S=1 for one token, S=k+1 for
    the verify pass (positions pos..pos+S-1); cache {"k","v"}: (B, T, Hkv,
    D) contiguous, or with ``block_table`` ((B, nblk) int) the paged pool
    (NB, block_size, Hkv, D).  pos: (B,) int.  kind: global|local|cross.
    Writes the new K/V into the cache IN PLACE and returns (out, cache).

    Cross: q from ``x`` against the cross cache's K/V, which the prefill
    computed from the encoder output; the cache is only read, and every
    key is admitted.

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
    if kind == "cross":
        q = _q_of(p, x)
        out = _sdpa_decode(q, cache["k"], cache["v"], cfg, "cross", None,
                           None)
        return _out_proj(out, p["wo"]), cache
    if cfg.mla:
        if block_table is not None:
            raise ValueError("MLA's latent cache is contiguous only")
        return mla_attention_decode(p, x, cache, pos, cfg)
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
    t = min(max_len, cfg.window_size) if kind == "local" else max_len
    dt = torch_dtype(cfg)
    if cfg.mla and kind != "cross":
        # the latent cache: c and the rotated shared key, (B, T, r + dr)
        return {"ckv": torch.zeros(
            (batch, t, cfg.kv_lora_rank + cfg.qk_rope_head_dim), dtype=dt,
            device=device)}
    shape = (batch, t, local_kv_heads(cfg), cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_paged_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                        *, device=None) -> dict:
    """One layer's paged KV pool: (NB, block_size, Hkv, D), no batch dim."""
    shape = (num_blocks, block_size, local_kv_heads(cfg), cfg.head_dim)
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
# Latent attention (MLA): expanded at prefill, absorbed at decode
# ----------------------------------------------------------------------------


def init_mla(gen, cfg: ModelConfig, *, device=None) -> dict:
    """MLA without q-LoRA, published layout: ``wq`` (D, H, dn + dr) (each
    head's no-rope part, then its rotary part), ``wkva`` (D, r + dr) (the
    latent c, then the rotary key shared by all heads), ``kv_norm`` the
    latent's RMSNorm, ``wkvb`` (r, H, dn + dv) (each head's key part, then
    its value) and ``wo`` (H, dv, D)."""
    d, h = cfg.d_model, cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, r = cfg.v_head_dim, cfg.kv_lora_rank
    dt = torch_dtype(cfg)
    sc = 1.0 / math.sqrt(d)
    return {
        "wq": _normal(gen, (d, h, dn + dr), sc, dt, device),
        "wkva": _normal(gen, (d, r + dr), sc, dt, device),
        "kv_norm": init_rmsnorm(r, device=device),
        "wkvb": _normal(gen, (r, h, dn + dv), 1.0 / math.sqrt(r), dt, device),
        "wo": _normal(gen, (h, dv, d), 1.0 / math.sqrt(h * dv), dt, device),
    }


def rope_pairs(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding on the pairs (x[2i], x[2i+1]) at frequency i, as
    the published DeepSeek code applies it (it de-interleaves, then rotates
    the halves); the result is in that de-interleaved order.  x: (B, S, H,
    D)."""
    return rope(torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1), positions,
                theta)


def _mla_latent(p, x, cfg: ModelConfig, positions):
    """(q_nope (B, S, H, dn), rotated q_pe (B, S, H, dr), the cache rows
    (B, S, r + dr): the normed latent c, then the rotated shared key)."""
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    q = _proj(x, p["wq"])
    q_pe = rope_pairs(q[..., dn:], positions, cfg.rope_theta)
    kva = x @ p["wkva"]
    c = rmsnorm(p["kv_norm"], kva[..., :r], cfg.norm_eps)
    k_pe = rope_pairs(kva[..., None, r:], positions, cfg.rope_theta)[:, :, 0]
    return q[..., :dn], q_pe, torch.cat([c, k_pe], dim=-1)


def _mla_expand(p, ckv, cfg: ModelConfig):
    """The expanded K (B, T, H, dn + dr) and V (B, T, H, dv) of latent
    cache rows ``ckv`` (B, T, r + dr)."""
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    kv = _proj(ckv[..., :r], p["wkvb"])
    b, t, h, _ = kv.shape
    k_pe = ckv[:, :, None, r:].expand(b, t, h, cfg.qk_rope_head_dim)
    return torch.cat([kv[..., :dn], k_pe], dim=-1), kv[..., dn:]


def mla_attention(p, x, cfg: ModelConfig, positions):
    """Causal MLA over the whole sequence in the expanded form: q . k over
    dn + dr dims at scale 1/sqrt(dn + dr), v of dv.  Returns (out (B, S,
    D), the latent cache rows (B, S, r + dr)).  Backend "flash" runs kernel
    B2 at the smallest of its head dims that holds dn + dr (256 for
    Moonlight's 192): q and k zero-padded past dn + dr (their products
    unchanged), v past dv (its extra outputs dropped); "ref" the chunked
    composition."""
    from ..runtime.attention import ATTN_DISPATCH_COUNTS, resolve_attn_backend

    q_nope, q_pe, ckv = _mla_latent(p, x, cfg, positions)
    k, v = _mla_expand(p, ckv, cfg)
    q = torch.cat([q_nope, q_pe], dim=-1)
    name = resolve_attn_backend()
    ATTN_DISPATCH_COUNTS[name] += 1
    qpos = positions[0]
    if name == "flash":
        from ..kernels.attention import SUPPORTED_HEAD_DIMS, flash_attention

        dqk, dv = q.shape[-1], v.shape[-1]
        d = min(n for n in SUPPORTED_HEAD_DIMS if n >= dqk)
        out = flash_attention(
            F.pad(q, (0, d - dqk)), F.pad(k, (0, d - dqk)),
            F.pad(v, (0, d - dv)), kind="causal", qpos=qpos, kpos=qpos,
            scale=1.0 / math.sqrt(dqk))[..., :dv]
    else:
        out = _sdpa_ref(q, k, v, cfg, "global", qpos=qpos, kpos=qpos)
    return _out_proj(out.to(x.dtype), p["wo"]), ckv


def _bmm_f32(a, b):
    """``a @ b`` batched with a float32 result: the card's bfloat16 GEMM
    accumulates in float32 and keeps it (``out_dtype``); elsewhere the
    operands are taken to float32 first."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def mla_absorbed(p, q_nope, q_pe, ckv, positions, cfg: ModelConfig):
    """Attention of the queries at ``positions`` (B, S) over the latent
    cache ``ckv`` (B, T, r + dr) in the absorbed form, without expanding K
    or V: q_nope . W_UK into the latent (f32), scores against c plus q_pe .
    k_pe, a causal softmax in f32, the probabilities' weighted sum of c,
    then W_UV.  Backend "flash" attends with B2's latent instance
    (``kernels.attention.mla_attention``: every head over the one latent
    head, each cached row read once, up to the query's position); "ref"
    with batched products over every cache row (float32 out).  Returns (B,
    S, H, dv) f32."""
    from ..runtime.attention import resolve_attn_backend

    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    dr = cfg.qk_rope_head_dim
    b, s, h, _ = q_nope.shape
    t = ckv.shape[1]
    w = p["wkvb"].to(torch.float32)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.to(torch.float32),
                         w[..., :dn])
    qc = torch.cat([q_lat, q_pe.to(torch.float32)], dim=-1).to(ckv.dtype)
    scale = 1.0 / math.sqrt(dn + dr)
    if resolve_attn_backend() == "flash":
        from ..kernels.attention import mla_attention

        o_lat = mla_attention(qc, ckv, positions, dv=r, scale=scale)
    else:
        scores = _bmm_f32(qc.reshape(b, s * h, r + dr),
                          ckv.transpose(1, 2)) * scale
        kpos = torch.arange(t, device=ckv.device)
        mask = (kpos[None, None, :] <= positions[:, :, None])[:, :, None, :]
        probs = _masked_softmax(scores.reshape(b, s, h, t), mask)
        o_lat = _bmm_f32(probs.reshape(b, s * h, t).to(ckv.dtype),
                         ckv[..., :r]).reshape(b, s, h, r)
    return torch.einsum("bshr,rhd->bshd", o_lat, w[..., dn:])


def mla_attention_decode(p, x, cache, pos, cfg: ModelConfig):
    """A decode (S = 1) or verify (S = k + 1) step of MLA over the
    contiguous latent cache {"ckv": (B, T, r + dr)}: the new rows are
    written IN PLACE at pos..pos+S-1 (positions past T dropped), and the
    queries attend in the absorbed form (:func:`mla_absorbed`, under the
    ``model.mla.attend`` range).  Returns (out (B, S, D), cache)."""
    b, s = x.shape[:2]
    dev = x.device
    positions = pos.to(torch.int64)[:, None] + torch.arange(s, device=dev)
    q_nope, q_pe, new = _mla_latent(p, x, cfg, positions)
    ckv = cache["ckv"]
    if s == 1:
        _put_row_each(ckv, positions[:, 0], new[:, 0])
    else:
        bidx = torch.arange(b, device=dev)[:, None].expand(b, s)
        _put_rows(ckv, (bidx, positions), positions < ckv.shape[1], new)
    with profile_scope("model.mla.attend"):
        out = mla_absorbed(p, q_nope, q_pe, ckv, positions, cfg)
    return _out_proj(out.to(x.dtype), p["wo"]), cache


# ----------------------------------------------------------------------------
# FFN: SwiGLU / GeLU / KAN
# ----------------------------------------------------------------------------


def init_ffn(gen, cfg: ModelConfig, *, device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg)
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f) if f else 0.0
    if cfg.ffn_kind == "swiglu":
        return _init_swiglu(gen, d, f, dt, device)
    if cfg.ffn_kind == "gelu":
        return {"wi": _normal(gen, (d, f), sc_in, dt, device),
                "wo": _normal(gen, (f, d), sc_out, dt, device)}
    if cfg.ffn_kind == "kan":
        return _init_kan_pair(gen, d, kan_ffn_hidden(cfg),
                              cfg.kan_grid + cfg.kan_order, dt, device)
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


def _tp_sum(y):
    """Sum a partial output over the tensor-parallel group when the bound
    layout cut the FFN hidden dim it was contracted over."""
    tp = comm.tp_layout()
    return comm.tp_reduce(y, tp.group) if tp.ffn else y


def ffn(p, x, cfg: ModelConfig):
    """The FFN sublayer.  A float block whose hidden columns are a
    tensor-parallel slab sums its output over the group; a deployed
    KAN-FFN block runs on the runtime's mesh (its columns on "model")."""
    if cfg.ffn_kind == "kan" and "l1" in p:
        # ASP-quantized deployed block: both halves through kernel B1
        from ..core.kan_ffn_deploy import kan_ffn_apply_quantized

        return kan_ffn_apply_quantized(p, x, cfg)
    if cfg.ffn_kind == "none":
        return torch.zeros_like(x)
    x = _tp_enter(x, comm.tp_layout().ffn)
    if cfg.ffn_kind == "swiglu":
        y = (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
        return _tp_sum(y)
    if cfg.ffn_kind == "gelu":
        y = F.gelu(x @ p["wi"], approximate="tanh") @ p["wo"]
        return _tp_sum(y)
    if cfg.ffn_kind == "kan":
        h = _kan_linear(p["c1"], p["wb1"], x, cfg)
        y = _kan_linear(p["c2"], p["wb2"], h, cfg)
        return _tp_sum(y)
    raise ValueError(cfg.ffn_kind)


# ----------------------------------------------------------------------------
# MoE: top-k routing, capacity drop, expert batches
# ----------------------------------------------------------------------------


def init_moe(gen, cfg: ModelConfig, *, device=None) -> dict:
    """Router (D, E) in f32 and SwiGLU experts wi / wg (E, D, F), wo
    (E, F, D) in the config's dtype; a routed config's layer is
    :func:`init_routed_moe`'s."""
    if cfg.routed_moe:
        return init_routed_moe(gen, cfg, device=device)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": _normal(gen, (d, e), 1.0 / math.sqrt(d), torch.float32,
                              device),
            **_init_swiglu(gen, d, f, torch_dtype(cfg), device, (e,))}


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
    one-hot prefix sums.  Every index is computed on the device.

    Under ``dist.comm.use_row_split`` the (T, D) rows are this rank's slab
    of a batch split over the group in rank order: the ranks all-gather
    their per-expert counts, each rank's ranks start after the lower
    ranks' counts, and the capacity is that of the whole batch, so every
    assignment keeps or drops as in the unsharded call."""
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
    group = comm.row_split_group()
    n = comm.group_size(group)
    if n > 1:
        # bincount's length depends on the values, so it has no meta
        # kernel; ids are < e, so on meta it is (e,)
        counts = (flat_e.new_empty((e,)) if flat_e.is_meta
                  else torch.bincount(flat_e, minlength=e))
        every = comm.all_gather(counts[None], group, 0)         # (n, E)
        pos = pos + every[:comm.group_rank(group)].sum(0)[flat_e]
        t = t * n  # the slabs are equal: the engine splits only then
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


def moe_dispatch(p, x, cfg: ModelConfig):
    """Route (B, S, D) and scatter the tokens into (E, cap, D) expert
    batches (dropped assignments to an extra row ``E*cap``, cut off).
    Returns ``(xe, dest, flat_g)``, ``dest`` (T*k,) each assignment's row
    of the expert batches (``E*cap`` where dropped)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = b * s
    xt = x.reshape(t, d)
    flat_e, flat_g, pos, cap = moe_route(p, xt, cfg)
    dest = torch.where(pos < cap, flat_e * cap + pos, e * cap)
    # repeat(arange(T), k): a token's k assignments are contiguous
    tok_id = torch.arange(t, device=x.device)[:, None].expand(t, k).reshape(
        t * k)
    # the experts' input enters their hidden columns when the layout cut
    # them (the router above reads the whole rows)
    xt = _tp_enter(xt, comm.tp_layout().moe)
    # kept destinations are distinct; the dropped ones race on row e*cap
    xe = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    xe = xe.index_put((dest,), xt[tok_id])[:e * cap].reshape(e, cap, d)
    return xe, dest, flat_g


def moe_experts(p, xe):
    """The SwiGLU experts as batched matmuls, (E, cap, D) -> (E, cap, D);
    with hidden columns cut, this rank's partial sum."""
    h = torch.bmm(xe, p["wi"])
    g = torch.bmm(xe, p["wg"])
    return torch.bmm(F.silu(g) * h, p["wo"])


def moe_gather(ye, dest, flat_g, shape, dtype):
    """Each assignment's expert output times its gate (in the experts'
    dtype; a dropped one reads zeros), the k of a token summed by
    :func:`moe_combine`: (B, S, D)."""
    b, s, d = shape
    t, e_cap = b * s, ye.shape[0] * ye.shape[1]
    ye_flat = torch.cat([ye.reshape(e_cap, d),
                         torch.zeros((1, d), dtype=ye.dtype, device=ye.device)])
    contrib = ye_flat[dest] * flat_g[:, None].to(ye.dtype)
    return moe_combine(contrib.reshape(t, -1, d), dtype).reshape(b, s, d)


def moe(p, x, cfg: ModelConfig):
    """Top-k MoE over (B, S, D): :func:`moe_dispatch`, :func:`moe_experts`
    and :func:`moe_gather`.  Where the layout cut the experts' hidden dim,
    each rank's partial expert outputs are summed over the group before
    the gates multiply them and a token's k rows are combined in order.
    A routed config's layer (``cfg.routed_moe``) runs
    :func:`routed_moe` instead."""
    if cfg.routed_moe:
        return routed_moe(p, x, cfg)
    xe, dest, flat_g = moe_dispatch(p, x, cfg)
    ye = moe_experts(p, xe)
    tp = comm.tp_layout()
    if tp.moe:
        ye = comm.tp_reduce(ye, tp.group)
    return moe_gather(ye, dest, flat_g, x.shape, x.dtype)



# ----------------------------------------------------------------------------
# Routed MoE (DeepSeek-V3): sigmoid router with a selection bias, dropless,
# shared experts; SwiGLU or KAN experts
# ----------------------------------------------------------------------------


def _init_kan_pair(gen, d: int, h: int, nb: int, dt, device,
                   lead: tuple = ()) -> dict:
    """A KANLinear pair d -> h -> d, c: (in, nb, out), w_b: (in, out),
    with leading dims ``lead`` (the experts)."""
    return {
        "c1": _normal(gen, lead + (d, nb, h), 0.1 / math.sqrt(d), dt, device),
        "wb1": _normal(gen, lead + (d, h), 1.0 / math.sqrt(d), dt, device),
        "c2": _normal(gen, lead + (h, nb, d), 0.1 / math.sqrt(h), dt, device),
        "wb2": _normal(gen, lead + (h, d), 1.0 / math.sqrt(h), dt, device),
    }


def _init_swiglu(gen, d: int, f: int, dt, device, lead: tuple = ()) -> dict:
    """SwiGLU wi / wg (d, f), wo (f, d), with leading dims ``lead``."""
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {"wi": _normal(gen, lead + (d, f), sc_in, dt, device),
            "wg": _normal(gen, lead + (d, f), sc_in, dt, device),
            "wo": _normal(gen, lead + (f, d), sc_out, dt, device)}


def init_routed_moe(gen, cfg: ModelConfig, *, device=None) -> dict:
    """Router (D, E) and, with ``router_bias``, the selection bias (E,) in
    f32 (it starts at zero), the E routed experts stacked on a leading axis
    and the shared experts as one MLP of ``num_shared_experts * moe_d_ff`` (``"shared"``):
    KAN-FFN pairs of ``kan_expert_hidden`` / ``kan_shared_hidden`` in a
    ``kan_variant()``, else SwiGLU."""
    d, e = cfg.d_model, cfg.num_experts
    dt = torch_dtype(cfg)
    f = cfg.moe_d_ff or cfg.d_ff
    p = {"router": _normal(gen, (d, e), 1.0 / math.sqrt(d), torch.float32,
                           device)}
    if cfg.router_bias:
        p["bias"] = torch.zeros((e,), dtype=torch.float32, device=device)
    if cfg.ffn_kind == "kan":
        nb = cfg.kan_grid + cfg.kan_order
        p.update(_init_kan_pair(gen, d, cfg.kan_expert_hidden, nb, dt,
                                device, (e,)))
        if cfg.num_shared_experts:
            p["shared"] = _init_kan_pair(gen, d, cfg.kan_shared_hidden, nb,
                                         dt, device)
    else:
        p.update(_init_swiglu(gen, d, f, dt, device, (e,)))
        if cfg.num_shared_experts:
            p["shared"] = _init_swiglu(gen, d, cfg.num_shared_experts * f,
                                       dt, device)
    return p


def route_sigmoid(p, xt, cfg: ModelConfig):
    """Route (T, D) tokens as DeepSeek-V3 with one expert group: scores s =
    sigmoid(x W_r) in f32; the top-k of s + bias select (the bias steers
    selection only; lower expert first on ties); gates are the selected s,
    over their sum where ``router_norm_topk``, times ``routed_scaling``.
    Nothing is dropped.  Returns ``(gates (T, k) f32, flat_e (T*k,),
    order (T*k,), seg (E+1,) int32)``: ``order`` sorts the assignments by
    expert (stable, so token order within an expert), and expert e's
    rows of that order are ``seg[e]:seg[e+1]``.  Every index stays on the
    device."""
    t = xt.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    s = torch.sigmoid(xt.to(torch.float32) @ p["router"])
    sel = s + p["bias"] if "bias" in p else s
    # a stable descending sort keeps the lower index first among equals
    topi = torch.sort(sel, dim=-1, descending=True, stable=True)[1][:, :k]
    g = s.gather(1, topi)
    if cfg.router_norm_topk:
        g = g / (g.sum(-1, keepdim=True) + 1e-20)
    g = g * cfg.routed_scaling
    flat_e = topi.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    seg = torch.searchsorted(flat_e[order],
                             torch.arange(e + 1, device=xt.device))
    return g, flat_e, order, seg.to(torch.int32)


def routed_combine(y_sorted, order, gates):
    """Each token's k expert outputs (rows of ``y_sorted`` in ``order``'s
    expert-sorted order) times their gates, summed in f32 in the token's
    order of k: (T, D) f32."""
    t, k = gates.shape
    y = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
    return (y.reshape(t, k, -1).to(torch.float32) * gates[..., None]).sum(1)


def _float_expert(pe, x, cfg: ModelConfig, kan: bool):
    if kan:
        h = _kan_linear(pe["c1"], pe["wb1"], x, cfg)
        return _kan_linear(pe["c2"], pe["wb2"], h, cfg)
    return (F.silu(x @ pe["wg"]) * (x @ pe["wi"])) @ pe["wo"]


def routed_moe(p, x, cfg: ModelConfig):
    """The routed layer over (B, S, D).  A deployed KAN layer (key
    ``"deployed"``) runs ``core.kan_ffn_deploy.kan_moe_apply_quantized``
    (one grouped B1 launch per half); float experts run one by one over
    their rows (the counts are read on the host).  The shared experts'
    output is added ungated."""
    if "deployed" in p:
        from ..core.kan_ffn_deploy import kan_moe_apply_quantized

        return kan_moe_apply_quantized(p, x, cfg)
    b, s, d = x.shape
    kan = "c1" in p
    xt = x.reshape(b * s, d)
    with profile_scope("model.moe.route"):
        gates, flat_e, order, seg = route_sigmoid(p, xt, cfg)
    k = cfg.num_experts_per_tok
    with profile_scope("model.moe.experts"):
        tok = order // k
        bounds = seg.tolist()
        y = torch.zeros((b * s * k, d), dtype=x.dtype, device=x.device)
        for e in range(cfg.num_experts):
            lo, hi = bounds[e], bounds[e + 1]
            if hi > lo:
                pe = {n: w[e] for n, w in p.items()
                      if n not in ("router", "bias", "shared")}
                y[lo:hi] = _float_expert(pe, xt[tok[lo:hi]][None], cfg,
                                         kan)[0].to(x.dtype)
    out = routed_combine(y, order, gates)
    if "shared" in p:
        with profile_scope("model.moe.shared"):
            out = out + _float_expert(p["shared"], xt[None], cfg,
                                      kan)[0].to(torch.float32)
    return out.to(x.dtype).reshape(b, s, d)

# ----------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ----------------------------------------------------------------------------


def init_rglru(gen, cfg: ModelConfig, *, device=None) -> dict:
    """Input / gate projections (D, W), the depthwise conv (4, W), the
    recurrence and input gates (W, W) and the output (W, D) in the
    config's dtype; the decay parameter ``lam`` (W,) in f32."""
    d = cfg.d_model
    w = cfg.rnn_width or d
    dt = torch_dtype(cfg)
    sc, scw = 1.0 / math.sqrt(d), 1.0 / math.sqrt(w)
    return {
        "w_in": _normal(gen, (d, w), sc, dt, device),
        "w_gate_in": _normal(gen, (d, w), sc, dt, device),
        "conv": _normal(gen, (4, w), 0.3, dt, device),
        "w_rg": _normal(gen, (w, w), scw, dt, device),
        "w_ig": _normal(gen, (w, w), scw, dt, device),
        "lam": torch.full((w,), 2.0, dtype=torch.float32, device=device),
        "w_out": _normal(gen, (w, d), scw, dt, device),
    }


def _causal_conv1d(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, W), w: (K, W), state: (B, K-1, W)
    (None: zeros).  Returns (out, new_state): the sum of K shifted
    products in order i = 0..K-1, each product and partial sum rounded to
    x's dtype, as the reference's Python ``sum`` (one fused conv would
    round once); ``new_state`` is the last K-1 rows of [state, x], so a
    prompt shorter than K-1 keeps the zeros before it."""
    k, s = w.shape[0], x.shape[1]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device) if state is None else state)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out, xp[:, s:]


def _rglru_scan(a, bx):
    """h_t = a_t * h_{t-1} + b_t over axis 1 (h_{-1} = 0), the reference's
    ``associative_scan`` as a log-depth doubling scan: at distance d = 1,
    2, 4, ... every t >= d folds in the segment ending at t - d."""
    s, d = a.shape[1], 1
    while d < s:
        bx = torch.cat([bx[:, :d], a[:, d:] * bx[:, :-d] + bx[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return bx


def _sigmoid(x):
    """``jax.nn.sigmoid`` as the reference lowers it, 1 / (1 + exp(-x)),
    each op rounded to x's dtype: in bf16, ``torch.sigmoid`` (one rounding)
    moves about a third of the values by one ulp, and the recurrent states
    integrate them."""
    return 1.0 / (1.0 + torch.exp(-x))


def _softplus(x):
    """``jax.nn.softplus``: log(exp(x) + 1) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru(p, x, cfg: ModelConfig, state=None):
    """RG-LRU over x (B, S, D).  ``state`` {"conv": (B, 3, W), "h": (B, W)
    f32} decodes one step (S = 1) from it; without, the whole sequence
    runs from zeros through :func:`_rglru_scan`.  Returns (y, new_state),
    the state after the last position either way (the reference's
    ``rglru_prefill`` state)."""
    u = x @ p["w_in"]
    gate_in = F.gelu(x @ p["w_gate_in"], approximate="tanh")
    u, conv_state = _causal_conv1d(u, p["conv"],
                                   None if state is None else state["conv"])
    r = _sigmoid(u @ p["w_rg"])
    i = _sigmoid(u @ p["w_ig"])
    c = 8.0
    log_a = -c * _softplus(p["lam"]) * r.to(torch.float32)
    a = torch.exp(log_a)
    gated = (i * u).to(torch.float32) * torch.sqrt(
        torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    if state is None:
        h_seq = _rglru_scan(a, gated)
    else:
        h_seq = (a[:, 0] * state["h"] + gated[:, 0])[:, None]
    y = (h_seq.to(x.dtype) * gate_in) @ p["w_out"]
    return y, {"conv": conv_state, "h": h_seq[:, -1]}


def rglru_prefill(p, x, cfg: ModelConfig):
    """Whole-sequence RG-LRU with the final recurrent state."""
    return rglru(p, x, cfg)


def init_rglru_state(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    w = cfg.rnn_width or cfg.d_model
    return {"conv": torch.zeros((batch, 3, w), dtype=torch_dtype(cfg),
                                device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}


# ----------------------------------------------------------------------------
# Mamba-2 SSD block
# ----------------------------------------------------------------------------


def _ssm_dims(cfg: ModelConfig) -> tuple:
    """(inner width, heads, state size, head dim)."""
    din = cfg.ssm_expand * cfg.d_model
    return din, din // cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_head_dim


def init_mamba2(gen, cfg: ModelConfig, *, device=None) -> dict:
    """The fused input projection (D, 2*din + 2N + H) and the conv (K,
    din + 2N) and output (din, D) in the config's dtype; the per-head
    ``a_log``, ``d_skip``, ``dt_bias`` and the gated norm's scale in f32."""
    d = cfg.d_model
    din, nh, n, _ = _ssm_dims(cfg)
    dt = torch_dtype(cfg)

    def f32(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return {
        "w_in": _normal(gen, (d, 2 * din + 2 * n + nh), 1.0 / math.sqrt(d),
                        dt, device),
        "conv": _normal(gen, (cfg.ssm_conv, din + 2 * n), 0.3, dt, device),
        "a_log": f32((nh,), 0.0),
        "d_skip": f32((nh,), 1.0),
        "dt_bias": f32((nh,), 0.0),
        "norm": f32((din,), 0.0),
        "w_out": _normal(gen, (din, d), 1.0 / math.sqrt(din), dt, device),
    }


def _ssd_chunked(x, dtv, a_log, b, c, chunk: int):
    """SSD (state-space duality) chunked scan, all in f32.

    x: (B, S, H, P) values; dtv: (B, S, H) step sizes (softplus'd); b, c:
    (B, S, N) input / output projections (one group); S a multiple of
    ``chunk``.  Within a chunk the output is the masked decay matrix
    applied directly; across chunks a state (B, H, N, P) is carried in
    order, each chunk reading the state before it.  Returns (y (B, S, H,
    P), final state)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    assert nc * chunk == s, (s, chunk)
    da = dtv * -torch.exp(a_log)                       # (B, S, H), <= 0
    x_c = (x * dtv[..., None]).to(torch.float32).reshape(bsz, nc, chunk, h, p)
    b_c = b.to(torch.float32).reshape(bsz, nc, chunk, n)
    c_c = c.to(torch.float32).reshape(bsz, nc, chunk, n)
    cums = torch.cumsum(da.reshape(bsz, nc, chunk, h), dim=2)  # (B,NC,Q,H)
    # intra-chunk: L[q, t] = exp(cums[q] - cums[t]) for t <= q, else 0.
    # The reference's exp(rel) * tril overflows above the diagonal once a
    # chunk's decay spans more than f32 exp's range (~88.7: 256 steps of
    # dt ~0.35 at A = -1), and inf * 0 is NaN; masking before the exp
    # gives 0 there and the same bits below
    rel = cums[:, :, :, None, :] - cums[:, :, None, :, :]      # (B,NC,Q,Q,H)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[:, :, None]
    l_mat = torch.exp(torch.where(tri, rel, -math.inf))
    cb = torch.einsum("bcqn,bctn->bcqt", c_c, b_c)
    y_diag = torch.einsum("bcqth,bcthp->bcqhp", cb[..., None] * l_mat, x_c)
    # each chunk's own state: sum_t exp(cums[last] - cums[t]) b_t x_t
    decay_to_end = torch.exp(cums[:, :, -1:] - cums)           # (B,NC,Q,H)
    states = torch.einsum("bctn,bcthp->bchnp", b_c,
                          x_c * decay_to_end[..., None])
    # across chunks, in order: chunk i reads the carry before it
    chunk_decay = torch.exp(cums[:, :, -1])                    # (B,NC,H)
    carry = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    prev = []
    for i in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                     # (B,NC,H,N,P)
    y_off = torch.einsum("bcqn,bchnp->bcqhp", c_c, prev_states) \
        * torch.exp(cums)[..., None]
    return (y_diag + y_off).reshape(bsz, s, h, p), carry


def mamba2(p, x, cfg: ModelConfig, state=None):
    """Mamba-2 block over x (B, S, D).  ``state`` {"conv": (B, K-1, din +
    2N), "ssm": (B, H, N, P) f32} decodes one step (S = 1) from it;
    without, the whole sequence runs through :func:`_ssd_chunked` (padded
    to a multiple of ``min(cfg.ssm_chunk, S)``: padded steps have dt = 0,
    so they neither decay nor add).  Returns (y, new_state)."""
    bsz, s, _ = x.shape
    din, nh, n, hd = _ssm_dims(cfg)
    z, xin, bc, dtv = torch.split(x @ p["w_in"], [din, din, 2 * n, nh],
                                  dim=-1)
    conv_out, conv_state = _causal_conv1d(
        torch.cat([xin, bc], dim=-1), p["conv"],
        None if state is None else state["conv"])
    # jax.nn.silu: x * sigmoid(x), rounded op by op (see _sigmoid)
    xin, b, c = torch.split(conv_out * _sigmoid(conv_out), [din, n, n],
                            dim=-1)
    dtv = _softplus(dtv.to(torch.float32) + p["dt_bias"])      # (B, S, H)
    xh = xin.reshape(bsz, s, nh, hd)
    if state is not None:
        da = torch.exp(dtv[:, 0] * -torch.exp(p["a_log"]))     # (B, H)
        xz = (xh[:, 0] * dtv[:, 0, :, None]).to(torch.float32)
        ssm = state["ssm"] * da[..., None, None] + torch.einsum(
            "bn,bhp->bhnp", b[:, 0].to(torch.float32), xz)
        y = torch.einsum("bn,bhnp->bhp", c[:, 0].to(torch.float32),
                         ssm)[:, None]
    else:
        chunk = min(cfg.ssm_chunk, s)
        pad = (-s) % chunk
        y, ssm = _ssd_chunked(F.pad(xh, (0, 0, 0, 0, 0, pad)),
                              F.pad(dtv, (0, 0, 0, pad)), p["a_log"],
                              F.pad(b, (0, 0, 0, pad)),
                              F.pad(c, (0, 0, 0, pad)), chunk)
        y = y[:, :s]
    y = y + xh.to(torch.float32) * p["d_skip"][:, None]
    y = y.reshape(bsz, s, din)
    # gated RMSNorm (mamba2 style), in f32
    yf = y * F.silu(z.to(torch.float32))
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * (1.0 + p["norm"])
    return yf.to(x.dtype) @ p["w_out"], {"conv": conv_state, "ssm": ssm}


def mamba2_prefill(p, x, cfg: ModelConfig):
    """Whole-sequence Mamba-2 with the final SSD and conv states."""
    return mamba2(p, x, cfg)


def init_mamba2_state(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    din, nh, n, hd = _ssm_dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, din + 2 * n),
                                dtype=torch_dtype(cfg), device=device),
            "ssm": torch.zeros((batch, nh, n, hd), dtype=torch.float32,
                               device=device)}
