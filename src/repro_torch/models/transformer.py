"""Decoder stack: stacked per-group params, forward, prefill and decode.

Port of ``repro.models.transformer`` for the attention decoders.  Layers are
organized into repeating blocks given by ``cfg.attn_pattern``; params and
caches of each group are STACKED over repeats (leading dim), as in the
reference, so converted trees load unchanged.  The reference's
``lax.scan`` over the repeats is a Python loop here; each repeat's params
and cache are views into the stacked tensors, and the caches are written
in place through those views.

"global" and "local" (sliding-window) attention layers are ported, with a
dense or MoE FFN; "rglru" and "ssm" layers raise ``NotImplementedError``
(ROADMAP A7b).

With ``cfg.remat`` (the default) and grad enabled, each block of the
full-sequence forward runs under ``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``: its activations are recomputed in the
backward pass instead of kept.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..runtime.attention import resolve_attn_backend, use_attn_backend
from . import layers as L

__all__ = [
    "layer_groups",
    "init_stack",
    "stack_forward",
    "init_stack_cache",
    "init_stack_cache_paged",
    "stack_decode",
    "stack_prefill",
    "stack_prefill_paged",
    "stack_trees",
    "tree_layer",
]


def layer_groups(cfg: ModelConfig):
    """[(kinds_tuple, repeats)]: one stacked group + optional remainder."""
    period = len(cfg.attn_pattern)
    full, rem = divmod(cfg.num_layers, period)
    groups = []
    if full:
        groups.append((tuple(cfg.attn_pattern), full))
    if rem:
        groups.append((tuple(cfg.attn_pattern[:rem]), 1))
    return groups


def _check_kinds(kinds) -> None:
    for kind in kinds:
        if kind in ("rglru", "ssm"):
            raise L.not_ported(f"layer kind {kind!r}", L.A7B)
        if kind not in ("global", "local"):
            raise ValueError(f"decoder layer kind {kind!r}")


def tree_layer(tree, r: int):
    """Repeat ``r`` of a stacked tree: tensors indexed on their leading dim
    (views, no copy), tuples (per-layer deployed KAN bundles) by position."""
    if isinstance(tree, dict):
        return {k: tree_layer(v, r) for k, v in tree.items()}
    return tree[r]


def stack_trees(trees: list):
    """Stack per-repeat dict trees leaf by leaf (leading dim = repeats)."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _init_block(gen, cfg: ModelConfig, kinds, device) -> dict:
    """One block = len(kinds) layers; params keyed l{i}_*."""
    p = {}
    for i, kind in enumerate(kinds):
        p[f"l{i}_attn"] = L.init_attention(gen, cfg, device=device)
        p[f"l{i}_ln1"] = L.init_rmsnorm(cfg.d_model, device=device)
        if cfg.ffn_kind != "none":
            # MoE takes precedence over ffn_kind, as in the reference
            if cfg.num_experts > 0:
                p[f"l{i}_moe"] = L.init_moe(gen, cfg, device=device)
            else:
                p[f"l{i}_ffn"] = L.init_ffn(gen, cfg, device=device)
            p[f"l{i}_ln2"] = L.init_rmsnorm(cfg.d_model, device=device)
        if cfg.post_norms:
            p[f"l{i}_pn1"] = L.init_rmsnorm(cfg.d_model, device=device)
            if cfg.ffn_kind != "none":
                p[f"l{i}_pn2"] = L.init_rmsnorm(cfg.d_model, device=device)
    return p


def init_stack(gen, cfg: ModelConfig, *, device=None) -> list:
    """Stacked params per group (leading dim = repeats)."""
    groups = []
    for kinds, repeats in layer_groups(cfg):
        _check_kinds(kinds)
        groups.append(stack_trees([_init_block(gen, cfg, kinds, device)
                              for _ in range(repeats)]))
    return groups


def _ffn_sublayer(bp, x, cfg: ModelConfig, i: int):
    if f"l{i}_ln2" not in bp:
        return x
    h = L.rmsnorm(bp[f"l{i}_ln2"], x, cfg.norm_eps)
    if f"l{i}_moe" in bp:
        h = L.moe(bp[f"l{i}_moe"], h, cfg)
    else:
        h = L.ffn(bp[f"l{i}_ffn"], h, cfg)
    if cfg.post_norms:
        h = L.rmsnorm(bp[f"l{i}_pn2"], h, cfg.norm_eps)
    return x + h


def _post_attn(bp, x, h, cfg: ModelConfig, i: int):
    if cfg.post_norms:
        h = L.rmsnorm(bp[f"l{i}_pn1"], h, cfg.norm_eps)
    return x + h


def _each_layer(groups, caches, cfg: ModelConfig):
    """(block params, block cache or None, kinds) for every repeat in order."""
    for gi, (gp, (kinds, repeats)) in enumerate(zip(groups,
                                                     layer_groups(cfg))):
        _check_kinds(kinds)
        for r in range(repeats):
            cache = None if caches is None else tree_layer(caches[gi], r)
            yield tree_layer(gp, r), cache, kinds


# ----------------------------------------------------------------------------
# Full-sequence forward
# ----------------------------------------------------------------------------


def _block_forward(bp, x, cfg: ModelConfig, kinds, positions):
    for i, kind in enumerate(kinds):
        h = L.rmsnorm(bp[f"l{i}_ln1"], x, cfg.norm_eps)
        h = L.attention(bp[f"l{i}_attn"], h, cfg, kind, positions)
        x = _post_attn(bp, x, h, cfg, i)
        x = _ffn_sublayer(bp, x, cfg, i)
    return x


def _remat_block(bp, x, cfg: ModelConfig, kinds, positions, attn_backend):
    # the recomputation runs inside the backward pass, on the autograd
    # engine's thread for a CUDA tensor, where the caller's
    # use_attn_backend() scope is not set: pin the backend resolved at the
    # forward so both passes dispatch alike
    with use_attn_backend(attn_backend):
        return _block_forward(bp, x, cfg, kinds, positions)


def stack_forward(groups, x, cfg: ModelConfig, positions=None):
    remat = cfg.remat and torch.is_grad_enabled()
    backend = resolve_attn_backend() if remat else None
    for bp, _, kinds in _each_layer(groups, None, cfg):
        if remat:
            x = checkpoint(_remat_block, bp, x, cfg, kinds, positions,
                           backend, use_reentrant=False,
                           preserve_rng_state=False)  # the block draws none
        else:
            x = _block_forward(bp, x, cfg, kinds, positions)
    return x


# ----------------------------------------------------------------------------
# Caches
# ----------------------------------------------------------------------------


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     device=None) -> list:
    """Contiguous KV caches mirroring the groups: each l{i}_kv leaf is
    (repeats, B, max_len, Hkv, D)."""
    caches = []
    for kinds, repeats in layer_groups(cfg):
        _check_kinds(kinds)
        caches.append(stack_trees([
            {f"l{i}_kv": L.init_kv_cache(cfg, batch, max_len, kind,
                                         device=device)
             for i, kind in enumerate(kinds)}
            for _ in range(repeats)]))
    return caches


def init_stack_cache_paged(cfg: ModelConfig, num_blocks: int,
                           block_size: int, *, device=None) -> list:
    """Paged-pool caches: each l{i}_kv leaf is (repeats, NB, bs, Hkv, D)."""
    caches = []
    for kinds, repeats in layer_groups(cfg):
        for kind in kinds:
            if kind != "global":
                raise ValueError(
                    f"paged KV cache requires a pure global-attention "
                    f"decoder; layer kind {kind!r} is not pageable")
        caches.append(stack_trees([
            {f"l{i}_kv": L.init_paged_kv_cache(cfg, num_blocks, block_size,
                                               device=device)
             for i in range(len(kinds))}
            for _ in range(repeats)]))
    return caches


# ----------------------------------------------------------------------------
# Decode (S=1, or S=k+1 for verify): caches updated in place
# ----------------------------------------------------------------------------


def stack_decode(groups, caches, x, pos, cfg: ModelConfig, block_table=None):
    for bp, cache, kinds in _each_layer(groups, caches, cfg):
        for i, kind in enumerate(kinds):
            h = L.rmsnorm(bp[f"l{i}_ln1"], x, cfg.norm_eps)
            h, _ = L.attention_decode(bp[f"l{i}_attn"], h, cache[f"l{i}_kv"],
                                      pos, cfg, kind, block_table=block_table)
            x = _post_attn(bp, x, h, cfg, i)
            x = _ffn_sublayer(bp, x, cfg, i)
    return x, caches


# ----------------------------------------------------------------------------
# Prefill: the full-sequence forward that also fills the KV caches
# ----------------------------------------------------------------------------


def stack_prefill(groups, caches, x, cfg: ModelConfig, positions=None):
    """Whole prompt; attention over the prompt's own K/V (T = S), which is
    also written into ``caches[:, :, :S]`` in place.  A rolling-window
    cache shorter than the prompt (T < S) keeps the last T positions,
    rolled by (S - T) % T so that slot = position % T."""
    s = x.shape[1]
    for bp, cache, kinds in _each_layer(groups, caches, cfg):
        for i, kind in enumerate(kinds):
            h = L.rmsnorm(bp[f"l{i}_ln1"], x, cfg.norm_eps)
            q, k, v = L._qkv(bp[f"l{i}_attn"], h, cfg, True, positions)
            kv = cache[f"l{i}_kv"]
            t = kv["k"].shape[1]
            for name, new in (("k", k), ("v", v)):
                if kind == "local" and t < s:
                    kv[name].copy_(torch.roll(new[:, s - t:], (s - t) % t,
                                              dims=1))
                else:
                    kv[name][:, :s] = new.to(kv[name].dtype)
            h = L._sdpa(q, k, v, cfg, kind)
            h = L._out_proj(h, bp[f"l{i}_attn"]["wo"])
            x = _post_attn(bp, x, h, cfg, i)
            x = _ffn_sublayer(bp, x, cfg, i)
    return x, caches


def stack_prefill_paged(groups, caches, x, cfg: ModelConfig, block_table,
                        start, real_end, positions):
    """One B=1 prefill chunk against the paged pool: the chunk's K/V go to
    the request's blocks (pad rows >= real_end dropped) and attention runs
    over the whole gathered view, so the chunk's queries see the cached
    prefix, earlier chunks and themselves under the causal mask."""
    for bp, cache, kinds in _each_layer(groups, caches, cfg):
        for i, kind in enumerate(kinds):
            h = L.rmsnorm(bp[f"l{i}_ln1"], x, cfg.norm_eps)
            q, k, v = L._qkv(bp[f"l{i}_attn"], h, cfg, True, positions)
            _, gk, gv = L.paged_prefill_update(cache[f"l{i}_kv"], k, v,
                                               block_table, start, real_end)
            t = gk.shape[1]
            h = L._sdpa(q, gk, gv, cfg, "global", qpos=positions[0],
                        kpos=torch.arange(t, device=x.device))
            h = L._out_proj(h, bp[f"l{i}_attn"]["wo"])
            x = _post_attn(bp, x, h, cfg, i)
            x = _ffn_sublayer(bp, x, cfg, i)
    return x, caches
