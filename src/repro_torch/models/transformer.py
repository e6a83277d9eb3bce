"""Transformer stack: stacked per-group params, forward, prefill and decode.

Port of ``repro.models.transformer``.  Layers are
organized into repeating blocks given by ``cfg.attn_pattern``; params and
caches of each group are STACKED over repeats (leading dim), as in the
reference, so converted trees load unchanged.  The reference's
``lax.scan`` over the repeats is a Python loop here; each repeat's params
and cache are views into the stacked tensors, and the caches are written
in place through those views.

"global", "local" (sliding-window) and "bidir" (the encoder's) attention
layers with a dense or MoE FFN, "rglru" (RG-LRU) layers with an FFN, and
"ssm" (Mamba-2) layers without one.  A recurrent layer's decode state
(``l{i}_rnn`` / ``l{i}_ssm``) is written in place like a KV cache.  A
decoder stack built with ``cross`` has a cross-attention sublayer after
each layer's mixer (``l{i}_xattn`` / ``l{i}_lnx``): q from the residual
stream, k / v from the encoder output ``enc_out``.  Its K/V are written
once, at prefill, into the ``l{i}_xkv`` cache leaves, which decode reads.

With ``cfg.remat`` (the default) and grad enabled, each block of the
full-sequence forward runs under ``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``: its activations are recomputed in the
backward pass instead of kept.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..dist import comm
from ..dist.sharding import map_with_path
from ..obs.trace import profile_scope
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


_ATTN_KINDS = ("global", "local", "bidir")
_KINDS = _ATTN_KINDS + ("rglru", "ssm")


def _check_kinds(kinds) -> None:
    for kind in kinds:
        if kind not in _KINDS:
            raise ValueError(f"layer kind {kind!r}")


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


def _init_block(gen, cfg: ModelConfig, kinds, cross: bool, device) -> dict:
    """One block = len(kinds) layers; params keyed l{i}_*."""
    p = {}
    for i, kind in enumerate(kinds):
        if kind == "rglru":
            p[f"l{i}_rnn"] = L.init_rglru(gen, cfg, device=device)
        elif kind == "ssm":
            p[f"l{i}_ssm"] = L.init_mamba2(gen, cfg, device=device)
        else:
            p[f"l{i}_attn"] = L.init_attention(gen, cfg, device=device)
        p[f"l{i}_ln1"] = L.init_rmsnorm(cfg.d_model, device=device)
        if cross and kind != "ssm":
            p[f"l{i}_xattn"] = L.init_attention(gen, cfg, cross=True,
                                                device=device)
            p[f"l{i}_lnx"] = L.init_rmsnorm(cfg.d_model, device=device)
        # an "ssm" layer has no FFN sublayer (nor its norms)
        ffn = kind != "ssm" and cfg.ffn_kind != "none"
        if ffn:
            # MoE takes precedence over ffn_kind, as in the reference
            if cfg.num_experts > 0:
                p[f"l{i}_moe"] = L.init_moe(gen, cfg, device=device)
            else:
                p[f"l{i}_ffn"] = L.init_ffn(gen, cfg, device=device)
            p[f"l{i}_ln2"] = L.init_rmsnorm(cfg.d_model, device=device)
        if cfg.post_norms:
            p[f"l{i}_pn1"] = L.init_rmsnorm(cfg.d_model, device=device)
            if ffn:
                p[f"l{i}_pn2"] = L.init_rmsnorm(cfg.d_model, device=device)
    return p


def init_stack(gen, cfg: ModelConfig, *, cross: bool = False,
               device=None, place=None, path: str = "") -> list:
    """Stacked params per group (leading dim = repeats); ``cross`` adds a
    cross-attention sublayer to every layer but "ssm".  ``place(path,
    leaf)``, where given, replaces each layer's leaves as soon as the layer
    is drawn (paths under ``path``, as the stacked tree's)."""
    groups = []
    for gi, (kinds, repeats) in enumerate(layer_groups(cfg)):
        _check_kinds(kinds)
        blocks = []
        for _ in range(repeats):
            bp = _init_block(gen, cfg, kinds, cross, device)
            blocks.append(bp if place is None else map_with_path(
                place, bp, f"{path}/{gi}" if path else str(gi)))
        groups.append(stack_trees(blocks))
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


def _cross_sublayer(bp, x, cfg: ModelConfig, i: int, enc_out=None,
                    xkv=None):
    """Layer ``i``'s cross attention, where the block has one: over
    ``enc_out``, or (decode) over the cross cache ``xkv``."""
    if f"l{i}_xattn" not in bp:
        return x
    h = L.rmsnorm(bp[f"l{i}_lnx"], x, cfg.norm_eps)
    if xkv is None:
        h = L.attention(bp[f"l{i}_xattn"], h, cfg, "cross", enc_out=enc_out)
    else:
        h, _ = L.attention_decode(bp[f"l{i}_xattn"], h, xkv, None, cfg,
                                  "cross")
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


# a recurrent layer kind -> the key suffix of its params and cache state,
# and its block
_RECURRENT = {"rglru": ("rnn", L.rglru), "ssm": ("ssm", L.mamba2)}


def _recurrent(bp, h, cfg: ModelConfig, i: int, kind: str, cache=None,
               decode: bool = False):
    """Layer ``i``, an "rglru" or "ssm" layer, over h: from its state in
    ``cache`` with ``decode``, else from zeros.  With ``cache`` its new
    state is written there in place."""
    name, block = _RECURRENT[kind]
    key = f"l{i}_{name}"
    h, new = block(bp[key], h, cfg, cache[key] if decode else None)
    if cache is not None:
        for leaf, t in new.items():
            cache[key][leaf].copy_(t)
    return h


def _block_forward(bp, x, cfg: ModelConfig, kinds, positions, enc_out=None):
    for i, kind in enumerate(kinds):
        h = L.rmsnorm(bp[f"l{i}_ln1"], x, cfg.norm_eps)
        if kind in _ATTN_KINDS:
            h = L.attention(bp[f"l{i}_attn"], h, cfg, kind, positions)
        else:
            h = _recurrent(bp, h, cfg, i, kind)
        x = _post_attn(bp, x, h, cfg, i)
        x = _cross_sublayer(bp, x, cfg, i, enc_out=enc_out)
        x = _ffn_sublayer(bp, x, cfg, i)
    return x


def _remat_block(bp, x, cfg: ModelConfig, kinds, positions, scope,
                 enc_out):
    # the recomputation runs inside the backward pass, on the autograd
    # engine's thread for a CUDA tensor, where the caller's scopes
    # (use_attn_backend, use_tp, use_row_split) are not set: pin the
    # attention backend, tensor-parallel layout and row-split group read
    # at the forward, so both passes run the same function
    attn_backend, tp, rows = scope
    with use_attn_backend(attn_backend), comm.use_tp(tp), \
            comm.use_row_split(rows):
        return _block_forward(bp, x, cfg, kinds, positions, enc_out)


def stack_forward(groups, x, cfg: ModelConfig, positions=None, enc_out=None):
    """The whole sequence through every layer; ``enc_out`` (B, T, D) is
    what the cross-attention sublayers attend to.  Under remat it is an
    explicit input of each block's checkpoint, so its gradient reaches the
    encoder."""
    remat = cfg.remat and torch.is_grad_enabled()
    scope = ((resolve_attn_backend(), comm.tp_layout(),
              comm.row_split_group()) if remat else None)
    for bp, _, kinds in _each_layer(groups, None, cfg):
        if remat:
            x = checkpoint(_remat_block, bp, x, cfg, kinds, positions,
                           scope, enc_out, use_reentrant=False,
                           preserve_rng_state=False)  # the block draws none
        else:
            x = _block_forward(bp, x, cfg, kinds, positions, enc_out)
    return x


# ----------------------------------------------------------------------------
# Caches
# ----------------------------------------------------------------------------


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     enc_len: int = 0, device=None) -> list:
    """Contiguous caches mirroring the groups: each l{i}_kv leaf is
    (repeats, B, T, Hkv, D); a recurrent layer's l{i}_rnn / l{i}_ssm
    state leaves have the same leading (repeats, B).  With ``enc_len`` > 0
    every layer but "ssm" also has its cross-attention K/V, l{i}_xkv:
    (repeats, B, enc_len, Hkv, D)."""
    def one(i, kind):
        if kind == "rglru":
            yield f"l{i}_rnn", L.init_rglru_state(cfg, batch, device=device)
        elif kind == "ssm":
            yield f"l{i}_ssm", L.init_mamba2_state(cfg, batch, device=device)
        else:
            yield f"l{i}_kv", L.init_kv_cache(cfg, batch, max_len, kind,
                                              device=device)
        if enc_len > 0 and kind != "ssm":
            yield f"l{i}_xkv", L.init_kv_cache(cfg, batch, enc_len, "cross",
                                               device=device)

    caches = []
    for kinds, repeats in layer_groups(cfg):
        _check_kinds(kinds)
        caches.append(stack_trees([
            dict(kv for i, kind in enumerate(kinds) for kv in one(i, kind))
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
    """A decode (or verify) step; a cross-attention sublayer reads its
    l{i}_xkv cache and leaves it as it is."""
    for bp, cache, kinds in _each_layer(groups, caches, cfg):
        for i, kind in enumerate(kinds):
            h = L.rmsnorm(bp[f"l{i}_ln1"], x, cfg.norm_eps)
            if kind in _ATTN_KINDS:
                with profile_scope("model.attention"):
                    h, _ = L.attention_decode(
                        bp[f"l{i}_attn"], h, cache[f"l{i}_kv"], pos, cfg,
                        "local" if kind == "local" else "global",
                        block_table=block_table)
            else:
                h = _recurrent(bp, h, cfg, i, kind, cache, decode=True)
            x = _post_attn(bp, x, h, cfg, i)
            x = _cross_sublayer(bp, x, cfg, i, xkv=cache.get(f"l{i}_xkv"))
            with profile_scope("model.ffn"):
                x = _ffn_sublayer(bp, x, cfg, i)
    return x, caches


# ----------------------------------------------------------------------------
# Prefill: the full-sequence forward that also fills the KV caches
# ----------------------------------------------------------------------------


def _prefill_cross(bp, x, cfg: ModelConfig, i: int, cache, enc_out):
    """Layer ``i``'s cross sublayer at prefill: its K/V of ``enc_out``
    written into the l{i}_xkv cache in place, and attended to."""
    if f"l{i}_xattn" not in bp:
        return x
    xp, xkv = bp[f"l{i}_xattn"], cache[f"l{i}_xkv"]
    for name, t in zip(("k", "v"), L._kv_of(xp, enc_out, cfg)):
        xkv[name].copy_(t)
    h = L.rmsnorm(bp[f"l{i}_lnx"], x, cfg.norm_eps)
    h = L._sdpa(L._q_of(xp, h), xkv["k"], xkv["v"], cfg, "cross")
    return x + L._out_proj(h, xp["wo"])


def stack_prefill(groups, caches, x, cfg: ModelConfig, positions=None,
                  enc_out=None):
    """Whole prompt; attention over the prompt's own K/V (T = S), which is
    also written into ``caches[:, :, :S]`` in place.  A rolling-window
    cache shorter than the prompt (T < S) keeps the last T positions,
    rolled by (S - T) % T so that slot = position % T.  A recurrent
    layer runs the whole prompt and keeps its state after the last
    position.  A cross-attention sublayer writes its K/V of ``enc_out``
    into its l{i}_xkv cache."""
    s = x.shape[1]
    for bp, cache, kinds in _each_layer(groups, caches, cfg):
        for i, kind in enumerate(kinds):
            h = L.rmsnorm(bp[f"l{i}_ln1"], x, cfg.norm_eps)
            if kind not in _ATTN_KINDS:
                h = _recurrent(bp, h, cfg, i, kind, cache)
                x = _post_attn(bp, x, h, cfg, i)
                x = _prefill_cross(bp, x, cfg, i, cache, enc_out)
                with profile_scope("model.ffn"):
                    x = _ffn_sublayer(bp, x, cfg, i)
                continue
            with profile_scope("model.attention"):
                q, k, v = L._qkv(bp[f"l{i}_attn"], h, cfg, kind != "bidir",
                                 positions)
                kv = cache[f"l{i}_kv"]
                t = kv["k"].shape[1]
                for name, new in (("k", k), ("v", v)):
                    if kind == "local" and t < s:
                        kv[name].copy_(torch.roll(new[:, s - t:],
                                                  (s - t) % t, dims=1))
                    else:
                        kv[name][:, :s] = new.to(kv[name].dtype)
                h = L._sdpa(q, k, v, cfg, kind)
                h = L._out_proj(h, bp[f"l{i}_attn"]["wo"])
            x = _post_attn(bp, x, h, cfg, i)
            x = _prefill_cross(bp, x, cfg, i, cache, enc_out)
            with profile_scope("model.ffn"):
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
            with profile_scope("model.attention"):
                q, k, v = L._qkv(bp[f"l{i}_attn"], h, cfg, True, positions)
                _, gk, gv = L.paged_prefill_update(
                    cache[f"l{i}_kv"], k, v, block_table, start, real_end)
                t = gk.shape[1]
                h = L._sdpa(q, gk, gv, cfg, "global", qpos=positions[0],
                            kpos=torch.arange(t, device=x.device))
                h = L._out_proj(h, bp[f"l{i}_attn"]["wo"])
            x = _post_attn(bp, x, h, cfg, i)
            with profile_scope("model.ffn"):
                x = _ffn_sublayer(bp, x, cfg, i)
    return x, caches
