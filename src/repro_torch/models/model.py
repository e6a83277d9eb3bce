"""Model assembly for the decoder-only LM: embeddings, stack, head; the
forward, prefill, decode, verify and paged-chunk entry points.

Port of ``repro.models.model`` for the decoder-only stacks (dense, sliding
window, MoE, RG-LRU hybrid, Mamba-2).  Encoder (audio) and patch (vlm)
prefixes raise
``NotImplementedError`` (ROADMAP A7c).

  loss_fn: tokens / targets (B, S) -> mean next-token NLL (the train step's)

  prefill: tokens (B, S) -> (last-token logits (B, V), filled cache)
  decode:  token (B,), pos (B,) + cache -> (logits (B, V), cache)

Caches are written in place and returned.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L
from .transformer import (
    init_stack,
    init_stack_cache,
    init_stack_cache_paged,
    stack_decode,
    stack_forward,
    stack_prefill,
    stack_prefill_paged,
)

__all__ = [
    "init_params",
    "forward",
    "loss_fn",
    "init_cache",
    "prefill",
    "decode_step",
    "verify_step",
    "init_paged_cache",
    "prefill_chunk",
    "params_device",
]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.encoder_layers > 0 or cfg.family in ("audio", "vlm"):
        raise L.not_ported(f"the {cfg.family} family", L.A7C)


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device=None) -> dict:
    """Random weights on ``device`` (the card unless ``device="cpu"``),
    drawn from ``gen`` (a generator on that device)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = L.torch_dtype(cfg)
    p = {
        "embed": L._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt, dev),
        "final_norm": L.init_rmsnorm(cfg.d_model, device=dev),
        "decoder": init_stack(gen, cfg, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._normal(gen, (cfg.d_model, cfg.vocab_size), 0.02,
                                 dt, dev)
    return p


def params_device(p: dict) -> torch.device:
    return p["embed"].device


def _embed_tokens(p, tokens, cfg: ModelConfig):
    h = p["embed"][tokens]
    # scaled in the embedding's dtype, as the reference does; the scale is
    # filled on the device (a host-made tensor would cost a host-to-device
    # copy and a wait on every call)
    return h * torch.full((), math.sqrt(float(cfg.d_model)), dtype=h.dtype,
                          device=h.device)


def _lm_logits(p, h, cfg: ModelConfig):
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    logits = (h @ w).to(torch.float32)
    return L.softcap(logits, cfg.final_logit_softcap)


def _positions(b: int, s: int, device, start=0):
    return (start + torch.arange(s, device=device))[None].expand(b, s)


def forward(p, batch, cfg: ModelConfig):
    """Logits (B, S, V) of a whole token batch {"tokens": (B, S)}."""
    _check_family(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = _embed_tokens(p, tokens, cfg)
    h = stack_forward(p["decoder"], h, cfg,
                      positions=_positions(b, s, h.device))
    h = L.rmsnorm(p["final_norm"], h, cfg.norm_eps)
    return _lm_logits(p, h, cfg)


def loss_fn(p, batch, cfg: ModelConfig):
    """Mean next-token NLL of ``batch`` {"tokens", "targets": (B, S) int,
    optional "loss_mask": (B, S) float}: log-softmax of the f32 logits,
    the targets' entries gathered; with a mask, the masked mean (its sum
    clamped to at least 1)."""
    logits = forward(p, batch, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["targets"].to(torch.int64)[..., None])[
        ..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def init_cache(p, cfg: ModelConfig, batch: int, max_len: int):
    _check_family(cfg)
    return init_stack_cache(cfg, batch, max_len, device=params_device(p))


@torch.no_grad()
def prefill(p, batch, cfg: ModelConfig, max_len: int, last_index=None):
    """Process the prompt; returns (last-token logits (B, V), filled cache).

    ``last_index``: optional (B,) index of the last REAL token per row (the
    engine pads prompts to power-of-two buckets and reads the first-token
    logits at the true prompt end)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = _embed_tokens(p, tokens, cfg)
    cache = init_cache(p, cfg, b, max_len)
    h, cache = stack_prefill(p["decoder"], cache, h, cfg,
                             positions=_positions(b, s, h.device))
    h = L.rmsnorm(p["final_norm"], h, cfg.norm_eps)
    if last_index is None:
        sel = h[:, -1:, :]
    else:
        idx = torch.as_tensor(last_index, device=h.device).to(torch.int64)
        sel = h[torch.arange(b, device=h.device), idx][:, None]
    return _lm_logits(p, sel, cfg)[:, 0], cache


@torch.no_grad()
def decode_step(p, cache, token, pos, cfg: ModelConfig, block_table=None):
    """token: (B,) int; pos: (B,) int.  Returns (logits (B, V), cache).

    ``block_table`` ((B, nblk) int) switches attention to the paged pool
    (cache leaves (repeats, NB, bs, Hkv, D))."""
    h = _embed_tokens(p, token[:, None], cfg)
    h, cache = stack_decode(p["decoder"], cache, h, pos, cfg,
                            block_table=block_table)
    h = L.rmsnorm(p["final_norm"], h, cfg.norm_eps)
    return _lm_logits(p, h, cfg)[:, 0], cache


@torch.no_grad()
def verify_step(p, cache, tokens, pos, cfg: ModelConfig, block_table):
    """Speculative-decode verify pass: score S consecutive tokens per slot
    in one forward.  tokens: (B, S), row i at positions pos[i]..pos[i]+S-1.
    Returns (logits (B, S, V), cache); row j is the next-token distribution
    after tokens[:, :j+1] (attention over a causal frontier per row)."""
    h = _embed_tokens(p, tokens, cfg)
    h, cache = stack_decode(p["decoder"], cache, h, pos, cfg,
                            block_table=block_table)
    h = L.rmsnorm(p["final_norm"], h, cfg.norm_eps)
    return _lm_logits(p, h, cfg), cache


def init_paged_cache(p, cfg: ModelConfig, num_blocks: int, block_size: int):
    """Paged KV pool shared by every slot (see serve.kvpool)."""
    if cfg.encoder_layers > 0:
        raise ValueError("paged KV cache does not support encoder prefixes")
    return init_stack_cache_paged(cfg, num_blocks, block_size,
                                  device=params_device(p))


@torch.no_grad()
def prefill_chunk(p, tokens, cache, block_table, start: int, real_end: int,
                  cfg: ModelConfig, last_index: int):
    """Advance one B=1 prefill chunk against the paged pool.

    tokens: (1, C), the prompt slice [start, start+C) right-padded to a
    bucket; positions >= ``real_end`` are padding (their KV writes are
    dropped).  The (1, V) logits are read at ``last_index`` (meaningful on
    the final chunk only).  Returns (logits, cache)."""
    b, s = tokens.shape
    h = _embed_tokens(p, tokens, cfg)
    positions = _positions(b, s, h.device, start=int(start))
    h, cache = stack_prefill_paged(p["decoder"], cache, h, cfg, block_table,
                                   start, real_end, positions=positions)
    h = L.rmsnorm(p["final_norm"], h, cfg.norm_eps)
    idx = min(max(int(last_index) - int(start), 0), s - 1)
    return _lm_logits(p, h[:, idx:idx + 1], cfg)[:, 0], cache
