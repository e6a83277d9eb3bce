"""Model assembly: embeddings, stacks, head; the forward, prefill, decode,
verify and paged-chunk entry points.

Port of ``repro.models.model``.  Families:

  * dense / moe / ssm / hybrid: a decoder-only LM over tokens;
  * audio (whisper): an encoder over STUB frame embeddings (the conv
    frontend is out of scope; the batch supplies precomputed
    ``"enc_embeds"`` (B, enc_seq, d_model)) plus sinusoidal positions,
    and a decoder whose layers cross-attend to the encoder's output;
  * vlm (pixtral): STUB patch embeddings ``"patch_embeds"`` (B,
    num_patches, patch_embed_dim), projected and prepended to the tokens;
    logits are returned for the token rows only.

  loss_fn: tokens / targets (B, S) (+ stub embeddings) -> mean next-token
           NLL (the train step's)
  prefill: tokens (B, S) (+ stub embeddings) -> (last-token logits (B, V),
           filled cache)
  decode:  token (B,), pos (B,) + cache -> (logits (B, V), cache); a vlm's
           positions count its patch rows (the first token at
           ``num_patches``)

Caches are written in place and returned.  In the serving entry points
(prefill, decode, verify, paged chunk) each attention layer's mixer and
each FFN sublayer run under the ``obs.profile_scope`` ranges
``model.attention`` / ``model.ffn`` (``models.transformer``), and
:func:`prefill`'s final norm and LM head under ``model.head``.  Decode,
verify and a paged chunk keep their head outside any nested range: a
``torch.profiler`` trace puts each kernel on the device span of its
innermost range only, so a head range would end the device span of the
engine's enclosing step (``serve.decode_step``, ...) before its last
layer's FFN.

Tensor parallelism: :func:`place_params` cuts a param tree to this rank's
slabs on a mesh's ``"model"`` axis where ``dist.sharding.param_pspecs``
puts a leaf there (query and KV heads, dense FFN and MoE expert hidden
columns, the patch projection's columns, the vocabulary of ``embed`` and
``lm_head``), and places the deployed KAN-FFN bundles on the mesh's
``"model"`` axis for the runtime.  Under ``dist.comm.use_tp`` the entry
points then run per rank: the embedding is a masked lookup summed over the
group, the logits of a vocabulary slab and the patch rows of a column slab
are all-gathered, and the layers reduce their partial outputs
(``models.layers``); each reads which roles were cut from the
``dist.comm.TPLayout`` that :func:`place_params` returns.  The collectives
carry gradients (``dist.comm``), so ``loss_fn`` trains under the same
layout.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..dist import comm
from ..obs.trace import profile_scope
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
    "place_params",
    "param_layout",
    "prefix_batch_key",
    "tokens_only_refusal",
]


def prefix_batch_key(cfg: ModelConfig) -> str | None:
    """The stub-embedding batch key that ``forward`` / ``prefill`` need
    beside the tokens: "enc_embeds" for an encoder prefix, "patch_embeds"
    for a patch prefix, None for a decoder-only model."""
    if cfg.encoder_layers > 0 or cfg.family == "audio":
        return "enc_embeds"
    if cfg.family == "vlm":
        return "patch_embeds"
    return None


def tokens_only_refusal(cfg: ModelConfig, who: str) -> str | None:
    """Why ``who``, which feeds the model tokens alone, cannot run ``cfg``
    (None where it can).  The reference's engine and training stream feed
    tokens alone too, and raise ``KeyError`` on the missing key."""
    key = prefix_batch_key(cfg)
    if key is None:
        return None
    return (f"{cfg.name}: the {cfg.family} family needs {key!r} beside the "
            f"tokens, and {who} supplies tokens alone (the reference raises "
            f"KeyError: {key!r} there); drive models.model's prefill / "
            "decode_step / loss_fn with the stub embeddings instead")


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device=None, place=None) -> dict:
    """Random weights on ``device`` (the card unless ``device="cpu"``),
    drawn from ``gen`` (a generator on that device).

    ``place(path, leaf)``, where given, replaces each leaf as soon as it is
    drawn (a stacked layer's leaves as soon as its layer is, before the
    stack is built), e.g. by this rank's slab (``dist.sharding.
    shard_param``): the draws are the same, and no more than one layer's
    leaves are ever whole at once."""
    dev = resolve_device(device)
    dt = L.torch_dtype(cfg)
    put = place or (lambda _path, leaf: leaf)
    p = {
        "embed": put("embed", L._normal(gen, (cfg.vocab_size, cfg.d_model),
                                        0.02, dt, dev)),
        "final_norm": L.init_rmsnorm(cfg.d_model, device=dev),
        "decoder": init_stack(gen, cfg, cross=cfg.encoder_layers > 0,
                              device=dev, place=place, path="decoder"),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = put("lm_head", L._normal(
            gen, (cfg.d_model, cfg.vocab_size), 0.02, dt, dev))
    if cfg.encoder_layers > 0:
        p["encoder"] = init_stack(gen, _encoder_cfg(cfg), device=dev,
                                  place=place, path="encoder")
        p["enc_norm"] = L.init_rmsnorm(cfg.d_model, device=dev)
    if cfg.family == "vlm":
        p["patch_proj"] = put("patch_proj", L._normal(
            gen, (cfg.patch_embed_dim, cfg.d_model),
            1.0 / math.sqrt(cfg.patch_embed_dim), dt, dev))
    return p


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, num_layers=cfg.encoder_layers,
                               attn_pattern=("bidir",), num_experts=0)


def params_device(p: dict) -> torch.device:
    return p["embed"].device


# the roles a tensor-parallel cut may take, by the leaf's last tree key
# (attention ``wo`` and the FFN / expert keys by their parent too);
# ``param_pspecs`` decides the cut
_TP_ROLES = {"wq": "heads", "bq": "heads", "wk": "kv", "wv": "kv",
             "bk": "kv", "bv": "kv", "embed": "vocab", "lm_head": "vocab",
             "patch_proj": "patch"}
_FFN_KEYS = ("wi", "wg", "wo", "c1", "wb1", "c2", "wb2")


def _tp_role(path: str) -> str | None:
    parent, _, key = path.rpartition("/")
    if key == "wo" and parent.endswith("attn"):
        return "heads"
    if key in _FFN_KEYS and parent.endswith("ffn"):
        return "ffn"
    if key in ("wi", "wg", "wo") and parent.endswith("moe"):
        return "moe"
    return _TP_ROLES.get(key)


def place_params(p: dict, cfg: ModelConfig, mesh):
    """This rank's part of a param tree on ``mesh`` (see the module note),
    and the :class:`dist.comm.TPLayout` of what was cut, for
    ``dist.comm.use_tp``.

    Tensor leaves keep the slab of each dim ``param_pspecs`` (no fsdp) puts
    on ``"model"``: query and KV heads, the dense / float KAN-FFN and MoE
    expert hidden dims, the patch projection's output columns and the
    vocabulary; deployed KAN bundles are placed on the mesh's ``"model"``
    axis (``place_deployed_kan``).  A role is cut whole or not at all.
    Where the model size divides the query head count but not the KV head
    count, the KV heads stay whole (``TPLayout.kv`` False) and each rank
    attends with those its query heads read."""
    from ..core.kan_network_deploy import DeployedKAN, place_deployed_kan
    from ..dist.sharding import axis_size, map_with_path, shard_param
    from ..runtime.meshexec import mesh_index

    msize = axis_size(mesh, "model")
    mi = mesh_index(mesh, "model")
    kan_mesh = mesh["model"] if "model" in mesh.mesh_dim_names else None
    cuts: dict = {}

    def place(path, leaf):
        if isinstance(leaf, DeployedKAN):
            return leaf if kan_mesh is None else place_deployed_kan(leaf,
                                                                    kan_mesh)
        role = _tp_role(path)
        whole = tuple(leaf.shape)
        leaf = shard_param(path, leaf, mesh)
        cut = tuple(leaf.shape) != whole
        if cut and role is None:
            raise ValueError(f"{path}: cut on the model axis, but no layer "
                             "reads it as a slab")
        if role is not None:
            cuts.setdefault(role, set()).add(cut)
        return leaf

    placed = map_with_path(place, p)
    split = [r for r, c in cuts.items() if len(c) > 1]
    roles = {r: True in c for r, c in cuts.items()}
    if split or (roles.get("kv") and not roles.get("heads")):
        raise ValueError(
            f"model={msize} cuts the {split or ['kv']} leaves unevenly "
            f"(heads {cfg.phys_heads} / KV {cfg.phys_kv_heads})")
    group = mesh.get_group("model") if kan_mesh is not None else None
    return placed, comm.TPLayout(group, size=msize, rank=mi, **roles)


def param_layout(cfg: ModelConfig, mesh) -> comm.TPLayout:
    """The :class:`dist.comm.TPLayout` :func:`place_params` gives ``cfg``'s
    params on ``mesh``, read off a tree on the meta device (no memory)."""
    return place_params(init_params(None, cfg, device="meta"), cfg, mesh)[1]


def _embed_tokens(p, tokens, cfg: ModelConfig):
    emb = p["embed"]
    tp = comm.tp_layout()
    if tp.vocab:
        # a vocabulary slab: rows [v0, v0 + V/m) of this rank; the others
        # look up zeros, and the sum over the group is the full lookup
        v0 = tp.rank * emb.shape[0]
        local = tokens - v0
        hit = (local >= 0) & (local < emb.shape[0])
        h = emb[torch.where(hit, local, 0)] * hit[..., None].to(emb.dtype)
        h = comm.tp_reduce(h, tp.group)
    else:
        h = emb[tokens]
    # scaled in the embedding's dtype, as the reference does; the scale is
    # filled on the device (a host-made tensor would cost a host-to-device
    # copy and a wait on every call)
    return h * torch.full((), math.sqrt(float(cfg.d_model)), dtype=h.dtype,
                          device=h.device)


def _lm_logits(p, h, cfg: ModelConfig):
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    tp = comm.tp_layout()
    if tp.vocab:  # a vocabulary slab of the columns
        h = comm.tp_copy(h, tp.group)
    logits = (h @ w).to(torch.float32)
    if tp.vocab:
        logits = comm.tp_gather(logits, tp.group, -1)
    return L.softcap(logits, cfg.final_logit_softcap)


def _positions(b: int, s: int, device, start=0):
    return (start + torch.arange(s, device=device))[None].expand(b, s)


def _encode(p, batch, cfg: ModelConfig):
    """The encoder over the stub frame embeddings plus sinusoidal positions
    (computed in f32, then cast), then ``enc_norm``: (B, enc_seq, D)."""
    frames = batch["enc_embeds"].to(L.torch_dtype(cfg))
    pos = L.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                 device=frames.device).to(frames.dtype)
    h = stack_forward(p["encoder"], frames + pos[None], _encoder_cfg(cfg))
    return L.rmsnorm(p["enc_norm"], h, cfg.norm_eps)


def _prepend_patches(p, h_tokens, batch, cfg: ModelConfig):
    patches = batch["patch_embeds"].to(L.torch_dtype(cfg)) @ p["patch_proj"]
    tp = comm.tp_layout()
    if tp.patch:  # a slab of the projection's output columns
        patches = comm.tp_gather(patches, tp.group, -1)
    return torch.cat([patches, h_tokens], dim=1)


def _embed_with_prefix(p, batch, cfg: ModelConfig):
    """The decoder's input rows and the encoder output: (h (B, P + S, D),
    enc_out or None, P), P the patch rows prepended (0 unless vlm)."""
    tokens = batch["tokens"]
    h = _embed_tokens(p, tokens, cfg)
    enc_out = _encode(p, batch, cfg) if cfg.encoder_layers > 0 else None
    if cfg.family == "vlm":
        h = _prepend_patches(p, h, batch, cfg)
    return h, enc_out, h.shape[1] - tokens.shape[1]


def forward(p, batch, cfg: ModelConfig):
    """Logits (B, S, V) of a whole token batch {"tokens": (B, S)} (+ its
    stub embeddings: :func:`prefix_batch_key`); a vlm's patch rows are
    attended to but get no logits."""
    h, enc_out, n_prefix = _embed_with_prefix(p, batch, cfg)
    b, s = h.shape[:2]
    h = stack_forward(p["decoder"], h, cfg,
                      positions=_positions(b, s, h.device), enc_out=enc_out)
    h = L.rmsnorm(p["final_norm"], h, cfg.norm_eps)
    return _lm_logits(p, h[:, n_prefix:], cfg)


def loss_fn(p, batch, cfg: ModelConfig, mask_count=None):
    """Mean next-token NLL of ``batch`` {"tokens", "targets": (B, S) int,
    optional "loss_mask": (B, S) float}: log-softmax of the f32 logits,
    the targets' entries gathered; with a mask, the masked mean (its sum
    clamped to at least 1).  ``mask_count`` replaces the mask's own sum
    as the divisor: a sharded step passes the mask count of the whole
    batch, so the ranks' losses over their rows add up to its mean."""
    logits = forward(p, batch, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["targets"].to(torch.int64)[..., None])[
        ..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        count = mask.sum() if mask_count is None else mask_count
        return (nll * mask).sum() / torch.clamp(count, min=1.0)
    return nll.mean()


def init_cache(p, cfg: ModelConfig, batch: int, max_len: int):
    """Contiguous caches of ``max_len`` positions (a vlm's patch rows
    count), and with an encoder the cross K/V of ``cfg.enc_seq`` rows."""
    enc_len = cfg.enc_seq if cfg.encoder_layers > 0 else 0
    return init_stack_cache(cfg, batch, max_len, enc_len=enc_len,
                            device=params_device(p))


@torch.no_grad()
def prefill(p, batch, cfg: ModelConfig, max_len: int, last_index=None):
    """Process the prompt; returns (last-token logits (B, V), filled cache).

    ``last_index``: optional (B,) index of the last REAL token per row (the
    engine pads prompts to power-of-two buckets and reads the first-token
    logits at the true prompt end), counted in tokens: a vlm's patch rows
    are added to it."""
    h, enc_out, n_prefix = _embed_with_prefix(p, batch, cfg)
    b, s = h.shape[:2]
    cache = init_cache(p, cfg, b, max_len)
    h, cache = stack_prefill(p["decoder"], cache, h, cfg,
                             positions=_positions(b, s, h.device),
                             enc_out=enc_out)
    with profile_scope("model.head"):
        h = L.rmsnorm(p["final_norm"], h, cfg.norm_eps)
        if last_index is None:
            sel = h[:, -1:, :]
        else:
            idx = torch.as_tensor(last_index, device=h.device).to(torch.int64)
            sel = h[torch.arange(b, device=h.device), n_prefix + idx][:, None]
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
