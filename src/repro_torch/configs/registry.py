"""Assigned architectures (public-literature configs) + the paper's own KAN.

A copy of ``repro.configs.registry`` (the port keeps its own).

Every entry is exactly the assignment table; sources in brackets.  Reduced
("smoke") variants shrink depth/width/experts/vocab for CPU tests while
keeping the family structure (pattern, MoE top-k, SSD state, etc.).
"""

from __future__ import annotations

import dataclasses

from .base import ModelConfig

# --- dense -------------------------------------------------------------------

LLAMA3_405B = ModelConfig(  # [arXiv:2407.21783]
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    head_dim=128, d_ff=53248, vocab_size=128256,
    attn_pattern=("global",), rope_theta=500000.0,
    optimizer="adafactor", microbatch=16,
)

PHI3_MEDIUM = ModelConfig(  # [arXiv:2404.14219]
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    head_dim=128, d_ff=17920, vocab_size=100352,
    attn_pattern=("global",), microbatch=8,
    head_pad_multiple=16,  # 40q/10kv heads -> 48/16 physical (16-way TP);
                           # kv pad 12 was tried for a smaller decode cache but
                           # 12 is not TP-divisible -> replicated kv weights
                           # regress train (43 s memory term) — §Perf
)

GEMMA2_27B = ModelConfig(  # [arXiv:2408.00118; hf]
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
    head_dim=128, d_ff=36864, vocab_size=256000,
    attn_pattern=("local", "global"), window_size=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    ffn_kind="gelu", post_norms=True, tie_embeddings=True,
    microbatch=8,  # peak 18.5 -> <16 GiB/dev
)

QWEN25_14B = ModelConfig(  # [hf:Qwen/Qwen2.5-*]
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=13824, vocab_size=152064,
    attn_pattern=("global",), qkv_bias=True, rope_theta=1000000.0,
    microbatch=8,  # saved-residual footprint: 25.4 -> 13.4 GiB/dev (§Perf)
    head_pad_multiple=16,  # 40q heads -> 48 physical (16-way TP)
    kv_pad_multiple=0,     # 48/8 GQA groups stay integral; halves decode KV
)

# --- audio enc-dec -----------------------------------------------------------

WHISPER_BASE = ModelConfig(  # [arXiv:2212.04356]
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    head_dim=64, d_ff=2048, vocab_size=51865,
    attn_pattern=("global",), encoder_layers=6, enc_seq=1500,
    ffn_kind="gelu",
    microbatch=4,  # peak 64.7 -> ~16 GiB/dev
)

# --- hybrid ------------------------------------------------------------------

RECURRENTGEMMA_9B = ModelConfig(  # [arXiv:2402.19427]
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256000,
    attn_pattern=("rglru", "rglru", "local"), window_size=2048,
    rnn_width=4096, ffn_kind="gelu", tie_embeddings=True, microbatch=4,
)

# --- ssm ---------------------------------------------------------------------

MAMBA2_370M = ModelConfig(  # [arXiv:2405.21060]
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    head_dim=0, d_ff=0, vocab_size=50280,
    attn_pattern=("ssm",), ffn_kind="none",
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    tie_embeddings=True,
    microbatch=8,  # SSD chunk matrices: 74 -> 8.6 GiB/dev peak (§Perf)
)

# --- moe ---------------------------------------------------------------------

MIXTRAL_8X7B = ModelConfig(  # [arXiv:2401.04088]
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=32000,
    attn_pattern=("local",), window_size=4096,
    num_experts=8, num_experts_per_tok=2, moe_dispatch="sort",
    microbatch=16,  # peak 33.2 -> <16 GiB/dev
)

OLMOE_1B_7B = ModelConfig(  # [arXiv:2409.02060]
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=1024, vocab_size=50304,
    attn_pattern=("global",), num_experts=64, num_experts_per_tok=8,
    microbatch=16,  # peak 27.8 -> 11.9 GiB/dev (§Perf, with cumsum dispatch)
)

# --- served by the port only (the reference package has no MLA and no
# DeepSeek-V3-style MoE, so these stay out of ARCHS, which mirrors its
# registry) -------------------------------------------------------------------

MOONLIGHT_16B_A3B = ModelConfig(  # [hf:moonshotai/Moonlight-16B-A3B]
    # DeepseekV3ForCausalLM: MLA without q-LoRA (arXiv:2405.04434 §2.1),
    # 64 routed experts top-6 under a sigmoid router with a selection bias
    # (noaux_tc, n_group 1; arXiv:2412.19437 §2.1.2), 2 shared experts,
    # one leading dense layer
    name="moonlight-16b-a3b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=192, d_ff=11264, vocab_size=163840,
    attn_pattern=("global",), rope_theta=50000.0, norm_eps=1e-5,
    num_experts=64, num_experts_per_tok=6, moe_d_ff=1408,
    num_shared_experts=2, first_dense_layers=1,
    router_bias=True, router_norm_topk=True, routed_scaling=2.446,
    kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128,
)

PORT_ARCHS = {c.name: c for c in [MOONLIGHT_16B_A3B]}

# --- vlm ---------------------------------------------------------------------

PIXTRAL_12B = ModelConfig(  # [hf:mistralai/Pixtral-12B-2409]
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    attn_pattern=("global",), rope_theta=1000000.0,
    num_patches=256, patch_embed_dim=1024,
    microbatch=8,  # peak 22.5 -> ~12 GiB/dev
)

# --- the paper's own application (edge KAN, knot theory) ---------------------
# Not an LM; lives in core/kan_layer + benchmarks.  Exposed here so
# --arch kan-knot selects the fig13 pipeline.

KAN_KNOT = {"name": "kan-knot", "dims": (17, 1, 14), "g_kan1": 5, "g_kan2": 68}


ARCHS = {
    c.name: c
    for c in [
        LLAMA3_405B, PHI3_MEDIUM, GEMMA2_27B, QWEN25_14B, WHISPER_BASE,
        RECURRENTGEMMA_9B, MAMBA2_370M, MIXTRAL_8X7B, OLMOE_1B_7B, PIXTRAL_12B,
    ]
}


def get_config(name: str) -> ModelConfig:
    """An assigned architecture, or one the port alone serves
    (``PORT_ARCHS``); a ``-kanffn`` suffix gives its ``kan_variant()``."""
    if name.endswith("-kanffn"):
        return get_config(name[: -len("-kanffn")]).kan_variant()
    return ARCHS[name] if name in ARCHS else PORT_ARCHS[name]


# ----------------------------------------------------------------------------
# Reduced configs for CPU smoke tests (same family structure, tiny sizes)
# ----------------------------------------------------------------------------


def smoke_config(name: str) -> ModelConfig:
    cfg = get_config(name)
    nl = max(len(cfg.attn_pattern) + 1, 2)  # >= one full pattern + remainder
    upd = dict(
        num_layers=nl,
        d_model=64,
        d_ff=0 if cfg.family == "ssm" else 128,
        vocab_size=256,
        head_dim=16,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=(2 if cfg.num_kv_heads > 1 else 1) if cfg.num_heads else 0,
        window_size=min(cfg.window_size, 32),
        rnn_width=64 if cfg.rnn_width else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        num_experts=4 if cfg.num_experts else 0,
        num_experts_per_tok=min(2, cfg.num_experts_per_tok),
        encoder_layers=2 if cfg.encoder_layers else 0,
        enc_seq=24 if cfg.encoder_layers else 1500,
        num_patches=8 if cfg.num_patches else 0,
        patch_embed_dim=32 if cfg.num_patches else 1024,
        kan_d_hidden=16 if cfg.ffn_kind == "kan" else 0,
        head_pad_multiple=0,
        kv_pad_multiple=-1,
        microbatch=0,
        dtype="float32",
        remat=False,
    )
    if cfg.mla:
        upd.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                   v_head_dim=16, head_dim=24, num_kv_heads=4)
    if cfg.num_shared_experts or cfg.first_dense_layers:
        # one dense layer and two MoE layers; top-3 of 8 experts
        upd.update(num_layers=cfg.first_dense_layers + 2, num_experts=8,
                   num_experts_per_tok=3, moe_d_ff=32)
        if cfg.ffn_kind == "kan" and cfg.routed_moe:
            upd.update(kan_expert_hidden=8, kan_shared_hidden=16)
    return dataclasses.replace(cfg, **upd)


# The four shapes assigned to the LM family
SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode"},
}

# long_500k runs only for sub-quadratic-state archs (see DESIGN.md):
LONG_OK = {"gemma2-27b", "recurrentgemma-9b", "mamba2-370m", "mixtral-8x7b"}


def cells():
    """All live (arch, shape) dry-run cells."""
    out = []
    for name in ARCHS:
        for shape in SHAPES:
            if shape == "long_500k" and name not in LONG_OK:
                continue
            out.append((name, shape))
    return out
