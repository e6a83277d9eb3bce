"""Model configuration schema shared by all assigned architectures.

A copy of ``repro.configs.base`` (the port keeps its own).

One frozen dataclass describes every family (dense / audio enc-dec / hybrid
RG-LRU / SSM / MoE / VLM).  ``attn_pattern`` gives the repeating per-layer
block structure; ``num_layers`` is the TOTAL layer count (the pattern is
tiled and truncated, so e.g. recurrentgemma's 38 = 12x(R,R,A)+ (R,R)).

The paper's technique enters through ``ffn_kind="kan"`` (KAN-FFN with
ASP-KAN-HAQ quantization available on every KAN layer) — assigned configs
keep their published FFN so the dry-run matches public literature, and each
config exposes a ``.kan_variant()`` for the paper-technique cells.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|audio|hybrid|ssm|moe|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention structure
    attn_pattern: tuple = ("global",)  # layer kinds: global|local|rglru|ssm
    window_size: int = 4096            # for "local" layers
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # Pad physical head counts up to a multiple of the TP axis (Megatron-style
    # deployment padding).  Logical arch is unchanged: padded wo rows start at
    # zero.  Without this, archs whose head count doesn't divide the TP axis
    # (qwen/phi3: 40 heads on 16-way TP) leave ALL attention weights
    # replicated and XLA all-gathers batch activations to form weight grads —
    # a measured ~28x step-cost blowup (EXPERIMENTS.md §Perf).
    head_pad_multiple: int = 0
    kv_pad_multiple: int = -1          # -1 -> follow head_pad_multiple; 0 -> no pad

    # --- ffn
    ffn_kind: str = "swiglu"           # swiglu|gelu|kan|none
    # --- moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "cumsum"       # cumsum|sort (see §Perf: E-regime dependent)
    # DeepSeek-V3-style MoE (the port's own; the reference has none of it):
    # expert width apart from d_ff, shared experts (one MLP of
    # n * moe_d_ff), leading dense layers, and a sigmoid router whose
    # selection bias steers which experts are picked but not their gates.
    # Such a layer (``routed_moe``) drops no token (no capacity), and its
    # kan_variant() replaces the experts too.
    moe_d_ff: int = 0                  # 0 -> d_ff
    num_shared_experts: int = 0
    first_dense_layers: int = 0
    router_bias: bool = False          # noaux_tc's e_score_correction_bias
    router_norm_topk: bool = False     # gates = selected scores / their sum
    routed_scaling: float = 1.0
    # --- latent attention (MLA, DeepSeek-V2 §2.1; no q-LoRA): the cache
    # holds kv_lora_rank latent values and one shared rotary key of
    # qk_rope_head_dim per token; 0 -> GQA
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- ssm (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- rglru (recurrentgemma)
    rnn_width: int = 0                 # 0 -> d_model
    # --- kan ffn (the paper's technique)
    kan_grid: int = 8
    kan_order: int = 3
    kan_n_bits: int = 8
    kan_layer_bits: tuple = ()         # per-layer override of kan_n_bits:
                                       # one width per KANLinear half (mixed
                                       # precision; () -> uniform kan_n_bits)
    kan_d_hidden: int = 0              # 0 -> d_ff // (kan_grid + kan_order)
    kan_expert_hidden: int = 0         # a routed expert's KAN hidden width
    kan_shared_hidden: int = 0         # the shared experts' KAN hidden width
    # --- encoder-decoder (whisper)
    encoder_layers: int = 0
    enc_seq: int = 1500                # stub frame-embedding length (30 s)
    # --- vlm (pixtral)
    num_patches: int = 0               # stub patch-embedding length
    patch_embed_dim: int = 1024        # ViT output dim before projection

    # --- numerics / compilation
    norm_eps: float = 1e-6
    post_norms: bool = False           # gemma2-style post-layer norms
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    # --- distribution / training defaults (overridable per run)
    seq_shard_acts: bool = False       # Megatron-SP: residual stream sharded
                                       # over ("model") on the sequence dim
    microbatch: int = 0                # 0 -> no gradient accumulation
    optimizer: str = "adamw"           # adamw|adafactor|sgdm
    learning_rate: float = 3e-4

    def kan_variant(self, grid: int | None = None) -> "ModelConfig":
        """The paper-technique variant: FFN replaced by a quantizable KAN.

        The KAN hidden width is d_ff/(G+K) rounded UP to a multiple of 128 so
        it stays shardable on a 16-way TP axis — without this the dominant
        spline matmul is replicated on every device (measured 16x flops waste,
        EXPERIMENTS.md §Perf cell 3)."""
        g = grid if grid is not None else self.kan_grid
        nb = g + self.kan_order

        def hidden(width: int) -> int:
            return max(128, -(-(width // max(nb, 1)) // 128) * 128) \
                if width else 0

        extra = {}
        if self.routed_moe:
            # each routed expert, and the shared experts as one MLP of
            # num_shared_experts * moe_d_ff (as the published code has it)
            extra = dict(
                kan_expert_hidden=hidden(self.moe_d_ff),
                kan_shared_hidden=hidden(self.num_shared_experts
                                         * self.moe_d_ff))
        return dataclasses.replace(
            self, name=self.name + "-kanffn", ffn_kind="kan",
            kan_grid=g, kan_d_hidden=hidden(self.d_ff), **extra,
        )

    @property
    def routed_moe(self) -> bool:
        """A MoE routed as DeepSeek-V3's: sigmoid scores, dropless, with
        shared experts or a selection bias (the reference package's MoE is
        softmax top-k with a capacity)."""
        return self.num_experts > 0 and (self.num_shared_experts > 0
                                         or self.router_bias)

    @property
    def mla(self) -> bool:
        """Latent attention (MLA) in place of GQA."""
        return self.kv_lora_rank > 0

    @property
    def phys_heads(self) -> int:
        m = self.head_pad_multiple
        if m and self.num_heads % m:
            return self.num_heads + m - self.num_heads % m
        return self.num_heads

    @property
    def phys_kv_heads(self) -> int:
        m = self.head_pad_multiple if self.kv_pad_multiple < 0 \
            else self.kv_pad_multiple
        if m and self.num_kv_heads % m:
            return self.num_kv_heads + m - self.num_kv_heads % m
        return self.num_kv_heads

    @property
    def layer_kinds(self) -> tuple:
        """Per-layer kind for all num_layers, tiling attn_pattern."""
        p = self.attn_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def supports_long_context(self) -> bool:
        """True if no layer's state grows quadratically/unboundedly enough to
        forbid the 500k decode cell (pure full-attention archs are skipped)."""
        kinds = set(self.layer_kinds)
        return "global" not in kinds or self.family in ("hybrid",)
