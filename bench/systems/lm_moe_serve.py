"""A DeepSeek-V3-style decoder with the paper's KAN in every FFN and
expert, served by ``ServeEngine`` through its ``Scheduler``: the system
under test of a ``"system": "lm_moe_serve"`` configuration.

The configuration's file gives the model in the hub's keys (latent
attention, routed and shared experts, leading dense layers, the sigmoid
router) plus the paper's KAN widths (``kan_ffn``); the benchmark draws
every float weight and the router's selection bias from the seed on the
device, in the program's tree layout (the leading dense layers and the
MoE layers as two groups, layers stacked on a leading axis, the routed
experts on the next), one draw per kind of leaf.  The engine quantizes
and deploys every KAN itself (``kan_deploy=True``); the plain reference
quantizes the same float weights again on its own.  Same interface as
``lm_serve.py``: ``engine``, ``release``, ``judge``, ``control``.  On
the card the engine replays its decode steps from CUDA graphs
(``cuda_graphs``).
"""

from __future__ import annotations

import math

import torch

from benchlib.manifest import load_reference

CONTROLS = {"fp8_proj": ("proj",), "fp8_proj_head": ("proj", "head")}

# what the port's routed layer computes: one expert group, sigmoid scores,
# the bias-steered top-k, no q-LoRA
_NEEDS = {"n_group": 1, "topk_group": 1, "scoring_func": "sigmoid",
          "topk_method": "noaux_tc", "q_lora_rank": None, "moe_layer_freq": 1}


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig

    for key, want in _NEEDS.items():
        if cfg[key] != want:
            raise ValueError(f"{cfg['name']}: {key} {cfg[key]!r}, the port "
                             f"serves {want!r}")
    k = cfg["kan_ffn"]
    return ModelConfig(
        name=cfg["name"], family="moe",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        attn_pattern=("global",), rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["torch_dtype"],
        ffn_kind="kan", kan_grid=k["grid"], kan_order=k["order"],
        kan_n_bits=k["n_bits"], kan_d_hidden=k["d_hidden"],
        kan_expert_hidden=k["expert_hidden"],
        kan_shared_hidden=k["shared_hidden"],
        num_experts=cfg["n_routed_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        moe_d_ff=cfg["moe_intermediate_size"],
        num_shared_experts=cfg["n_shared_experts"],
        first_dense_layers=cfg["first_k_dense_replace"],
        router_bias=True,
        router_norm_topk=cfg["norm_topk_prob"],
        routed_scaling=cfg["routed_scaling_factor"],
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"])


def draw_params(cfg: dict, seed: int, device) -> dict:
    """Float weights from ``seed`` on ``device`` in the program's layout.

    Scales as the program's initializers (``models/layers.py``):
    embeddings and head N(0, 0.02), projections N(0, 1/sqrt(fan_in)), the
    router N(0, 1/sqrt(d)) in float32; the selection bias N(0,
    ``router_bias_std``) in float32 and the norm scales N(0, 0.1) (stored
    as the offset from 1), where the program starts them at zero, so the
    check sees them; every KAN c ~ N(0, 0.1/sqrt(in)), w_b ~ N(0,
    1/sqrt(in))."""
    mc = model_config(cfg)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 64))
    dt = getattr(torch, cfg["torch_dtype"])
    d, h, e = mc.d_model, mc.num_heads, mc.num_experts
    dn, dr, dv, r = (mc.qk_nope_head_dim, mc.qk_rope_head_dim,
                     mc.v_head_dim, mc.kv_lora_rank)
    nb = mc.kan_grid + mc.kan_order

    def normal(shape, scale, dtype=dt):
        x = torch.randn(shape, generator=gen, device=device)
        return (x * scale).to(dtype)

    def kan(n, lead, hid):
        return {"c1": normal((n, *lead, d, nb, hid), 0.1 / math.sqrt(d)),
                "wb1": normal((n, *lead, d, hid), 1.0 / math.sqrt(d)),
                "c2": normal((n, *lead, hid, nb, d), 0.1 / math.sqrt(hid)),
                "wb2": normal((n, *lead, hid, d), 1.0 / math.sqrt(hid))}

    def block(n, dense):
        b = {"l0_attn": {
                "wq": normal((n, d, h, dn + dr), 1.0 / math.sqrt(d)),
                "wkva": normal((n, d, r + dr), 1.0 / math.sqrt(d)),
                "kv_norm": {"scale": normal((n, r), 0.1, torch.float32)},
                "wkvb": normal((n, r, h, dn + dv), 1.0 / math.sqrt(r)),
                "wo": normal((n, h, dv, d), 1.0 / math.sqrt(h * dv))},
             "l0_ln1": {"scale": normal((n, d), 0.1, torch.float32)},
             "l0_ln2": {"scale": normal((n, d), 0.1, torch.float32)}}
        if dense:
            b["l0_ffn"] = kan(n, (), mc.kan_d_hidden)
        else:
            b["l0_moe"] = {
                "router": normal((n, d, e), 1.0 / math.sqrt(d),
                                 torch.float32),
                "bias": normal((n, e), cfg["router_bias_std"],
                               torch.float32),
                **kan(n, (e,), mc.kan_expert_hidden),
                "shared": kan(n, (), mc.kan_shared_hidden)}
        return b

    n_dense = mc.first_dense_layers
    p = {"embed": normal((mc.vocab_size, d), 0.02),
         "final_norm": {"scale": normal((d,), 0.1, torch.float32)},
         "decoder": [block(n_dense, True),
                     block(mc.num_layers - n_dense, False)],
         "lm_head": normal((d, mc.vocab_size), 0.02)}
    return p


@torch.no_grad()
def balance_router_bias(params: dict, cfg: dict, seed: int, device) -> None:
    """Set every MoE layer's selection bias in place by the published
    auxiliary-loss-free update (DeepSeek-V3, arXiv:2412.19437 §2.1.2):
    b_i += gamma * sign(mean load - load_i), ``rounds`` times, on the
    rows that reach the layer's router when ``tokens`` seed-drawn tokens
    (uniform over the prompts' ids) run through the plain reference, layer
    by layer (each layer's update before the next layer's rows are
    computed), so the served routing is about as balanced as a trained
    router's.  ``cfg["router_balance"]`` gives ``tokens``, ``rounds`` and
    ``gamma``."""
    bal = cfg["router_balance"]
    ref = load_reference(cfg["reference"]).MoonlightReference(params, cfg)
    gen = torch.Generator(device=device).manual_seed(
        (seed * 2 + 1) % (1 << 64))
    tokens = torch.randint(3, cfg["vocab_size"], (int(bal["tokens"]),),
                           generator=gen, device=device)
    k, e = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    bias = params["decoder"][1]["l0_moe"]["bias"]
    index = {id(lay["moe"]): i for i, lay in enumerate(
        lay for lay in ref.layers if lay["moe"] is not None)}

    def steer(moe, x):
        s = torch.sigmoid(x.float() @ moe["router"])
        b = bias[index[id(moe)]]  # a view: the update lands in params
        for _ in range(int(bal["rounds"])):
            load = torch.bincount(torch.topk(s + b, k, dim=-1).indices
                                  .flatten(), minlength=e).float()
            b += float(bal["gamma"]) * torch.sign(load.mean() - load)
        moe["bias"] = b

    h = ref.embed(tokens)
    for lay in ref.layers:
        h = ref.block(lay, h, steer)


class LMMoESystem:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from repro_torch.serve import ServeEngine

        self.cfg = cfg
        self.device = device
        self.params = draw_params(cfg, seed, device)
        balance_router_bias(self.params, cfg, seed, device)
        self.engine = ServeEngine(
            self.params, model_config(cfg), slots=int(mix["slots"]),
            max_len=int(mix["max_len"]), kan_deploy=True,
            kan_backend=cfg["kan_backend"],
            attn_backend=cfg["attention_backend"], device=device,
            cuda_graphs=device.type == "cuda")

    def release(self) -> None:
        """Drop the engine (its cache and deployed bundles) before the
        reference runs."""
        self.engine = None

    def reference(self, fp8: tuple = ()):
        ref = load_reference(self.cfg["reference"])
        return ref.MoonlightReference(self.params, self.cfg, fp8=fp8)

    def judge(self, answers) -> dict:
        """Score each served stream ``(prompt, tokens)`` with the plain
        reference (teacher-forced over prompt + tokens) by the gaps by
        which the served tokens' logits lie below the reference's best."""
        ref = load_reference(self.cfg["reference"])
        return ref.judge_streams(self.reference(), answers)

    def control(self, answers) -> dict:
        """The controls on the same prompts and tokens, by name: at each
        position, the reference's gap of the token that the reference
        with float8 linear layers (``CONTROLS``) puts first."""
        ref = load_reference(self.cfg["reference"])
        base = self.reference()
        return {name: ref.control_gaps(base, self.reference(fp8), answers)
                for name, fp8 in CONTROLS.items()}


def build(cfg: dict, mix: dict, seed: int, device) -> LMMoESystem:
    return LMMoESystem(cfg, mix, seed, device)
