"""A KAN-FFN decoder served by ``ServeEngine`` through its ``Scheduler``:
the system under test of a ``"system": "lm_serve"`` configuration.

The configuration's file gives the model in the hub's keys plus the
paper's KAN-FFN (``kan_ffn``) and the port's head padding; the benchmark
draws every float weight from the seed on the device, in the program's
tree layout (layers stacked on a leading axis), one draw per kind of
leaf.  The engine quantizes and deploys the KAN-FFN blocks itself
(``kan_deploy=True``); the plain reference quantizes the same float
weights again on its own.
"""

from __future__ import annotations

import math

import torch

from benchlib.manifest import load_reference

CONTROLS = {"fp8_proj": ("proj",), "fp8_proj_head": ("proj", "head")}


def real_heads(cfg: dict) -> list:
    """The stored query heads that are real (the reference's rule)."""
    return load_reference(cfg["reference"]).real_heads(cfg)


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig

    k = cfg["kan_ffn"]
    return ModelConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        attn_pattern=("global",), qkv_bias=cfg["qkv_bias"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["torch_dtype"],
        head_pad_multiple=cfg["head_pad_multiple"],
        kv_pad_multiple=cfg["kv_pad_multiple"], ffn_kind="kan",
        kan_grid=k["grid"], kan_order=k["order"], kan_n_bits=k["n_bits"],
        kan_d_hidden=k["d_hidden"])


def draw_params(cfg: dict, seed: int, device) -> dict:
    """Float weights from ``seed`` on ``device`` in the program's layout.

    Scales as the program's initializers (``models/layers.py``):
    embeddings and head N(0, 0.02), projections N(0, 1/sqrt(d)); the
    padded query heads sit at the end of each KV head's group, as a
    published checkpoint loads into the padded layout, with zero query
    columns, bias and output rows, so the program computes the published
    grouping (``real_heads``); the qkv biases N(0, 0.02) and the norm
    scales N(0, 0.1) (stored as the offset from 1), where the program
    starts them at zero, so the check sees them; KAN-FFN c ~ N(0,
    0.1/sqrt(in)), w_b ~ N(0, 1/sqrt(in))."""
    mc = model_config(cfg)
    if mc.phys_kv_heads != mc.num_kv_heads:
        raise ValueError("the draw pads query heads only")
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 64))
    dt = getattr(torch, cfg["torch_dtype"])
    n, d, hd = mc.num_layers, mc.d_model, mc.head_dim
    hq, hkv = mc.phys_heads, mc.phys_kv_heads
    h, nb = mc.kan_d_hidden, mc.kan_grid + mc.kan_order

    def normal(shape, scale, dtype=dt):
        x = torch.randn(shape, generator=gen, device=device)
        return (x * scale).to(dtype)

    sd = 1.0 / math.sqrt(d)
    attn = {"wq": normal((n, d, hq, hd), sd), "wk": normal((n, d, hkv, hd), sd),
            "wv": normal((n, d, hkv, hd), sd), "wo": normal((n, hq, hd, d), sd)}
    if mc.qkv_bias:
        attn.update(bq=normal((n, hq, hd), 0.02), bk=normal((n, hkv, hd), 0.02),
                    bv=normal((n, hkv, hd), 0.02))
    pad = torch.ones(hq, dtype=torch.bool, device=device)
    pad[real_heads(cfg)] = False
    attn["wq"][:, :, pad] = 0
    attn["wo"][:, pad] = 0
    if mc.qkv_bias:
        attn["bq"][:, pad] = 0
    block = {
        "l0_attn": attn,
        "l0_ln1": {"scale": normal((n, d), 0.1, torch.float32)},
        "l0_ffn": {"c1": normal((n, d, nb, h), 0.1 * sd),
                   "wb1": normal((n, d, h), sd),
                   "c2": normal((n, h, nb, d), 0.1 / math.sqrt(h)),
                   "wb2": normal((n, h, d), 1.0 / math.sqrt(h))},
        "l0_ln2": {"scale": normal((n, d), 0.1, torch.float32)},
    }
    p = {"embed": normal((mc.vocab_size, d), 0.02),
         "final_norm": {"scale": normal((d,), 0.1, torch.float32)},
         "decoder": [block]}
    if not mc.tie_embeddings:
        p["lm_head"] = normal((d, mc.vocab_size), 0.02)
    return p


class LMSystem:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from repro_torch.serve import ServeEngine

        self.cfg = cfg
        self.device = device
        self.params = draw_params(cfg, seed, device)
        self.engine = ServeEngine(
            self.params, model_config(cfg), slots=int(mix["slots"]),
            max_len=int(mix["max_len"]), kan_deploy=True,
            kan_backend=cfg["kan_backend"],
            attn_backend=cfg["attention_backend"], device=device)

    def release(self) -> None:
        """Drop the engine (its cache and deployed bundles) before the
        reference runs."""
        self.engine = None

    def reference(self, fp8: tuple = ()):
        ref = load_reference(self.cfg["reference"])
        return ref.LMReference(self.params, self.cfg, fp8=fp8)

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


def build(cfg: dict, mix: dict, seed: int, device) -> LMSystem:
    return LMSystem(cfg, mix, seed, device)
