"""Render the roofline table from the dry-run's reports and patch
EXPERIMENTS.md (replaces FINAL_TABLE_PLACEHOLDER or the previous table).

    python -m repro_torch.scripts.roofline_md [reports/dryrun_torch]

The twin of the reference's ``scripts/roofline_md.py`` over the reports
``launch.dryrun`` writes.  The reference reads ``benchmarks/roofline.py``;
the port keeps its own copy of what it needs from there:
:func:`param_counts`, :func:`model_flops` and :func:`load_reports`.
"""

from __future__ import annotations

import glob
import json
import os
import sys

from ..configs.base import ModelConfig
from ..configs.registry import SHAPES, get_config

BEGIN = "<!-- ROOFLINE_TABLE_BEGIN -->"
END = "<!-- ROOFLINE_TABLE_END -->"
DEFAULT_DIR = "reports/dryrun_torch"


def param_counts(cfg: ModelConfig) -> tuple:
    """(total params N, activated params N_active), analytic."""
    d, v = cfg.d_model, cfg.vocab_size
    n_embed = v * d * (1 if cfg.tie_embeddings else 2)
    per_layer_attn = 0
    if cfg.num_heads:
        hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        per_layer_attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d

    def ffn_params():
        if cfg.ffn_kind == "swiglu":
            return 3 * d * cfg.d_ff
        if cfg.ffn_kind == "gelu":
            return 2 * d * cfg.d_ff
        if cfg.ffn_kind == "kan":
            nb = cfg.kan_grid + cfg.kan_order
            h = cfg.kan_d_hidden or max(1, cfg.d_ff // nb)
            return d * (nb + 1) * h + h * (nb + 1) * d
        return 0

    total = n_embed
    active = n_embed
    for kind in cfg.layer_kinds:
        if kind in ("global", "local", "bidir"):
            total += per_layer_attn
            active += per_layer_attn
            if cfg.num_experts:
                e_params = cfg.num_experts * 3 * d * cfg.d_ff
                total += e_params + d * cfg.num_experts
                active += cfg.num_experts_per_tok * 3 * d * cfg.d_ff
            else:
                total += ffn_params()
                active += ffn_params()
        elif kind == "rglru":
            w = cfg.rnn_width or d
            r = 2 * d * w + 2 * w * w + w * d
            total += r + ffn_params()
            active += r + ffn_params()
        elif kind == "ssm":
            din = cfg.ssm_expand * d
            nh = din // cfg.ssm_head_dim
            r = d * (2 * din + 2 * cfg.ssm_state + nh) + din * d
            total += r
            active += r
    if cfg.encoder_layers:
        total += cfg.encoder_layers * (per_layer_attn + ffn_params())
        active += cfg.encoder_layers * (per_layer_attn + ffn_params())
    return total, active


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """6 N_active D for train; 2 N_active D for inference-style cells."""
    sh = SHAPES[shape_name]
    _, active = param_counts(cfg)
    if sh["kind"] == "train":
        return 6.0 * active * sh["global_batch"] * sh["seq_len"]
    if sh["kind"] == "prefill":
        return 2.0 * active * sh["global_batch"] * sh["seq_len"]
    return 2.0 * active * sh["global_batch"]  # decode: one token per seq


def load_reports(directory: str = DEFAULT_DIR) -> list:
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def render(directory: str = DEFAULT_DIR) -> str:
    reports = load_reports(directory)
    lines = [
        BEGIN,
        "",
        "| arch | shape | mesh | flops/dev | peak GiB | coll GiB | compute s | memory s | coll s | dominant | frac | useful |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    singles = [r for r in reports if len(r["mesh"]) == 2]
    multis = [r for r in reports if len(r["mesh"]) == 3]
    for rs in (singles, multis):
        for r in sorted(rs, key=lambda r: (r["arch"], r["shape"])):
            mf = model_flops(get_config(r["arch"]), r["shape"])
            useful = mf / (r["flops_per_dev"] * r["devices"]) \
                if r["flops_per_dev"] else 0.0
            rl = r["roofline"]
            mesh = "x".join(str(m) for m in r["mesh"])
            lines.append(
                f"| {r['arch']} | {r['shape']} | {mesh} "
                f"| {r['flops_per_dev']:.2e} "
                f"| {r['memory'].get('peak_bytes', 0)/2**30:.1f} "
                f"| {r['collectives']['total']/2**30:.1f} "
                f"| {rl['compute_s']:.3f} | {rl['memory_s']:.3f} "
                f"| {rl['collective_s']:.3f} | {rl['dominant'].replace('_s','')} "
                f"| {rl['roofline_fraction']:.3f} | {min(useful, 9.99):.2f} |"
            )
    lines += ["", END]
    return "\n".join(lines)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    table = render(argv[0] if argv else DEFAULT_DIR)
    with open("EXPERIMENTS.md") as fh:
        text = fh.read()
    if BEGIN in text:
        pre = text.split(BEGIN)[0]
        post = text.split(END)[1]
        text = pre + table + post
    elif "FINAL_TABLE_PLACEHOLDER" in text:
        text = text.replace("FINAL_TABLE_PLACEHOLDER", "\n\n" + table + "\n")
    else:
        text += "\n" + table + "\n"
    with open("EXPERIMENTS.md", "w") as fh:
        fh.write(text)
    print("EXPERIMENTS.md updated with", table.count("\n") - 5, "rows")


if __name__ == "__main__":
    main()
