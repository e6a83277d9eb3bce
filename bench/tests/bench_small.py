"""Small sizes of the benchmark's cells for the CPU tests: the same files,
with the widths, lengths and windows cut so a test run holds them."""

from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib.manifest import Manifest  # noqa: E402

SEED = 2**31 + 11


def manifest() -> Manifest:
    return Manifest(ROOT)


def lm_config(dtype: str = "bfloat16") -> dict:
    """The qwen2.5-14b configuration at a width a CPU holds (4 heads of 16
    over 2 KV heads, padded to 6 stored heads so the padding is seen)."""
    cfg = dict(manifest().config("qwen2.5-14b-kanffn-4l"))
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=128, vocab_size=512, num_hidden_layers=2,
               head_pad_multiple=3, kv_pad_multiple=0, torch_dtype=dtype)
    cfg["kan_ffn"] = dict(cfg["kan_ffn"], d_hidden=16)
    return cfg


def lm_mix(cell: str) -> dict:
    m = manifest()
    mix = dict(m.mix(m.cell(cell)["traffic"]))
    if cell.endswith("rag"):
        mix.update(prompt=dict(mix["prompt"], median=40, min=16, max=64),
                   output=dict(mix["output"], min=4, max=12), max_len=128,
                   ramp_s=0.2, trace_s=0.3, check_requests=16)
    else:
        mix.update(prompt=dict(mix["prompt"], median=12, min=8, max=16),
                   output=dict(mix["output"], median=8, min=4, max=16),
                   clients=6, slots=6, max_len=64, ramp_s=0.2, trace_s=0.3)
    return mix


def knot_mix() -> dict:
    mix = dict(manifest().mix("knot-bulk"))
    mix.update(rows={"dist": "lognormal", "median": 512, "sigma": 0.7,
                     "min": 128, "max": 2048},
               pool_rows=8192, ramp_s=0.1, trace_s=0.2, sequence=64,
               check_answers=8)
    return mix


def run(cell: str, seed: int = SEED, seconds: float = 2.0, trace=False,
        **kw) -> dict:
    """One CPU run of ``cell`` at the small sizes, on one thread (the test
    run shares the machine's cores among its workers)."""
    import torch

    from benchlib.harness import run_cell

    if cell.startswith("knot"):
        kw.setdefault("mix", knot_mix())
    else:
        kw.setdefault("mix", lm_mix(cell))
        kw.setdefault("cfg", lm_config())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_cell(cell, seed, seconds, trace, "cpu", **kw)
    finally:
        torch.set_num_threads(threads)
