"""The moonlight-kanmoe-reason cell at a size a CPU holds: its manifest
entries, its plain reference against the port, its metric readers, and a
rehearsal that loads no JAX."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

import bench_small as bs
from benchlib.manifest import load_reference

CELL = "moonlight-kanmoe-reason"
CONFIG = "moonlight-16b-a3b-kanmoe-5l"
NEW_METRICS = ("b1_roofline.moe", "mla_roofline.decode", "moe_host_ms.decode",
               "expert_skew.moe", "mfu.moe", "b1_roofline.moe_dense")


def small_config(dtype: str = "bfloat16") -> dict:
    """The configuration at a width a CPU holds: every mechanism kept (MLA
    over a latent cache, a leading dense layer, routed experts top-k
    with a selection bias, shared experts), its sizes cut."""
    cfg = dict(bs.manifest().config(CONFIG))
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
               intermediate_size=128, moe_intermediate_size=32,
               n_routed_experts=8, num_experts_per_tok=3, vocab_size=512,
               num_hidden_layers=3, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, torch_dtype=dtype)
    cfg["kan_ffn"] = dict(cfg["kan_ffn"], d_hidden=16, expert_hidden=8,
                          shared_hidden=16)
    return cfg


def small_mix() -> dict:
    mix = dict(bs.manifest().mix("reason-8k"))
    mix.update(prompt=dict(mix["prompt"], median=12, min=8, max=16),
               output=dict(mix["output"], median=8, min=4, max=16),
               clients=6, slots=6, max_len=64, ramp_s=0.2, trace_s=0.3)
    return mix


def run_small(seed: int = bs.SEED, trace: bool = False, **kw) -> dict:
    from benchlib.harness import run_cell

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_cell(CELL, seed, 2.0, trace, "cpu", cfg=small_config(),
                        mix=small_mix(), **kw)
    finally:
        torch.set_num_threads(threads)


def test_manifest_holds_the_config_cell_and_metrics():
    m = bs.manifest()
    bm = m.data
    conf = next(c for c in bm["configs"] if c["name"] == CONFIG)
    assert conf["reduced"] == ["num_hidden_layers"]
    w = m.cell(CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "reason-8k", 1)
    cfg = m.config(CONFIG)
    # every width as published; depth 27 -> 5 (1 dense + 4 MoE)
    assert (cfg["hidden_size"], cfg["n_routed_experts"],
            cfg["num_experts_per_tok"], cfg["n_shared_experts"],
            cfg["num_attention_heads"], cfg["vocab_size"],
            cfg["kv_lora_rank"], cfg["num_hidden_layers"]) == (
        2048, 64, 6, 2, 16, 163840, 512, 5)
    mix = m.mix("reason-8k")
    assert (mix["clients"], mix["slots"], mix["max_len"]) == (256, 256, 8192)
    e2e = {x["name"] for x in m.metrics_for(CELL, False)}
    assert e2e == {"tokens_per_s", "itl_p95_ms", "setup_s"}
    per_layer = {x["name"] for x in m.metrics_for(CELL, True)}
    assert set(NEW_METRICS) <= per_layer
    assert {"idle_share.lm", "peak_mem_gib.lm", "deploy_share.setup",
            "decode_step_ms.itl", "kernels_per_decode_step.decode",
            "attn_host_ms.decode", "ffn_host_ms.decode"} <= per_layer
    assert m.limits(CELL)["checks"].keys() == {"worst_gap", "mean_gap"}


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_reference_matches_the_port(seed):
    """Prefill then decode through the latent cache against the plain
    reference's float32 full forward pass at the small size: within 2e-3
    of logits of ~1 (f32 rounding, and KAN entry codes that sit on a
    rounding tie take either side: one such flip moved a logit by 9e-4 in
    trials); the same path in bfloat16, on the bfloat16 rounding of the
    same weights, misses it (bfloat16 logits, and routing choices its
    rounding flips)."""
    from repro_torch.core.kan_ffn_deploy import quantize_kan_ffn_params_tree
    from repro_torch.models import model as M
    from repro_torch.serve.engine import step_scope

    sysm = bs.manifest().system("lm_moe_serve")
    diffs, want = {}, None
    for dtype in ("float32", "bfloat16"):
        cfg = small_config(dtype)
        mc = sysm.model_config(cfg)
        params = sysm.draw_params(cfg, seed, torch.device("cpu"))
        q = quantize_kan_ffn_params_tree(params, mc)
        if want is None:
            ref = load_reference("moonlight_kanmoe").MoonlightReference(
                params, cfg)
        g = torch.Generator().manual_seed(seed % 1000)
        s, first = 40, 16
        tokens = torch.randint(3, cfg["vocab_size"], (s,), generator=g)
        with step_scope("fused", "ref"):
            lg, cache = M.prefill(q, {"tokens": tokens[None, :first]}, mc,
                                  max_len=64)
            rows = [lg[0]]
            for p in range(first, s - 1):
                lg, cache = M.decode_step(q, cache, tokens[p:p + 1],
                                          torch.tensor([p]), mc)
                rows.append(lg[0])
        if want is None:
            want = ref.logits(tokens[:s - 1], first - 1)
        diffs[dtype] = (torch.stack(rows) - want).abs().max().item()
    assert diffs["float32"] <= 2e-3, diffs
    assert diffs["bfloat16"] > 2e-3, diffs


def test_cpu_run_is_correct_and_reads_the_counter_metrics():
    out = run_small(trace=True)
    assert out["correct"] and out["failed"] == 0
    got = out["metrics"]
    # no device on the CPU: the trace readers give nothing, the program's
    # spans and counters do
    assert "b1_roofline.moe" not in got and "mfu.moe" not in got
    assert got["moe_host_ms.decode"]["value"] > 0
    assert got["expert_skew.moe"]["value"] >= 1.0


def test_the_work_counts_of_a_grouped_call():
    from benchlib import work, work_mla_moe

    m = work_mla_moe.MoEDims.of(bs.manifest().config(CONFIG))
    calls = work_mla_moe.moe_grouped(m, 256)
    assert len(calls) == 2 * 4
    one = work.kan_layer(256 * 6, 2048, 128, 8, 3, 8, 8, 8, 2, 2)
    weights = work.kan_layer(0, 2048, 128, 8, 3, 8, 8, 8, 2, 2).nbytes
    assert calls[0].flops == one.flops
    assert calls[0].nbytes == one.nbytes + 63 * weights
    dec = work_mla_moe.mla_decode(m, [1000, 3000])
    assert dec.nbytes == 4000 * 576 * 2 + 2 * 16 * (576 + 512) * 2


def test_dense_b1_roofline_reads_the_ffn_outside_the_grouped_experts():
    from types import SimpleNamespace

    from benchlib import work, work_mla_moe
    from benchlib.trace import Trace

    cfg = bs.manifest().config(CONFIG)
    m = work_mla_moe.MoEDims.of(cfg)
    calls = work_mla_moe.ffn_ungrouped(m, 256)
    assert len(calls) == 2 * (1 + 4)
    assert calls[0].flops == work.kan_layer(256, 2048, 1024, 8, 3, 8, 8, 8,
                                            2, 2).flops
    assert calls[2].flops == work.kan_layer(256, 2048, 256, 8, 3, 8, 8, 8,
                                            2, 2).flops
    # one decode step: a dense B1 call, a grouped one inside the experts'
    # range, a shared one, and a B1 call outside model.ffn
    ops = [(0.0, 1.0, "kan_layer_kernel<1>", "kernel"),
           (2.0, 5.0, "kan_layer_kernel<2>", "kernel"),
           (6.0, 7.0, "kan_layer_kernel<1>", "kernel"),
           (8.0, 9.0, "kan_layer_kernel<1>", "kernel")]
    host = {"model.ffn": [(0.0, 7.5)], "model.moe.experts": [(1.5, 5.5)],
            "model.moe.shared": [(5.5, 7.5)]}
    rec = SimpleNamespace(cfg=cfg, device_trace=Trace(ops, host, {}, 10.0),
                          traced_steps=[{"prefills": [],
                                         "decode_keys": [100] * 256}])
    got = bs.manifest().reader("b1_roofline.moe_dense").read(rec)
    assert got == pytest.approx(work.roofline_percent(calls, 2.0))
    rec.device_trace = Trace(ops, {"model.ffn": [(0.0, 7.5)]}, {}, 10.0)
    assert bs.manifest().reader("b1_roofline.moe_dense").read(rec) is None


REHEARSAL = """
import json, sys
sys.path[:0] = [{tests!r}]
import test_bench_moonlight as t
from benchlib.harness import banned_modules
out = t.run_small(trace=True)
print(json.dumps({{"banned": banned_modules(),
                   "modules": sorted({{n.split(".")[0] for n in sys.modules}}),
                   "correct": out["correct"]}}))
"""


def test_rehearsal_of_the_cell_loads_no_jax():
    code = REHEARSAL.format(tests=str(bs.BENCH / "tests"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=bs.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["banned"] == [] and out["correct"] is True
    for name in ("jax", "jaxlib", "flax", "repro"):
        assert name not in out["modules"]
