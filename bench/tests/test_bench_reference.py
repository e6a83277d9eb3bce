"""The plain references against the port on small configurations (CPU):
the same float weights, quantized by each side on its own."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bench_small as bs
from benchlib.manifest import load_reference


def kan_cfg():
    return bs.manifest().config("kan1-knot-g5-8b")


def test_kan_quantization_matches_the_ports_bit_for_bit():
    from repro_torch.core.asp_quant import ASPQuantSpec
    from repro_torch.core.kan_layer import quantize_kan_layer

    ref = load_reference("kan_network")
    g = torch.Generator().manual_seed(3)
    c = (torch.randn(64, 11, 48, generator=g) * 0.1).to(torch.bfloat16)
    wb = torch.randn(64, 48, generator=g)
    for grid in (5, 8):
        q = quantize_kan_layer({"c": c, "w_b": wb}, ASPQuantSpec(grid_size=grid))
        assert torch.equal(q["c_q"].float() * q["c_scale"],
                           ref.quantize_columns(c))
        assert torch.equal(q["w_b_q"].float() * q["w_b_scale"],
                           ref.quantize_columns(wb))
        sp = ref.LayerSpec(grid, 3, 8, 8, -1.0, 1.0)
        assert np.array_equal(sp.lut, q["lut"].numpy())


@pytest.mark.parametrize("seed", [0, 2**31 + 1])
def test_kan1_reference_equals_the_ports_ref_backend(seed):
    from repro_torch import runtime

    sys_ = bs.manifest().system("kan_network")
    sut = sys_.build(kan_cfg(), {}, seed, torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(seed % 97).normal(
        0, 0.45, (4096, 17)).clip(-1, 1).astype(np.float32))
    y_ref_port = runtime.execute(sut.dep, x, backend="ref")
    y_fused = sut.execute(x.numpy())
    ref = sut.reference()
    y, _ = ref.forward(x)
    assert torch.allclose(y, y_ref_port, atol=1e-6, rtol=0)
    st = load_reference("kan_network").judge_answers(ref, [(x, y_fused)])
    assert st["max_abs_err"] <= 1e-6 and st["rows"] == 4096


def port_logits(params, cfg, tokens, first):
    from repro_torch import runtime
    from repro_torch.core.kan_ffn_deploy import quantize_kan_ffn_params_tree
    from repro_torch.models import model as M

    lm = bs.manifest().system("lm_serve")
    mc = lm.model_config(cfg)
    q = quantize_kan_ffn_params_tree(params, mc)
    with runtime.use_backend("ref"), runtime.use_attn_backend("ref"), \
            torch.no_grad():
        return M.forward(q, {"tokens": tokens[None]}, mc)[0, first:]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 0.02)])
def test_lm_reference_equals_the_ports_forward(dtype, tol):
    cfg = bs.lm_config(dtype)
    lm = bs.manifest().system("lm_serve")
    params = lm.draw_params(cfg, 9, torch.device("cpu"))
    ref = load_reference("qwen2_kanffn").LMReference(params, cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        3, cfg["vocab_size"], 300))
    a = ref.logits(tokens, 280)
    b = port_logits(params, cfg, tokens, 280)
    assert a.shape == b.shape == (20, cfg["vocab_size"])
    assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_lm_served_streams_agree_with_the_reference():
    out = bs.run("qwen25-kanffn-reason", seed=3)
    assert out["correct"] and out["judged"]["tokens"] > 20
    assert out["checks"]["worst_gap"]["value"] < 0.05
