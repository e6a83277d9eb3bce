"""moonlight-16b-a3b's kan_variant() on the port, at smoke size on the CPU:
latent attention (MLA) over the latent cache, the dropless routed MoE
with KAN experts (one grouped B1 call per half), its counters, and the
serving path, against the benchmark's plain reference
(``bench/reference/moonlight_kanmoe.py``, which imports nothing of the
port) and the port's own float and expanded forms."""

import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core import kan_ffn_deploy as KD
from repro_torch.kernels.kan_spline import cardcheck as cc
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import paged_kv_supported, step_scope

BENCH = Path(__file__).resolve().parents[1] / "bench"
ARCH = "moonlight-16b-a3b-kanffn"


def _bench():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from benchlib.manifest import Manifest, load_reference

    return Manifest(BENCH.parent), load_reference


def _smoke(dtype="float32"):
    import dataclasses

    return dataclasses.replace(smoke_config(ARCH), dtype=dtype)


def test_config_has_the_published_numbers_and_kan_widths():
    cfg = get_config(ARCH)
    assert (cfg.d_model, cfg.num_heads, cfg.vocab_size, cfg.num_layers,
            cfg.rope_theta, cfg.norm_eps) == (2048, 16, 163840, 27, 50000.0,
                                              1e-5)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim) == (512, 128, 64, 128)
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.num_shared_experts,
            cfg.moe_d_ff, cfg.first_dense_layers, cfg.routed_scaling) == (
        64, 6, 2, 1408, 1, 2.446)
    # kan_variant's rule: max(128, ceil((width // 11) / 128) * 128)
    assert (cfg.kan_d_hidden, cfg.kan_expert_hidden,
            cfg.kan_shared_hidden) == (1024, 128, 256)
    assert not paged_kv_supported(cfg)
    with pytest.raises(ValueError, match="contiguous"):
        M.init_paged_cache(M.init_params(None, _smoke(), device="meta"),
                           _smoke(), 4, 8)


def _layer_inputs(seed, b=2, s=12):
    cfg = _smoke()
    gen = torch.Generator().manual_seed(seed)
    p = L.init_mla(gen, cfg)
    p["kv_norm"]["scale"] = torch.randn(cfg.kv_lora_rank, generator=gen) * 0.1
    x = torch.randn(b, s, cfg.d_model, generator=gen)
    return cfg, p, x


@pytest.mark.parametrize("seed", [0, 1])
def test_absorbed_decode_equals_the_expanded_form(seed):
    """Decode over the latent cache (absorbed) against the expanded MLA
    of the whole sequence at its last position, f32: equal to 1e-5 (the
    same products in another order)."""
    cfg, p, x = _layer_inputs(seed)
    b, s, _ = x.shape
    pos = torch.arange(s)[None].expand(b, s)
    with step_scope(None, "ref"):
        full, ckv = L.mla_attention(p, x, cfg, pos)
        cache = {"ckv": torch.zeros(b, 16, ckv.shape[-1])}
        cache["ckv"][:, :s - 1] = ckv[:, :s - 1]
        out, cache = L.mla_attention_decode(p, x[:, s - 1:], cache,
                                            torch.full((b,), s - 1), cfg)
    assert torch.allclose(out, full[:, s - 1:], atol=1e-5, rtol=1e-5)
    # the new row was written in place, the rest left as it was
    assert torch.allclose(cache["ckv"][:, :s], ckv, atol=1e-6)
    assert not cache["ckv"][:, s:].any()


def test_decode_write_drops_a_position_past_the_cache():
    """A decode step (S = 1) whose slot sits at the cache's end writes
    nothing there; the other slot's row lands at its position."""
    cfg, p, x = _layer_inputs(3, b=2, s=1)
    t = 8
    cache = {"ckv": torch.randn(2, t, cfg.kv_lora_rank
                                + cfg.qk_rope_head_dim)}
    before = cache["ckv"].clone()
    with step_scope(None, "ref"):
        _, cache = L.mla_attention_decode(p, x, cache, torch.tensor([3, t]),
                                          cfg)
    _, _, new = L._mla_latent(p, x, cfg, torch.tensor([[3], [t]]))
    assert torch.equal(cache["ckv"][1], before[1])
    assert torch.equal(cache["ckv"][0, 3], new[0, 0])
    rest = [i for i in range(t) if i != 3]
    assert torch.equal(cache["ckv"][0, rest], before[0, rest])


def test_absorbed_decode_backends_agree():
    """A verify step (S = 3) over the latent cache: "flash" (B2's latent
    instance; its plain recurrence on the CPU, 32-key tiles) against
    "ref" (one softmax over every cache row), f32: equal to 1e-5."""
    cfg, p, x = _layer_inputs(5, s=14)
    b, s, _ = x.shape
    pos = torch.arange(s - 3)[None].expand(b, s - 3)
    outs = {}
    for backend in ("flash", "ref"):
        with step_scope(None, backend):
            _, ckv = L.mla_attention(p, x[:, :s - 3], cfg, pos)
            cache = {"ckv": torch.zeros(b, 40, ckv.shape[-1])}
            cache["ckv"][:, :s - 3] = ckv
            outs[backend], _ = L.mla_attention_decode(
                p, x[:, s - 3:], cache, torch.full((b,), s - 3), cfg)
    assert torch.allclose(outs["flash"], outs["ref"], atol=1e-5, rtol=1e-5)


def test_latent_split_count_fills_the_card_from_shapes_alone():
    from repro_torch.kernels.attention import mla_split_count

    assert mla_split_count(256, 1, 16, 8192) == 2
    assert mla_split_count(300, 1, 16, 8192) == 1
    assert mla_split_count(4, 1, 16, 8192) == 66
    assert mla_split_count(4, 1, 16, 20) == 1


def test_prefill_attention_backends_agree():
    cfg, p, x = _layer_inputs(3)
    pos = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
    with step_scope(None, "flash"):
        a, _ = L.mla_attention(p, x, cfg, pos)
    with step_scope(None, "ref"):
        r, _ = L.mla_attention(p, x, cfg, pos)
    assert torch.allclose(a, r, atol=1e-5, rtol=1e-5)


def _moe_block(seed, cfg):
    gen = torch.Generator().manual_seed(seed)
    p = L.init_routed_moe(gen, cfg)
    p["bias"] = torch.randn(cfg.num_experts, generator=gen) * 0.05
    return p, gen


def test_routing_stays_dropless_when_every_token_picks_one_expert():
    cfg = _smoke()
    p, gen = _moe_block(4, cfg)
    p["bias"] = torch.zeros(cfg.num_experts)
    p["bias"][5] = 10.0  # every token selects expert 5
    x = torch.randn(1, 40, cfg.d_model, generator=gen)
    t, k = 40, cfg.num_experts_per_tok
    _, flat_e, _, seg = L.route_sigmoid(p, x[0], cfg)
    counts = (seg[1:] - seg[:-1]).tolist()
    assert counts[5] == t and sum(counts) == t * k
    assert (flat_e.reshape(t, k) == 5).sum(-1).tolist() == [1] * t
    dep = {"router": p["router"], "bias": p["bias"],
           "deployed": KD.deploy_kan_moe(p, cfg)}
    y = L.routed_moe(dep, x, cfg)
    # one token's output alone equals its output among the 40: every row
    # was computed (a capacity drop would zero some of them)
    y1 = L.routed_moe(dep, x[:, 17:18], cfg)
    assert torch.allclose(y[:, 17:18], y1, atol=1e-6)
    assert bool((y.abs().sum(-1) > 0).all())


def test_bias_moves_selection_but_not_the_gates():
    cfg = _smoke()
    p, gen = _moe_block(5, cfg)
    x = torch.randn(64, cfg.d_model, generator=gen)
    g0, e0, _, _ = L.route_sigmoid({**p, "bias": torch.zeros_like(p["bias"])},
                                   x, cfg)
    p["bias"] = torch.randn(cfg.num_experts, generator=gen) * 0.3
    g1, e1, _, _ = L.route_sigmoid(p, x, cfg)
    k = cfg.num_experts_per_tok
    moved = (e0.reshape(-1, k).sort(-1).values
             != e1.reshape(-1, k).sort(-1).values).any(-1)
    assert 0 < int(moved.sum()) < 64
    # gates are the selected sigmoid scores (not score + bias), normalized
    # and scaled
    s = torch.sigmoid(x @ p["router"])
    want = s.gather(1, e1.reshape(-1, k))
    want = want / want.sum(-1, keepdim=True) * cfg.routed_scaling
    assert torch.allclose(g1, want, atol=1e-6)
    # where the selection is unchanged, so are the gates
    same = ~moved
    assert torch.allclose(g0[same].sort(-1).values, g1[same].sort(-1).values,
                          atol=1e-6)


def test_deployed_layer_equals_a_dense_loop_over_its_experts():
    """The grouped path (codes once a token, gathered into expert order,
    one call a half) against each expert's own deployed KAN-FFN applied to
    its tokens, gated and summed, plus the shared experts."""
    cfg = _smoke()
    p, gen = _moe_block(6, cfg)
    x = torch.randn(1, 30, cfg.d_model, generator=gen)
    dep = KD.deploy_kan_moe(p, cfg)
    y = L.routed_moe({"router": p["router"], "bias": p["bias"],
                      "deployed": dep}, x, cfg)
    xt = x[0]
    gates, flat_e, _, _ = L.route_sigmoid(p, xt, cfg)
    k = cfg.num_experts_per_tok
    want = KD.kan_ffn_apply_quantized(
        {"deployed": dep.shared}, x, cfg)[0].to(torch.float32)
    for e in range(cfg.num_experts):
        tok, j = torch.nonzero(flat_e.reshape(-1, k) == e, as_tuple=True)
        if tok.numel():
            one = KD.deploy_kan_ffn(KD.quantize_kan_ffn(
                {n: p[n][e] for n in ("c1", "wb1", "c2", "wb2")}, cfg), cfg)
            ye = KD.kan_ffn_apply_quantized({"deployed": one}, xt[tok][None],
                                            cfg)[0]
            want = want.index_add(0, tok, gates[tok, j, None] * ye)
    assert torch.allclose(y[0], want, atol=1e-5, rtol=1e-5)


def test_counters_equal_the_rows_routed():
    cfg = _smoke()
    p, gen = _moe_block(7, cfg)
    dep = {"router": p["router"], "bias": p["bias"],
           "deployed": KD.deploy_kan_moe(p, cfg)}
    before = dict(KD._moe_collect())
    x = torch.randn(2, 11, cfg.d_model, generator=gen)
    L.routed_moe(dep, x, cfg)
    after = KD._moe_collect()
    _, _, _, seg = L.route_sigmoid(p, x.reshape(22, -1), cfg)

    def delta(key):
        return after[key] - before[key]

    assert delta(("moe.rows", (("kind", "routed"),))) == \
        22 * cfg.num_experts_per_tok
    assert delta(("moe.rows", (("kind", "shared"),))) == 22
    assert delta("moe.grouped_launches") == 2
    assert delta("moe.busiest_rows") == int((seg[1:] - seg[:-1]).max())


@pytest.mark.parametrize("f,o,emit", [(64, 16, True), (16, 64, False)])
def test_grouped_call_equals_one_call_per_expert_on_the_cpu(f, o, emit):
    """The plain version of the grouped call against one plain call per
    expert (the card's kernel is held to the same in test_torch_gpu.py)."""
    gen = torch.Generator().manual_seed(f + o)
    st = cc.check_b1_grouped(torch.device("cpu"), gen, f, o, emit, 6,
                             experts=10)
    assert st["equal"] and st["empty"] == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_served_logits_match_the_reference(seed):
    """Prefill, then decode through the latent cache (the engine's path:
    quantized, deployed, grouped), against the plain reference's float32
    full forward pass, per position, at smoke size: within 2e-3 of logits
    of ~1 (the float32 path reads ~4e-7; a KAN entry code on a rounding
    tie may take either side, which moved a logit by up to 9e-4 in
    trials at 4x the width).  The same path in bfloat16, on the bfloat16
    rounding of the same weights, misses it: its logits are bfloat16
    (one step at 1 is 0.0078), and a routing choice its rounding flips
    moves a token's whole MoE output."""
    manifest, load_reference = _bench()
    sysm = manifest.system("lm_moe_serve")
    base = dict(manifest.config("moonlight-16b-a3b-kanmoe-5l"))
    base.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                intermediate_size=128, moe_intermediate_size=32,
                n_routed_experts=8, num_experts_per_tok=3, vocab_size=256,
                num_hidden_layers=3, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16)
    base["kan_ffn"] = dict(base["kan_ffn"], d_hidden=16, expert_hidden=8,
                           shared_hidden=16)
    diffs, want = {}, None
    for dtype in ("float32", "bfloat16"):
        cfg = dict(base, torch_dtype=dtype)
        mc = sysm.model_config(cfg)
        params = sysm.draw_params(cfg, 100 + seed, torch.device("cpu"))
        if want is None:
            ref = load_reference("moonlight_kanmoe").MoonlightReference(
                params, cfg)
        eng = ServeEngine(params, mc, slots=2, max_len=64, kan_deploy=True,
                          attn_backend="ref", device="cpu")
        g = torch.Generator().manual_seed(seed)
        prompt = torch.randint(3, 256, (20,), generator=g).tolist()
        req = Request(rid=0, prompt=prompt, max_new_tokens=24, eos_id=-1)
        slot = eng._free_slot()
        rows = [torch.as_tensor(eng._prefill_slot(slot, req))]
        toks = [int(rows[0].argmax())]
        for _ in range(23):
            tk = [0] * eng.slots
            tk[slot] = toks[-1]
            lg = eng.decode_active(tk)[slot].float()
            eng.pos[slot] += 1
            rows.append(lg)
            toks.append(int(lg.argmax()))
        if want is None:
            want = ref.logits(torch.tensor(prompt + toks[:-1]),
                              len(prompt) - 1)
        diffs[dtype] = (torch.stack(rows) - want).abs().max().item()
    assert diffs["float32"] <= 2e-3, diffs
    assert diffs["bfloat16"] > 2e-3, diffs


def test_engine_serves_streams_through_the_scheduler():
    cfg = _smoke()
    p = M.init_params(torch.Generator().manual_seed(8), cfg, device="cpu")
    eng = ServeEngine(p, cfg, slots=2, max_len=48, kan_deploy=True,
                      device="cpu")
    moe = eng.params["decoder"][1]["l0_moe"]
    assert "deployed" in moe and "c1" not in moe
    assert eng.cache[0]["l0_kv"]["ckv"].shape == (
        1, 2, 48, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    reqs = [Request(rid=i, prompt=list(range(5, 12 + i)), max_new_tokens=5,
                    eos_id=-1) for i in range(3)]
    done = eng.run(reqs)
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.output) == 5 and r.status == "done" for r in done)


def test_cuda_graphs_take_one_card_and_a_contiguous_cache():
    cfg = _smoke()
    p = M.init_params(torch.Generator().manual_seed(8), cfg, device="cpu")
    with pytest.raises(ValueError, match="cuda_graphs"):
        ServeEngine(p, cfg, slots=2, max_len=48, kan_deploy=True,
                    device="cpu", cuda_graphs=True)
