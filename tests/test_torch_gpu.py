"""Card-only tests of the port's CUDA kernels (``gpu`` marker).

Each kernel against its plain PyTorch version on the same CUDA tensors:
B1 and B3 at every spline order the kernel library is built for, through
the checks of ``repro_torch.kernels.kan_spline.cardcheck`` (outputs within
1e-5 + 1e-5 * |plain|: the same f32 terms summed in another order;
boundary codes equal up to the excused near-ties of ``repro_torch.parity``;
packed and unpacked B1 weights bit-identical), B1 at the full-width
KAN-FFN halves, B2 through ``repro_torch.kernels.attention.cardcheck`` (f32
within 2e-5 + 2e-5 * |plain|, bf16 within one more bf16 ulp, fully masked
rows exact zeros), small cases, the tensor-core instance with its KV axis
split, and the serving path's own shapes; B1's rows bit-identical at 8
and 1024 rows, packed == unpacked with feature splits, its register loop
bit-identical to its gather loop, padded columns of a noisy layer, its
grouped launch over 64 KAN experts bit-identical to one launch per expert
(and each segment within the B1 gate of the plain version); B2's latent
(MLA) decode instance against the plain recurrence, and one full-width
MLA layer of Moonlight-16B-A3B on B2 (prefill at D = 256, decode on the
latent instance) against the "ref" backend; the launch counters once per call of two kernels; B4
through ``repro_torch.kernels.cim_mac.cardcheck`` (the reference's ADC
contract: within one ADC LSB per array, >= 95% tight; the zero-IR 24-bit
case the plain matmul within 1e-3 relative plus half an LSB per array);
at the simulator path's six shapes and the reference's largest, on
ragged stream tiles, with a row's bits equal at 32 rows and the full
batch, and on the wide path's R-chunks;
the slice's fused path against "ref"; the acim backend's quiet run
against "fused" bit for bit and its noise under one generator seed; and
one layer of the full-width qwen2.5-14b KAN-FFN model served on the card,
also with speculative decoding (k = 2) against plain decode, and B1 at the
drafter's G = 4 halves.  The co-design slice: B1 at row tiles 16 and 32
bit-identical to 64 (KAN1, KAN2, the packed layer, a full-width half; 8,
1000 and 65536 rows), a tuned plan in the plan cache changing the row tile
and no output bit, training and the Pareto search deterministic on the
card (equal parameters, equal fronts under one seed), and the measured
tile sweep timing each distinct launch once.  The sliding-window and MoE
decoders: B1 at gemma2's kan_variant() halves (4608 / 3456), B2 at the
4200-token windowed prefill (the window excluding keys; softcap 50 at 2
query heads per KV head), olmoe's causal prefill and decode over wrapped
rings, and one full-width MoE layer of mixtral and olmoe against the CPU
(``repro_torch.models.cardcheck``: routing equal but at router near-ties,
outputs within 4 bf16 ulps).  The recurrent decoders: B1 at
recurrentgemma's kan_variant() halves (4096 / 1152), B2 at its D = 256
local layer (16 query heads over one KV head: the tensor-core instance)
at a 2300-token prefill and over wrapped 2048-slot rings (the KV axis
split), and one full-width RG-LRU layer and Mamba-2 block against the
CPU (outputs within 4 bf16 ulps of max|out|, conv states within one of
max|conv|, f32 states within 2 of max|state|).  The
encoder and patch prefixes: B1 at whisper-base's and pixtral-12b's
kan_variant() halves (512 / 256, 5120 / 1408), B2 at whisper's encoder
("full", 4 x 1500 frames), cross prefill and cross decode over 1500 keys,
pixtral's 1256-row causal prefill and "full" with more queries than keys,
and one full-width whisper encoder layer and cross-attention decoder layer
against the CPU (outputs within 4 bf16 ulps, cross K/V within one, and
left bit-equal by decode).  LM training
(``repro_torch.train.cardcheck``): the float KAN-FFN's custom backward at
the full-width halves against autograd of the plain forward, three train
steps on the card equal to the CPU's within 1e-5 (and B1 / B2 never
launched), the in-place optimizer bit-equal to the functional one, and a
bf16 restart bit-equal to the uninterrupted run.  Mesh serving: the
meshed runtime on a 1x1 NCCL mesh bit-identical to the unsharded call with
equal B1 launches, a model shard's B1 column slabs (at the whole layer's
feature split) bit-identical to the whole layer's columns, the NCCL
collectives called directly on the mesh's world-1 groups, and the int8
gradient codec on CUDA tensors equal to a numpy reckoning.  Meshed
training: ``TrainLoop(shardings=)`` on the 1x1 NCCL mesh bit-equal to the
unsharded loop (and its restart), a full-width mixtral MoE layer and the
float KAN-FFN as two ranks' slabs added by hand (``repro_torch.dist.
cardcheck``), and the gradient-carrying collectives.  The examples: the
quickstart twin (B3 and B1 twice each, its kernel and fused paths
against its quantized path under the parity gate) and the serve_demo
twin (B2 on every layer of every engine call, B1 on both halves of
every deployed call; streams equal their final outputs).  This file
imports only the port, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips (the check is inside the fixture, so every
worker collects the same tests).
"""

import pytest
import torch

from repro_torch import parity, runtime
from repro_torch.core.asp_quant import ASPQuantSpec
from repro_torch.core.kan_layer import KANSpec, init_kan_network
from repro_torch.core.kan_network_deploy import (
    deploy_kan_ffn_stack,
    deploy_kan_network,
    quantize_kan_network,
)
from repro_torch.kernels import cuda
from repro_torch.kernels.attention import cardcheck as ac
from repro_torch.kernels.cim_mac import cardcheck as mc
from repro_torch.kernels.kan_spline import cardcheck as cc
from repro_torch.runtime.executor import _entry_codes

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


def _by_kernel(counts: dict) -> dict:
    """Launch counts by kernel: without ``kan_pipeline_layer.regs``, which
    counts the B1 launches that took the register loop among
    ``kan_pipeline_layer``'s (the loop follows the call's shape)."""
    return {k: v for k, v in counts.items() if k != "kan_pipeline_layer.regs"}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("order", cc.ORDERS)
@pytest.mark.parametrize("grid,f,o", cc.B1_GEOMETRIES)
def test_b1_kernel_matches_plain(dev, grid, f, o, order):
    gen = torch.Generator(device=dev).manual_seed(grid + f + order)
    for flags in cc.B1_FLAGS:
        cc.check_b1(dev, gen, grid, f, o, flags, 512, order)


@pytest.mark.parametrize("grid,f,o,flags,rows", cc.B1_FFN_FULL)
def test_b1_kernel_matches_plain_at_full_width_ffn(dev, grid, f, o, flags,
                                                   rows):
    gen = torch.Generator(device=dev).manual_seed(f + rows)
    cc.check_b1(dev, gen, grid, f, o, flags, rows, eps=cc.FFN_FULL_TIE_EPS)


@pytest.mark.parametrize("grid,f,o,flags,rows", cc.B1_FFN_DRAFT)
def test_b1_kernel_matches_plain_at_draft_ffn(dev, grid, f, o, flags, rows):
    """The speculative drafter's halves (G=4: 7 basis functions) at full
    width, at the row buckets its decode and the 20-row verify give."""
    gen = torch.Generator(device=dev).manual_seed(f + rows + grid)
    cc.check_b1(dev, gen, grid, f, o, flags, rows, eps=cc.FFN_FULL_TIE_EPS)


@pytest.mark.parametrize("d", ac.HEAD_DIMS)
@pytest.mark.parametrize("kind", ac.KINDS)
@pytest.mark.parametrize("dtype", ac.DTYPES)
def test_b2_kernel_matches_plain(dev, dtype, kind, d):
    gen = torch.Generator(device=dev).manual_seed(d)
    for hq, hkv in ac.GQA:
        ac.check_b2(dev, gen, dtype=dtype, kind=kind, hq=hq, hkv=hkv, d=d)


@pytest.mark.parametrize("case", range(len(ac.B2_EXTRA)))
def test_b2_kernel_matches_plain_at_serving_geometry_and_softcap(dev, case):
    gen = torch.Generator(device=dev).manual_seed(case)
    ac.check_b2(dev, gen, **ac.B2_EXTRA[case])


@pytest.mark.parametrize("case", range(len(ac.B2_SPLIT)))
def test_b2_kernel_matches_plain_with_kv_splits(dev, case):
    """The bf16 tensor-core instance with its KV axis split (decode at
    T = 1023 and 4096, verify S = 3, a whole split masked, rows masked in
    every split: exact zeros; recurrentgemma's D = 256 decode over 2048
    and a ragged 2047 keys and under a window that masks most splits)."""
    gen = torch.Generator(device=dev).manual_seed(40 + case)
    st = ac.check_b2(dev, gen, **ac.B2_SPLIT[case])
    assert st["kv_splits"] > 1


@pytest.mark.parametrize("name,b,s,t,kind", ac.PATH_SHAPES)
def test_b2_kernel_matches_plain_at_serving_path_shapes(dev, name, b, s, t,
                                                        kind):
    ac.check_b2_path(dev, name, b, s, t, kind)


@pytest.mark.parametrize("grid,f,o,flags,rows", cc.B1_FFN_GEMMA2)
def test_b1_kernel_matches_plain_at_gemma2_ffn(dev, grid, f, o, flags, rows):
    gen = torch.Generator(device=dev).manual_seed(f + rows + 1)
    cc.check_b1(dev, gen, grid, f, o, flags, rows, eps=cc.FFN_FULL_TIE_EPS)


@pytest.mark.parametrize("case", range(len(ac.B2_A7A)))
def test_b2_kernel_matches_plain_at_window_and_moe_prefill(dev, case):
    gen = torch.Generator(device=dev).manual_seed(60 + case)
    st = ac.check_b2(dev, gen, **ac.B2_A7A[case])
    assert (st["window_excluded"] > 0) == (ac.B2_A7A[case]["kind"] == "local")


@pytest.mark.parametrize("name,hq,hkv,softcap", ac.B2_RING)
def test_b2_kernel_matches_plain_over_wrapped_rings(dev, name, hq, hkv,
                                                    softcap):
    assert ac.check_b2_ring(dev, name, hq, hkv, softcap)[
        "non_monotone_slots"] > 0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "olmoe-1b-7b"])
def test_moe_layer_on_the_card_matches_the_cpu(dev, arch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.cardcheck import check_moe_layer

    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
    st = check_moe_layer(dev, cfg, tokens=64)
    assert st["max_abs_err"] <= st["tol"]


@pytest.mark.parametrize("grid,f,o,flags,rows", cc.B1_FFN_RGEMMA)
def test_b1_kernel_matches_plain_at_recurrentgemma_ffn(dev, grid, f, o, flags,
                                                       rows):
    gen = torch.Generator(device=dev).manual_seed(f + rows + 2)
    cc.check_b1(dev, gen, grid, f, o, flags, rows, eps=cc.FFN_FULL_TIE_EPS)


@pytest.mark.parametrize("case", range(len(ac.B2_A7B)))
def test_b2_kernel_matches_plain_at_d256_local_prefill(dev, case):
    gen = torch.Generator(device=dev).manual_seed(70 + case)
    st = ac.check_b2(dev, gen, **ac.B2_A7B[case])
    assert st["window_excluded"] > 0 and st["instance"] == "mma"


@pytest.mark.parametrize("name,hq,hkv,softcap,d,window", ac.B2_RING_A7B)
def test_b2_kernel_matches_plain_over_d256_rings(dev, name, hq, hkv, softcap,
                                                 d, window):
    st = ac.check_b2_ring(dev, name, hq, hkv, softcap, d=d, window=window)
    assert st["non_monotone_slots"] > 0
    assert st["instance"] == "mma" and st["kv_splits"] > 1


@pytest.mark.parametrize("arch,kind", [("recurrentgemma-9b", "rglru"),
                                       ("mamba2-370m", "ssm")])
def test_recurrent_layer_on_the_card_matches_the_cpu(dev, arch, kind):
    from repro_torch.configs import get_config
    from repro_torch.models.cardcheck import check_recurrent_layer

    check_recurrent_layer(dev, get_config(arch), kind, tokens=1000, steps=4)


@pytest.mark.parametrize("grid,f,o,flags,rows",
                         cc.B1_FFN_WHISPER + cc.B1_FFN_PIXTRAL)
def test_b1_kernel_matches_plain_at_whisper_and_pixtral_ffn(dev, grid, f, o,
                                                           flags, rows):
    gen = torch.Generator(device=dev).manual_seed(f + rows + 3)
    cc.check_b1(dev, gen, grid, f, o, flags, rows, eps=cc.FFN_FULL_TIE_EPS)


@pytest.mark.parametrize("name,case", ac.B2_A7C)
def test_b2_kernel_matches_plain_at_encoder_cross_and_patch_shapes(dev, name,
                                                                    case):
    gen = torch.Generator(device=dev).manual_seed(80)
    st = ac.check_b2(dev, gen, **case)
    if name == "whisper_cross_decode":
        assert st["kv_splits"] > 1


def test_encoder_and_cross_decoder_layers_on_the_card_match_the_cpu(dev):
    from repro_torch.configs import get_config
    from repro_torch.models.cardcheck import check_encdec_layers

    st = check_encdec_layers(dev, get_config("whisper-base"))
    assert st["xkv_unchanged"]


def test_b2_wrapper_raises_instead_of_falling_back(dev):
    from repro_torch.kernels.attention import flash_attention

    q = torch.zeros(1, 4, 2, 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q[:, :, :1], q[:, :, :1])
    q = torch.zeros(1, 4, 2, 64, device=dev)
    with pytest.raises(ValueError, match="dtypes differ"):
        flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), q.half(), q.half())
    before = cuda.launch_counts().get("flash_attention", 0)
    empty = flash_attention(q[:, :0], q, q)       # no query: nothing launched
    assert empty.shape == (1, 0, 2, 64)
    assert cuda.launch_counts().get("flash_attention", 0) == before


def test_one_full_width_layer_serves_through_b1_and_b2(dev):
    """qwen2.5-14b kan_variant() at full width (d_model 5120, 48/8 heads,
    vocab 152064, KAN-FFN hidden 1280), bf16, cut to one layer: contiguous
    and paged engines serve through kernels B2 and B1 on every call."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import Request, ServeEngine

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("qwen2.5-14b").kan_variant(),
                              num_layers=1)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    prompts = [list(range(3, 23)), list(range(100, 400))]
    for kw in ({}, {"kv_block_size": 16, "prefill_chunk": 128}):
        eng = ServeEngine(params, cfg, slots=2, max_len=512, kan_deploy=True,
                          device=dev, **kw)
        cuda.reset_launch_counts()
        done = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                        for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        assert sorted(len(r.output) for r in done) == [4, 4], kw
        st = eng.compile_stats()
        calls = st["prefill_calls"] + st["decode_traces"]
        assert _by_kernel(cuda.launch_counts()) == {
            "flash_attention": calls, "kan_pipeline_layer": 2 * calls}, kw
        # the 300-token prompt's prefill takes B1's register loop
        assert cuda.launch_counts().get("kan_pipeline_layer.regs", 0) > 0, kw
        del eng
    del params
    torch.cuda.empty_cache()


def test_spec_decode_on_one_full_width_layer_matches_plain_decode(dev):
    """One layer of the full-width qwen2.5-14b kan_variant(), paged, with
    the default drafter (grid 4) at k = 2: the spec streams equal the
    k = 0 streams but where the k = 0 top-2 margin is within twice the
    measured verify-vs-decode logit difference (``serve.cardcheck``; with
    a difference of 0 they are equal), and B1 / B2 launch on every layer
    of every target and drafter call."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve import cardcheck as sc

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("qwen2.5-14b").kan_variant(),
                              num_layers=1)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    prompts = [list(range(3, 23)), list(range(100, 400))]
    kw = dict(slots=2, max_len=512, kan_deploy=True, kv_block_size=16,
              prefill_chunk=128, device=dev)

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]

    # the difference on an engine of its own (its prefills publish the
    # prompts' blocks to the prefix cache)
    delta = sc.verify_decode_delta(ServeEngine(params, cfg, **kw), prompts,
                                   2)["max_abs_delta"]
    eng = ServeEngine(params, cfg, **kw)
    margins = sc.record_step_margins(eng)
    base = {r.rid: r.output for r in eng.run(reqs())}
    del eng
    eng = ServeEngine(params, cfg, spec_decode=2, **kw)
    cuda.reset_launch_counts()
    spec = {r.rid: r.output for r in eng.run(reqs())}
    torch.cuda.synchronize()
    parted = sc.spec_divergences(base, spec, margins, delta)
    if delta == 0:
        assert spec == base
    st = eng.compile_stats()
    d = st["spec"]["draft"]
    calls = (st["prefill_calls"] + st["verify_calls"] + d["prefill_calls"]
             + d["decode_traces"])
    assert st["decode_traces"] == 0 and st["verify_calls"] > 0
    assert _by_kernel(cuda.launch_counts()) == {"flash_attention": calls,
                                                "kan_pipeline_layer": 2 * calls}
    print(f"verify-vs-decode |dlogit| {delta}; streams parted at {parted}")
    del eng, params
    torch.cuda.empty_cache()


def test_b1_rows_bit_identical_at_8_and_1024_rows(dev):
    """The feature split count ignores the batch, so the 5120 -> 1280
    half gives a row the same y and codes at 8 rows as at 1024."""
    st = cc.check_b1_rows_independent(dev, torch.Generator(device=dev)
                                      .manual_seed(31))
    assert st["equal"] and st["feature_splits"] > 1


@pytest.mark.parametrize("grid,f,o,flags,rows", cc.B1_FFN_PACKED)
def test_b1_packed_equals_unpacked_with_feature_splits(dev, grid, f, o, flags,
                                                       rows):
    from repro_torch.kernels.kan_spline.pipeline import feature_split_plan

    assert feature_split_plan(f, o)[0] > 1
    gen = torch.Generator(device=dev).manual_seed(32 + rows)
    cc.check_b1(dev, gen, grid, f, o, flags, rows, eps=cc.FFN_FULL_TIE_EPS)


@pytest.mark.parametrize("name,f,o,flags,rows,order", cc.B1_LOOP_CASES)
def test_b1_register_loop_bit_identical_to_the_gather(dev, name, f, o, flags,
                                                      rows, order):
    """B1's register loop gives the gather's bits, y and codes, at the
    shapes where the launch code takes it (both full-width qwen2.5-14b
    halves at 256 to 4096 rows, ragged last tiles, K+1 = 2..6, packed and
    unpacked, noise and the requantizer, one and several feature splits,
    a gemma2 and the whisper halves)."""
    gen = torch.Generator(device=dev).manual_seed(40 + rows + order)
    st = cc.check_b1_loops(dev, gen, f, o, flags, rows, order)
    assert st["equal"] and st["rule"] == "regs"


@pytest.mark.parametrize("name,f,o,emit,rows", cc.B1_GROUPED_CASES)
def test_b1_grouped_launch_bit_identical_to_one_launch_per_expert(
        dev, name, f, o, emit, rows):
    """B1's grouped launch over 64 experts' full-width 2048 x 128 (and
    128 x 2048) KAN halves, rows sorted by expert with every fifth expert
    empty, gives the bits of one B1 launch per expert, y and codes: at
    decode's ~24 rows an expert (the gather) and a prefill's ~190 (the
    register loop)."""
    gen = torch.Generator(device=dev).manual_seed(77 + rows + f)
    st = cc.check_b1_grouped(dev, gen, f, o, emit, rows)
    assert st["equal"] and st["empty"] >= 12
    assert st["rule"] == ("gather" if rows < 64 else "regs")


@pytest.mark.parametrize("name,b,s,t", ac.B2_MLA)
def test_b2_latent_instance_matches_plain(dev, name, b, s, t):
    """B2's latent decode instance (16 heads over one 576-value latent head,
    its first 512 values the value) against the plain recurrence, within
    2e-5 + 2e-5 * |plain| + 2^-15 max |value|, at 256 slots (KV axis split
    two ways), a small batch (split many ways), a verify step and a cache
    shorter than one tile; launched once per call."""
    gen = torch.Generator(device=dev).manual_seed(91 + b + s + t)
    st = ac.check_mla(dev, gen, name, b, s, t)
    assert st["max_err_over_tol"] <= 1.0 and st["keys"] >= b


def test_moonlight_mla_layer_on_b2_matches_ref_attention(dev):
    """One full-width MLA layer of Moonlight-16B-A3B (16 heads, latent 512
    + 64, bf16): a 300-token prefill on B2 (q and k zero-padded to D = 256)
    and three decode steps on the latent instance, against the "ref"
    backend's expanded prefill and batched absorbed decode, within 2 bf16
    ulps of the largest |output| (both compute in f32 and round once)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_config("moonlight-16b-a3b").kan_variant(),
                              num_layers=1)
    gen = torch.Generator(device=dev).manual_seed(5)
    p = L.init_mla(gen, cfg, device=dev)
    b, s, t = 2, 300, 512
    x = torch.randn(b, s + 3, cfg.d_model, generator=gen, device=dev) \
        .to(torch.bfloat16)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    outs = {}
    before = cuda.launch_counts()
    for backend in ("flash", "ref"):
        with runtime.use_attn_backend(backend):
            y, ckv = L.mla_attention(p, x[:, :s], cfg, pos)
            cache = {"ckv": torch.zeros(b, t, ckv.shape[-1], device=dev,
                                        dtype=ckv.dtype)}
            cache["ckv"][:, :s] = ckv
            ys = [y]
            for i in range(3):
                yi, cache = L.mla_attention_decode(
                    p, x[:, s + i:s + i + 1], cache,
                    torch.full((b,), s + i, device=dev), cfg)
                ys.append(yi)
        outs[backend] = torch.cat(ys, 1).float()
    after = cuda.launch_counts()
    assert after.get("flash_attention", 0) - before.get("flash_attention", 0) \
        == 1
    assert (after.get("flash_attention.mla", 0)
            - before.get("flash_attention.mla", 0)) == 3
    err = (outs["flash"] - outs["ref"]).abs().max().item()
    assert err <= 2 * ac.bf16_ulp(outs["ref"].abs().max()).item(), err


def test_decode_graph_replays_the_eager_decode_step(dev):
    """Moonlight's KAN variant at smoke width, served through the engine
    and its scheduler with and without ``cuda_graphs``: the same tokens,
    the same launch and MoE row counts (a replay counts as an eager step),
    and a graph cut at each range the step enters."""
    import dataclasses

    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.kan_ffn_deploy import MOE_COUNTS
    from repro_torch.models import model as M
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(smoke_config("moonlight-16b-a3b-kanffn"),
                              dtype="float32")
    p = M.init_params(torch.Generator().manual_seed(8), cfg, device="cpu")
    runs = {}
    for graphs in (False, True):
        eng = ServeEngine(p, cfg, slots=4, max_len=64, kan_deploy=True,
                          attn_backend="ref", device=dev,
                          cuda_graphs=graphs)
        reqs = [Request(rid=i, prompt=list(range(5, 12 + i)),
                        max_new_tokens=9, eos_id=-1) for i in range(6)]
        launches, rows = cuda.launch_counts(), dict(MOE_COUNTS)
        done = eng.run(reqs)
        after = cuda.launch_counts()
        runs[graphs] = (
            {r.rid: list(r.output) for r in done},
            {k: after[k] - launches.get(k, 0) for k in after},
            {k: v - rows.get(k, 0) for k, v in MOE_COUNTS.items()},
            eng.decode_calls)
        if graphs:
            names = [x for kind, x in eng._decode_graph.steps
                     if kind == "enter"]
            assert {"model.attention", "model.mla.attend", "model.ffn",
                    "model.moe.experts"} <= set(names)
    assert runs[True] == runs[False]


def test_b1_padded_columns_of_a_noisy_layer(dev):
    st = cc.check_b1_padded_columns(dev, torch.Generator(device=dev)
                                    .manual_seed(33))
    assert st["columns"] == 114


def test_launch_counters_move_once_per_call_of_two_kernels(dev):
    """A B2 decode call with split KV (split kernel + merge) and a B1
    5120 -> 1280 call with split features (split kernel + merge) each add
    one launch."""
    from repro_torch.kernels.attention import call_kv_splits, flash_attention
    from repro_torch.kernels.kan_spline import pipeline as pl

    q, k, v, qpos, kpos = ac.path_inputs(dev, "decode", 4, 1, 1024)
    assert call_kv_splits(q.shape, k.shape, q.dtype) > 1
    gen = torch.Generator(device=dev).manual_seed(34)
    lp, lw, _, codes, xraw, _ = cc.b1_case(
        dev, gen, 8, 5120, 1280, (True, False, False, False, True), 8)
    assert pl.feature_split_plan(lp.f, lp.o)[0] > 1
    before = cuda.launch_counts()
    flash_attention(q, k, v, qpos=qpos, kpos=kpos)
    pl.run_pipeline_layer(codes, xraw, lw, lp, 8)
    torch.cuda.synchronize()
    after = cuda.launch_counts()
    assert after.get("flash_attention", 0) == before.get("flash_attention", 0) + 1
    assert (after.get("kan_pipeline_layer", 0)
            == before.get("kan_pipeline_layer", 0) + 1)


@pytest.mark.parametrize("order", cc.ORDERS)
def test_b3_kernel_matches_plain(dev, order):
    gen = torch.Generator(device=dev).manual_seed(3 + order)
    for shape in cc.B3_SHAPES:
        cc.check_b3(dev, gen, *shape, order=order)


SLICE_CASES = [
    ((17, 1, 14), 5, 8, False), ((17, 1, 14), 68, 8, False),
    ((17, 1, 14), 5, (8, 4), False), ((64, 128, 64), 8, 8, True),
]


@pytest.mark.parametrize("dims,grid,bits,ffn", SLICE_CASES)
def test_slice_fused_matches_ref(dev, dims, grid, bits, ffn):
    kspec = KANSpec(dims=dims, grid_size=grid, n_bits=bits)
    gen = torch.Generator(device=dev).manual_seed(0)
    qparams = quantize_kan_network(init_kan_network(gen, kspec, device=dev), kspec)
    if ffn:
        dep = deploy_kan_ffn_stack(qparams, dims, kspec.layer_spec(), device=dev)
    else:
        dep = deploy_kan_network(qparams, kspec, device=dev)
    x = torch.rand(300, dims[0], generator=gen, device=dev) * 2 - 1
    before = cuda.launch_counts().get("kan_pipeline_layer", 0)
    y, codes = runtime.execute(dep, x, return_intermediates=True)
    assert cuda.launch_counts()["kan_pipeline_layer"] == before + len(dims) - 1
    ry, rcodes = runtime.execute(dep, x, backend="ref", return_intermediates=True)
    entry, xraw = _entry_codes(dep, x, None)
    pre = parity.boundary_prerounds(dep, entry, xraw, rcodes)
    parity.compare_runs(codes, rcodes, pre, y, ry)


def test_wrapper_raises_instead_of_falling_back(dev):
    spec = ASPQuantSpec(grid_size=5)
    codes = torch.zeros(4, 3, dtype=torch.int64, device=dev)
    lut = torch.zeros(32, 4, device=dev)
    with pytest.raises(ValueError, match="codes"):
        from repro_torch.kernels.kan_spline.kernel import kan_spline_cuda
        kan_spline_cuda(codes, lut, torch.zeros(3 * 8, 2, device=dev),
                        torch.zeros(3, 2, device=dev), spec)
    with pytest.raises(ValueError, match="orders 1..5"):
        kan_spline_cuda(codes.int(), torch.zeros(32, 7, device=dev),
                        torch.zeros(3 * 11, 2, device=dev),
                        torch.zeros(3, 2, device=dev),
                        ASPQuantSpec(grid_size=5, order=6))
    with pytest.raises(ValueError, match="SH-LUT"):
        big = ASPQuantSpec(grid_size=1, n_bits=14)
        kan_spline_cuda(codes.int(), torch.zeros(2**14, 4, device=dev),
                        torch.zeros(3 * 4, 2, device=dev),
                        torch.zeros(3, 2, device=dev), big)


@pytest.mark.parametrize("case", mc.CASES)
def test_b4_kernel_matches_plain_on_reference_cases(dev, case):
    mc.check_case(dev, torch.Generator(device=dev).manual_seed(21), *case)


@pytest.mark.parametrize("b,r,c,rows,adc", mc.PROPERTY_CASES)
def test_b4_kernel_matches_plain_on_ragged_shapes(dev, b, r, c, rows, adc):
    mc.check_case(dev, torch.Generator(device=dev).manual_seed(22), b, r, c,
                  rows, adc=adc, ir=0.03)


def test_b4_tiled_identity_and_zero_ir(dev):
    gen = torch.Generator(device=dev).manual_seed(23)
    mc.check_tiled(dev, gen)
    mc.check_zero_ir(dev, gen)


@pytest.mark.parametrize("name,b,r,c,rows,adc", mc.PATH_SHAPES)
def test_b4_kernel_matches_plain_at_path_shapes(dev, name, b, r, c, rows,
                                                adc):
    from repro_torch.core.cim import CIMConfig

    gen = torch.Generator(device=dev).manual_seed(24)
    ops = mc.path_operands(dev, gen, b, r, c, rows)
    mc.check_path(dev, ops, rows, CIMConfig(array_rows=rows, ir_gamma=0.06)
                  .ir_scale(), adc)
    del ops
    torch.cuda.empty_cache()


@pytest.mark.parametrize("name,b,r,c,rows,adc", mc.RAGGED_CASES)
def test_b4_kernel_matches_plain_on_ragged_stream_tiles(dev, name, b, r, c,
                                                        rows, adc):
    from repro_torch.core.cim import CIMConfig
    from repro_torch.kernels.cim_mac.kernel import mac_plan

    plan = mac_plan(r, c, rows)
    assert plan.tile_rows > 0 and b % plan.tile_rows != 0
    gen = torch.Generator(device=dev).manual_seed(25)
    ops = mc.path_operands(dev, gen, b, r, c, rows)
    mc.check_path(dev, ops, rows, CIMConfig(array_rows=rows, ir_gamma=0.06)
                  .ir_scale(), adc)
    del ops
    torch.cuda.empty_cache()


@pytest.mark.parametrize("name,b,r,c,rows,adc", mc.ROW_CASES)
def test_b4_rows_bit_identical_at_32_rows_and_full_batch(dev, name, b, r, c,
                                                         rows, adc):
    mc.check_rows(dev, torch.Generator(device=dev).manual_seed(26), b, r, c,
                  rows, adc)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("b,r,c,rows,adc", mc.SPLIT_CASES)
def test_b4_wide_path_adds_r_chunks_in_order(dev, b, r, c, rows, adc):
    from repro_torch.kernels.cim_mac.kernel import mac_plan

    plan = mac_plan(r, c, rows)
    assert plan.tile_rows == 0 and plan.chunks > 1
    mc.check_case(dev, torch.Generator(device=dev).manual_seed(27), b, r, c,
                  rows, adc=adc)


def test_b4_wrapper_raises_instead_of_falling_back(dev):
    from repro_torch.kernels.cim_mac import cim_mac_arrays

    x = torch.zeros(4, 200, device=dev)
    w = torch.zeros(200, 3, device=dev)
    load = torch.zeros(2, 3, device=dev)
    kw = dict(array_rows=128, ir_scale=0.0, adc_bits=8)
    with pytest.raises(ValueError, match="w"):
        cim_mac_arrays(x, w.cpu(), load, load, **kw)
    with pytest.raises(ValueError, match="x"):
        cim_mac_arrays(x.double(), w, load, load, **kw)


@pytest.mark.parametrize("grid,bits", [(5, 8), (68, 8), (5, (8, 4))])
def test_acim_quiet_is_fused_and_noise_reproduces(dev, grid, bits):
    from repro_torch.core.cim import CIMConfig

    kspec = KANSpec(dims=(17, 1, 14), grid_size=grid, n_bits=bits)
    gen = torch.Generator(device=dev).manual_seed(0)
    qparams = quantize_kan_network(init_kan_network(gen, kspec, device=dev),
                                   kspec)
    dep = deploy_kan_network(qparams, kspec, device=dev)
    x = torch.rand(300, 17, generator=gen, device=dev) * 2 - 1
    y_f, c_f = runtime.execute(dep, x, backend="fused",
                               return_intermediates=True)
    y_q, c_q = runtime.execute(dep, x, backend="acim",
                               cim=runtime.quiet_cim_config(),
                               return_intermediates=True)
    assert torch.equal(y_q, y_f)
    assert all(torch.equal(a, b) for a, b in zip(c_q, c_f))

    def noisy(seed):
        g = None if seed is None else \
            torch.Generator(device=dev).manual_seed(seed)
        return runtime.execute(dep, x, backend="acim", generator=g)

    before = cuda.launch_counts().get("kan_pipeline_layer.noise", 0)
    assert torch.equal(noisy(0), noisy(0))
    assert not torch.equal(noisy(0), noisy(1))
    assert torch.equal(noisy(None), noisy(None))
    assert cuda.launch_counts()["kan_pipeline_layer.noise"] == before + 12
    y_ir = runtime.execute(dep, x, backend="acim",
                           cim=CIMConfig(ir_gamma=0.06, deterministic=True))
    assert (y_ir - y_f).abs().max() > 0


# ----------------------------------------------------------------------------
# the co-design slice: B1's row tile, the tuned plan, the search
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("rows", cc.ROW_TILE_ROWS)
@pytest.mark.parametrize("name,grid,f,o,flags", cc.B1_ROW_TILE_CASES)
def test_b1_row_tiles_bit_identical(dev, name, grid, f, o, flags, rows):
    """B1 at 16 and 32 rows per block gives the bits of 64: KAN1, KAN2,
    the packed mixed-precision layer and a full-width FFN half."""
    gen = torch.Generator(device=dev).manual_seed(rows + f + grid)
    assert cc.check_b1_row_tiles(dev, gen, grid, f, o, flags, rows)["equal"]


def test_tuned_plan_changes_the_row_tile_and_no_output_bit(dev):
    from repro_torch.runtime import bucket_batch

    kspec = KANSpec(dims=(17, 1, 14), grid_size=5)
    gen = torch.Generator(device=dev).manual_seed(5)
    qparams = quantize_kan_network(init_kan_network(gen, kspec, device=dev),
                                   kspec)
    dep = deploy_kan_network(qparams, kspec, device=dev)
    x = torch.rand(1000, 17, generator=gen, device=dev) * 2 - 1
    geom = (tuple(dep.dims), tuple(dep.specs), dep.residual_raw)
    y0, c0 = runtime.execute(dep, x, backend="fused",
                             return_intermediates=True)
    assert runtime.PLAN_CACHE.plan(bucket_batch(1000),
                                   *geom[:2]).row_tile == 64
    try:
        runtime.PLAN_CACHE.set_tile_overrides(*geom, (16, 128, 32))
        assert runtime.PLAN_CACHE.plan(bucket_batch(1000),
                                       *geom[:2]).row_tile == 16
        before = cuda.launch_counts().get("kan_pipeline_layer", 0)
        y1, c1 = runtime.execute(dep, x, backend="fused",
                                 return_intermediates=True)
        assert cuda.launch_counts()["kan_pipeline_layer"] == before + 2
    finally:
        runtime.PLAN_CACHE.set_tile_overrides(*geom, None)
    assert torch.equal(y1, y0) and all(torch.equal(a, b)
                                       for a, b in zip(c1, c0))


def test_training_and_search_are_deterministic_on_the_card(dev):
    from repro_torch import tune

    kw = dict(n_train=2048, n_val=256, epochs=10, calib_n=64, device=dev)
    t1, t2 = tune.make_knot_task(**kw), tune.make_knot_task(**kw)
    for a, b in zip(t1.base_params, t2.base_params):
        assert all(torch.equal(a[k], b[k]) for k in a)
    cfg = tune.SearchConfig(budget=6, n_init=4, seed=0, acim_seeds=2)
    before = cuda.launch_counts().get("kan_pipeline_layer.noise", 0)
    r1 = tune.pareto_search(t1, tune.DesignSpace(), config=cfg)
    assert cuda.launch_counts()["kan_pipeline_layer.noise"] > before
    r2 = tune.pareto_search(t1, tune.DesignSpace(), config=cfg)
    assert r1.to_dict() == r2.to_dict()
    assert [p.candidate for p in r1.evaluated] == \
        [p.candidate for p in r2.evaluated]


def test_measured_tile_tuning_times_each_launch_once(dev):
    from repro_torch import tune

    task = tune.make_knot_task(n_train=1024, n_val=1024, epochs=2,
                               calib_n=64, device=dev)
    _, _, dep = tune.deploy_candidate(task, tune.Candidate(grid_size=5))
    res = tune.tune_tiles(dep, max_candidates=16, repeats=3, register=False)
    assert res.mode == "measured" and res.bucket == 1024
    kept = [t for t in res.trials if t.valid]
    assert kept and all(t.exact for t in kept)
    timed = [t for t in kept if not t.reason]
    assert sorted(t.row_tile for t in timed) == \
        sorted({t.row_tile for t in kept})
    for t in kept:
        if t.reason:
            assert t.reason.startswith("same launch as ")
            assert t.score == next(u.score for u in timed
                                   if u.row_tile == t.row_tile)


# ----------------------------------------------------------------------------
# LM training (train.cardcheck: the checks chip_smoke.py runs)
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("f,o", [(5120, 1280), (1280, 5120)])
def test_spline_mm_backward_at_the_full_width_halves(dev, f, o):
    from repro_torch.train import cardcheck as tc

    r = tc.check_spline_mm(dev, f, o, tokens=64)
    assert r["dx_max_abs_err"] <= r["dx_tol"]
    assert r["dc_max_abs_err"] <= r["dc_tol"]


def test_train_steps_on_the_card_match_the_cpu(dev):
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.train import cardcheck as tc

    cfg = dataclasses.replace(smoke_config("qwen2.5-14b").kan_variant(),
                              microbatch=2, remat=True)
    before = (dict(cuda.launch_counts()),
              runtime.attn_dispatch_counts().get("flash", 0))
    r = tc.check_card_vs_cpu(dev, cfg)
    assert r["param_max_abs_err"] <= tc.CARD_CPU_TOL
    # the step never reaches B1 or B2
    assert (dict(cuda.launch_counts()),
            runtime.attn_dispatch_counts().get("flash", 0)) == before


def test_inplace_optimizer_is_bit_equal_on_the_card(dev):
    from repro_torch.train import cardcheck as tc

    assert all(n > 0 for n in tc.check_inplace_optimizer(dev).values())


def test_bf16_training_restarts_bit_equal_on_the_card(dev):
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.train import cardcheck as tc

    cfg = dataclasses.replace(smoke_config("qwen2.5-14b").kan_variant(),
                              dtype="bfloat16")
    r = tc.check_restart(dev, cfg)
    assert r["restarted"] == r["losses"][3:]


# ----------------------------------------------------------------------------
# mesh serving (A10a): a 1x1 mesh over a world-1 NCCL group
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dims,grid,bits,ffn", SLICE_CASES)
def test_mesh_1x1_runtime_is_unsharded_bit_for_bit(dev, dims, grid, bits, ffn):
    """The meshed runtime (``mesh=`` and a placed bundle) on a 1x1 NCCL
    mesh gives the unsharded call's outputs and boundary codes bit for bit,
    with the same B1 launches per call."""
    from repro_torch.core.kan_network_deploy import place_deployed_kan
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(1, 1)
    assert mesh.device_type == "cuda"
    kspec = KANSpec(dims=dims, grid_size=grid, n_bits=bits)
    gen = torch.Generator(device=dev).manual_seed(0)
    qparams = quantize_kan_network(init_kan_network(gen, kspec, device=dev),
                                   kspec)
    dep = (deploy_kan_ffn_stack(qparams, dims, kspec.layer_spec(), device=dev)
           if ffn else deploy_kan_network(qparams, kspec, device=dev))
    placed = place_deployed_kan(dep, mesh)
    for rows in (1, 300, 4096):
        x = torch.rand(rows, dims[0], generator=gen, device=dev) * 2 - 1
        launches = []
        outs = []
        for kw in ({"dep": dep}, {"dep": dep, "mesh": mesh},
                   {"dep": placed}):
            before = cuda.launch_counts().get("kan_pipeline_layer", 0)
            outs.append(runtime.execute(kw.pop("dep"), x,
                                        return_intermediates=True, **kw))
            launches.append(cuda.launch_counts()["kan_pipeline_layer"]
                            - before)
        assert launches == [len(dims) - 1] * 3
        for y, codes in outs[1:]:
            assert torch.equal(y, outs[0][0])
            assert all(torch.equal(a, b) for a, b in zip(codes, outs[0][1]))


def test_int8_codec_on_the_card_is_numpy_bit_for_bit(dev):
    """``dist.compress._quantize`` on CUDA tensors: the per-tensor scale and
    every code equal a numpy reckoning (IEEE division on the card, not a
    reciprocal multiply)."""
    import numpy as np

    from repro_torch.dist.compress import _quantize

    gen = torch.Generator(device=dev).manual_seed(3)
    for shape, scale in (((4097, 33), 3.7), ((1000,), 1e-3), ((64, 64), 1.0)):
        g = torch.randn(shape, generator=gen, device=dev) * scale
        q, s = _quantize(g)
        a = g.cpu().numpy()
        s_np = np.float32(np.abs(a).max()) / np.float32(127)
        q_np = np.clip(np.round(a / s_np), -127, 127).astype(np.int8)
        assert np.float32(s.item()) == s_np
        np.testing.assert_array_equal(q.cpu().numpy(), q_np)


@pytest.mark.parametrize("grid,f,o,flags,rows,model",
                         cc.B1_COLUMN_SLAB_CASES)
def test_b1_column_slabs_are_the_whole_layer_bit_for_bit(
        dev, grid, f, o, flags, rows, model):
    """What a model-sharded run launches, on one card: every column slab
    of a full-width gemma2 KAN-FFN half, at the whole layer's feature
    split, equals those columns of the whole launch; the slab's own plan
    would have split the contraction otherwise."""
    gen = torch.Generator(device=dev).manual_seed(5)
    r = cc.check_b1_column_slabs(dev, gen, grid, f, o, flags, rows, model)
    assert r["equal"] and r["local_plan_splits"] != r["splits"]


def test_mesh_collectives_on_the_world1_nccl_groups(dev):
    """all_gather_into_tensor, all_reduce and broadcast of int32 codes and
    f32 rows on both groups of a 1x1 NCCL mesh, called directly (the
    serving path skips a group of one rank)."""
    from repro_torch.dist.cardcheck import check_collectives
    from repro_torch.launch.mesh import make_local_mesh

    r = check_collectives(make_local_mesh(1, 1), dev)
    assert r == {"groups": {"data": 1, "model": 1}, "calls": 12}


# ----------------------------------------------------------------------------
# meshed training (A10b): a 1x1 mesh over a world-1 NCCL group
# ----------------------------------------------------------------------------


def test_mesh_1x1_train_loop_is_unsharded_bit_for_bit(dev, tmp_path):
    """``TrainLoop(shardings=)`` on a 1x1 NCCL mesh trains the smoke
    KAN-FFN decoder (f32, remat, two microbatches) as the unsharded loop
    does, bit for bit: losses, grad norms and every state tensor; and a
    restart from its step-2 checkpoint continues bit-equal."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data.lm_data import DataConfig
    from repro_torch.dist.sharding import PSpec, to_shardings
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.train_state import meta_state, state_pspecs

    mesh = make_local_mesh(1, 1)
    cfg = dataclasses.replace(smoke_config("qwen2.5-14b").kan_variant(),
                              remat=True, microbatch=2)
    d = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    rows = PSpec("data", None)
    sh = {"state": to_shardings(state_pspecs(meta_state(cfg), mesh), mesh),
          "batch": to_shardings({"tokens": rows, "targets": rows}, mesh)}
    quiet = lambda *_: None  # noqa: E731
    plain = TrainLoop(cfg, d, str(tmp_path / "a"), ckpt_every=100)
    meshed = TrainLoop(cfg, d, str(tmp_path / "b"), ckpt_every=2,
                       shardings=sh)
    want, got = plain.run(4, log=quiet), meshed.run(4, log=quiet)
    nums = lambda h: [(m["loss"], m["grad_norm"]) for m in h]  # noqa: E731
    assert nums(got) == nums(want)
    for a, b in zip(flatten(meshed.state), flatten(plain.state)):
        assert torch.equal(a, b)
    import shutil

    shutil.rmtree(tmp_path / "b" / "step_4")
    again = TrainLoop(cfg, d, str(tmp_path / "b"), ckpt_every=100,
                      shardings=sh)
    assert again.start_step == 2
    assert nums(again.run(2, log=quiet)) == nums(want)[2:]


@pytest.mark.parametrize("tokens", [64, 1024])
def test_moe_slabs_at_model_2_on_the_card(dev, tokens):
    """A full-width mixtral MoE layer as two ranks' expert hidden-column
    slabs, the partial expert outputs added by hand: within 4 bf16 ulps
    of the whole layer's output."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.cardcheck import check_moe_slabs

    r = check_moe_slabs(dev, get_config("mixtral-8x7b"), tokens)
    assert r["max_abs_err"] <= r["tol"]


@pytest.mark.parametrize("d,h", [(5120, 1280), (1280, 640)])
def test_kan_ffn_slabs_at_model_2_on_the_card(dev, d, h):
    """The float KAN-FFN (f32) as two ranks' hidden slabs, forward and
    backward: outputs and input gradient summed, and each slab's
    c1 / wb1 / c2 / wb2 gradient, within 1e-5 x max of the whole block's."""
    from repro_torch.dist.cardcheck import check_kan_ffn_slabs

    r = check_kan_ffn_slabs(dev, d, h, 64)
    assert all(e <= r["tol"] for e in r["rel_err"].values())


def test_remat_keeps_the_forwards_layout_on_the_card(dev):
    """On the card remat's recompute runs on the autograd engine's device
    thread, outside the caller's ``use_tp`` scope: the smoke qwen's slabs
    at model 2 and 4 (KV heads cut, then whole) train bit-equal with remat
    on and off over the world-1 NCCL "model" group."""
    from repro_torch.dist.cardcheck import check_remat_under_layout
    from repro_torch.launch.mesh import make_local_mesh

    r = check_remat_under_layout(make_local_mesh(1, 1), dev)
    assert [kv for *_, kv in r["layouts"]] == [True] * 2 + [False] * 4


def test_autograd_collectives_on_the_world1_nccl_groups(dev):
    from repro_torch.dist.cardcheck import check_autograd_collectives
    from repro_torch.launch.mesh import make_local_mesh

    r = check_autograd_collectives(make_local_mesh(1, 1), dev)
    assert r == {"groups": {"data": 1, "model": 1}}


def test_quickstart_example_on_the_card(dev):
    from repro_torch.examples import quickstart

    cuda.reset_launch_counts()
    out = quickstart.run(device=dev, log=lambda *a: None)
    assert cuda.launch_counts() == {"kan_spline": 2, "kan_pipeline_layer": 2}
    gate = quickstart.parity_gate(out)
    assert gate["kernel"]["rows"] == gate["fused"]["rows"] == 8
    spec = out["spec"]
    assert out["sh_lut"]["stored"] == (spec.order + 1) * 2**spec.ld // 2 + 1


def test_serve_demo_example_on_the_card(dev):
    from repro_torch.examples import serve_demo

    cuda.reset_launch_counts()
    out = serve_demo.run(train_steps=3, device=dev, log=lambda *a: None)
    assert _by_kernel(cuda.launch_counts()) == serve_demo.expected_launches(out)
    assert out["stream_outputs"] == out["streams"]
    assert sorted(out["fused"]) == list(range(6))
