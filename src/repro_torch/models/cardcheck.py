"""One full-width MoE, RG-LRU, Mamba-2, encoder or cross-attention decoder
layer held against the port's CPU path.

The one definition of each check, shared by ``chip_smoke.py`` (phases 10,
11 and 12) and ``tests/test_torch_gpu.py``.  :func:`check_moe_layer`: a
layer's weights are drawn on the card from a seeded generator, copied to
the CPU, and both copies run :func:`.layers.moe` on the same bf16 tokens.  The f32 router matmul sums
in another order on the two devices, so:

  * routing (each token's set of k experts, and whether each assignment
    was kept) must be equal, except at a near-tie: a token whose chosen experts
    differ must have its k-th and (k+1)-th CPU router logits within
    ``TIE_REL`` (relative) of each other; such tokens are excused and
    counted, and so are the tokens whose kept flags moved only because an
    excused token took or freed a slot in their expert (their experts are
    equal, their ranks are not);
  * every token whose routing did not change has its output within
    ``BF16_ULPS`` bf16 ulps of max|out| of the CPU output (bf16 expert
    matmuls that sum in another order, one rounding each; a token whose
    experts came in another order sums its k outputs in that order).

:func:`check_recurrent_layer` runs one RG-LRU or Mamba-2 layer the same
way over a prefill and a few decode steps.  Its bf16 projections sum in
another order on cuBLAS, so a projected element may round to the
neighbouring bf16 value:

  * every output (prefill and each decode step) within ``BF16_ULPS``
    bf16 ulps of max|out| of the CPU output;
  * the conv states (copies of bf16 projections) within one bf16 ulp of
    their max|conv|; the elements that differ are counted (a projection
    that cancels to a small value may round many of its own ulps away,
    since its f32 sum carries the error of its large terms);
  * the f32 states (``h``, ``ssm``) within ``STATE_ULPS`` bf16 ulps of
    their max|state|: an input that moved by one bf16 ulp moves the
    recurrence by up to that much of itself.

:func:`check_encdec_layers` runs one encoder layer ("bidir" attention over
the stub frames) and one decoder layer with its cross-attention sublayer
(a prefill that writes the cross K/V, then decode steps that read it) on
"flash" attention (kernel B2 on the card, its plain version on the CPU).
The decoder gets the card's encoder output on both devices, so each layer
is held alone:

  * every output within ``BF16_ULPS`` bf16 ulps of max|out|;
  * the cross K/V (one bf16 projection of the encoder output each) within
    one bf16 ulp of max|kv|;
  * the decode steps leave the cross K/V as the prefill wrote them, bit
    for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.attention.cardcheck import bf16_ulp
from ..runtime.attention import use_attn_backend
from ..train.optimizer import tree_map
from . import layers as L
from .layers import init_moe, moe, moe_capacity, moe_route
from .transformer import (
    init_stack,
    init_stack_cache,
    stack_decode,
    stack_forward,
    stack_prefill,
)

__all__ = ["TIE_REL", "BF16_ULPS", "STATE_ULPS", "check_moe_layer",
           "check_recurrent_layer", "check_encdec_layers"]

TIE_REL = 1e-4
BF16_ULPS = 4
STATE_ULPS = 2


def _route(p, x, cfg):
    """Each token's k experts (ascending: the same experts in another
    order route alike) and kept flags in that order, both (T, k)."""
    k = cfg.num_experts_per_tok
    flat_e, _, pos, cap = moe_route(p, x.reshape(-1, x.shape[-1]), cfg)
    experts, order = flat_e.reshape(-1, k).sort(dim=-1)
    return experts, (pos < cap).reshape(-1, k).gather(1, order)


def check_moe_layer(dev, cfg, tokens: int, seed: int = 0) -> dict:
    """One MoE layer of ``cfg`` (its published widths) over ``tokens``
    tokens, card against CPU; raises on disagreement.  Returns
    ``{"tokens", "cap", "dropped", "flipped", "displaced", "max_abs_err",
    "tol"}``: assignments dropped (card), tokens excused at a near-tie,
    tokens whose kept flags moved behind them, the largest output error
    over the other tokens and its tolerance."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = init_moe(gen, cfg, device=dev)
    x = torch.randn(1, tokens, cfg.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    pc = {k: v.cpu() for k, v in p.items()}
    xc = x.cpu()
    with torch.no_grad():
        out = moe(p, x, cfg).float().cpu()[0]
        want = moe(pc, xc, cfg).float()[0]
        e_dev, keep_dev = (t.cpu() for t in _route(p, x, cfg))
        e_cpu, keep_cpu = _route(pc, xc, cfg)
        logits = xc.reshape(tokens, -1).to(torch.float32) @ pc["router"]
    k = cfg.num_experts_per_tok
    srt = torch.sort(logits, dim=-1, descending=True).values
    gap = (srt[:, k - 1] - srt[:, k]).abs()
    near = gap <= TIE_REL * srt[:, k - 1].abs().clamp_min(1e-30)
    flipped = (e_dev != e_cpu).any(dim=-1)
    if bool((flipped & ~near).any()):
        bad = int((flipped & ~near).nonzero()[0, 0])
        raise AssertionError(
            f"MoE {cfg.name} at {tokens} tokens: token {bad} routed to "
            f"{e_dev[bad].tolist()} on the card, {e_cpu[bad].tolist()} on "
            f"the CPU, router gap {gap[bad].item():.3e}")
    displaced = ~flipped & (keep_dev != keep_cpu).any(dim=-1)
    if bool(displaced.any()) and not bool(flipped.any()):
        raise AssertionError(f"MoE {cfg.name} at {tokens} tokens: kept flags "
                             "differ with no routing flip")
    same = ~(flipped | displaced)
    top = want.abs().max().item()
    tol = BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    err = (out[same] - want[same]).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"MoE {cfg.name} at {tokens} tokens: max err "
                             f"{err:.4e} > {tol:.4e} ({BF16_ULPS} bf16 ulps "
                             f"of max|out| {top:.4f})")
    return {"tokens": tokens, "cap": moe_capacity(tokens, cfg),
            "dropped": int((~keep_dev).sum()), "flipped": int(flipped.sum()),
            "displaced": int(displaced.sum()), "max_abs_err": err,
            "tol": tol}


def check_recurrent_layer(dev, cfg, kind: str, tokens: int = 1000,
                          steps: int = 4, seed: int = 0) -> dict:
    """One ``kind`` ("rglru" or "ssm") layer of ``cfg`` (bf16, its
    published widths) on ``dev`` against a CPU copy of its weights: a
    ``tokens``-token prefill, then ``steps`` decode steps from the prefill's
    state, on the same bf16 inputs; raises on disagreement (module
    docstring).  Returns ``{"tokens", "steps", "out_ulps", "conv_diff",
    "conv_ulps", "state_ulps"}``: the largest output error in bf16 ulps of
    max|out| over every call, the most conv-state elements that differ in
    one call and the largest conv-state error in bf16 ulps of
    max|conv|, and the largest f32-state error in bf16 ulps of
    max|state|."""
    init, fn = ((L.init_rglru, L.rglru) if kind == "rglru" else
                (L.init_mamba2, L.mamba2))
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = init(gen, cfg, device=dev)
    x = torch.randn(1, tokens + steps, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    pc = {k: v.cpu() for k, v in p.items()}
    xc = x.cpu()
    st = {"tokens": tokens, "steps": steps, "out_ulps": 0.0, "conv_diff": 0,
          "conv_ulps": 0.0, "state_ulps": 0.0}
    state = state_c = None
    with torch.no_grad():
        for i in range(steps + 1):
            sl = (slice(0, tokens) if i == 0 else
                  slice(tokens + i - 1, tokens + i))
            out, state = fn(p, x[:, sl], cfg, state)
            want, state_c = fn(pc, xc[:, sl], cfg, state_c)
            want = want.float()
            st["out_ulps"] = max(st["out_ulps"], (
                (out.cpu().float() - want).abs().max()
                / bf16_ulp(want.abs().max())).item())
            for name, got in state.items():
                got, ref = got.cpu().float(), state_c[name].float()
                key = "conv_ulps" if name == "conv" else "state_ulps"
                st[key] = max(st[key], ((got - ref).abs().max()
                                        / bf16_ulp(ref.abs().max())).item())
                if name == "conv":
                    st["conv_diff"] = max(st["conv_diff"],
                                          int((got != ref).sum()))
    if not (st["out_ulps"] <= BF16_ULPS and st["conv_ulps"] <= 1.0
            and st["state_ulps"] <= STATE_ULPS):
        raise AssertionError(f"{kind} layer of {cfg.name}, card vs CPU "
                             f"(out <= {BF16_ULPS} ulps, conv <= 1, states "
                             f"<= {STATE_ULPS}): {st}")
    return st


def _ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of max|want| (both moved to the CPU)."""
    want = want.float().cpu()
    return ((got.float().cpu() - want).abs().max()
            / bf16_ulp(want.abs().max())).item()


def check_encdec_layers(dev, cfg, batch: int = 4, prompt: int = 4,
                        steps: int = 4, seed: int = 0) -> dict:
    """One encoder layer and one cross-attention decoder layer of ``cfg``
    (an encoder-decoder config: bf16, its published widths; the encoder
    over ``cfg.enc_seq`` frames) on ``dev`` against CPU copies of their
    weights: the encoder over ``batch`` clips of frames, then the decoder
    layer's ``prompt``-token prefill and ``steps`` decode steps on the same
    bf16 inputs; raises on disagreement (module docstring).  Returns
    ``{"frames", "batch", "prompt", "steps", "enc_ulps", "dec_ulps",
    "xkv_ulps", "xkv_unchanged"}``: the encoder's output error and the
    largest decoder output error (prefill and each step) in bf16 ulps of
    max|out|, the cross K/V error in bf16 ulps of max|kv|, and whether the
    decode steps left the card's cross K/V bit-equal."""
    enc_cfg = dataclasses.replace(cfg, num_layers=1, attn_pattern=("bidir",),
                                  num_experts=0)
    dec_cfg = dataclasses.replace(cfg, num_layers=1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    enc_p = init_stack(gen, enc_cfg, device=dev)
    dec_p = init_stack(gen, dec_cfg, cross=True, device=dev)
    frames = torch.randn(batch, cfg.enc_seq, cfg.d_model, generator=gen,
                         device=dev).to(torch.bfloat16)
    x = torch.randn(batch, prompt + steps, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)

    def cpu(tree):
        return tree_map(lambda t: t.cpu(), tree)

    st = {"frames": cfg.enc_seq, "batch": batch, "prompt": prompt,
          "steps": steps}
    with torch.no_grad(), use_attn_backend("flash"):
        enc = stack_forward(enc_p, frames, enc_cfg)
        st["enc_ulps"] = _ulps(enc, stack_forward(cpu(enc_p), frames.cpu(),
                                                  enc_cfg))
        runs = {}
        for name, p, e, xs, d in (("card", dec_p, enc, x, dev),
                                  ("cpu", cpu(dec_p), enc.cpu(), x.cpu(),
                                   torch.device("cpu"))):
            cache = init_stack_cache(dec_cfg, batch, prompt + steps,
                                     enc_len=cfg.enc_seq, device=d)
            pos = torch.arange(prompt, device=d)[None].expand(batch, prompt)
            h, _ = stack_prefill(p, cache, xs[:, :prompt], dec_cfg,
                                 positions=pos, enc_out=e)
            xkv = {n: t.clone() for n, t in cache[0]["l0_xkv"].items()}
            outs = [h]
            for i in range(prompt, prompt + steps):
                step = torch.full((batch,), i, device=d)
                h, _ = stack_decode(p, cache, xs[:, i:i + 1], step, dec_cfg)
                outs.append(h)
            runs[name] = (outs, xkv, cache[0]["l0_xkv"])
    (outs, xkv, after), (outs_c, xkv_c, _) = runs["card"], runs["cpu"]
    st["dec_ulps"] = max(_ulps(o, w) for o, w in zip(outs, outs_c))
    st["xkv_ulps"] = max(_ulps(xkv[n][0], xkv_c[n][0]) for n in ("k", "v"))
    st["xkv_unchanged"] = all(torch.equal(xkv[n], after[n])
                              for n in ("k", "v"))
    if not (st["enc_ulps"] <= BF16_ULPS and st["dec_ulps"] <= BF16_ULPS
            and st["xkv_ulps"] <= 1.0 and st["xkv_unchanged"]):
        raise AssertionError(f"encoder / cross-attention decoder layers of "
                             f"{cfg.name}, card vs CPU (outputs <= "
                             f"{BF16_ULPS} ulps, cross K/V <= 1, cross K/V "
                             f"unchanged by decode): {st}")
    return st
