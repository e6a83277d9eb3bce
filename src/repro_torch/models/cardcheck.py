"""One full-width MoE layer held against the port's CPU path.

The one definition of the check, shared by ``chip_smoke.py`` (phase 10)
and ``tests/test_torch_gpu.py``.  A layer's weights are drawn on the card
from a seeded generator, copied to the CPU, and both copies run
:func:`.layers.moe` on the same bf16 tokens.  The f32 router matmul sums
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
"""

from __future__ import annotations

import math

import torch

from .layers import init_moe, moe, moe_capacity, moe_route

__all__ = ["TIE_REL", "BF16_ULPS", "check_moe_layer"]

TIE_REL = 1e-4
BF16_ULPS = 4


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
