"""Serve a small KAN-FFN LM with batched requests (continuous batching).

The paper's kind is edge INFERENCE, so the end-to-end path is serving: a
smoke-scale qwen2.5 backbone with the paper's KAN-FFN layers, briefly
trained, then served through the slot-based engine with a batch of prompts
— float path vs the fused quantized pipeline, then once more through the
async scheduler with staggered arrivals, per-token streaming and seeded
sampling (docs/serving.md).

Port of ``examples/serve_demo.py``; on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]

Every prefill and decode call runs attention through kernel B2; the
deployed engines run both halves of every KAN-FFN through kernel B1.  The
training steps attend on the "ref" backend (B2 has no backward).  Float
and fused streams may part where two logits nearly tie: the count of
requests that decode the same tokens on both is printed, not asserted.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import runtime
from ..configs.registry import smoke_config
from ..data.lm_data import DataConfig, global_batch_at_step
from ..device import resolve_device
from ..models.model import init_params, loss_fn
from ..serve.engine import Request, ServeEngine
from ..serve.scheduler import SamplingParams, Scheduler
from ..train.loop import batch_to_device
from ..train.optimizer import (
    adamw,
    apply_updates,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from . import device_label, sync

__all__ = ["example_config", "train", "run", "expected_launches", "main"]


def example_config():
    """The smoke-scale qwen2.5 backbone with the paper's KAN-FFN (grid 8),
    2 layers deep."""
    return dataclasses.replace(
        smoke_config("qwen2.5-14b").kan_variant(grid=8), num_layers=2)


def train(params, cfg, steps: int):
    """``steps`` functional AdamW steps (lr 3e-3) on 8 x 32 tokens a step
    of the seekable ``lm_data`` stream; returns the trained parameters and
    the per-step losses."""
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    opt = adamw(3e-3)
    opt_state = opt.init(params)
    dev = tree_leaves(params)[0].device
    losses = []
    for s in range(steps):
        batch = batch_to_device(global_batch_at_step(dcfg, s), dev)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with runtime.use_attn_backend("ref"):
            loss = loss_fn(tree_unflatten(params, leaves), batch, cfg)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        losses.append(float(loss.detach()))
    return params, losses


def _prompts(gen: torch.Generator, n: int, length: int, vocab: int) -> list:
    return [torch.randint(3, vocab, (length,), generator=gen).tolist()
            for _ in range(n)]


def _served(results) -> dict:
    return {r.rid: list(r.output) for r in results}


def run(*, train_steps: int = 30, n_requests: int = 6, max_new: int = 12,
        stream_requests: int = 4, stream_max_new: int = 10, lm_params=None,
        device=None, log=print) -> dict:
    """Train, serve float and fused (prompts of 8 tokens through 3 slots
    of 64), then stream sampled tokens (prompts of 6).

    ``lm_params`` replaces the parameters drawn from seed 0 (training then
    starts from them; ``train_steps=0`` serves them as they are).  The
    prompts are drawn from seeds 1 and 2 on the host.  Returns the
    ``cfg``, the served ``params``, the training ``losses``, the
    ``prompts``, the greedy outputs by request id (``float``, ``fused``),
    ``same`` (requests whose float and fused tokens agree), the
    ``streams`` and the scheduler run's final outputs (``stream_outputs``),
    the scheduler's ``stats``, each engine's ``compile_stats`` under
    ``engines`` (``float``, ``fused``, ``stream``), and ``seconds`` and
    ``tokens`` of each run.
    """
    dev = resolve_device(device)
    cfg = example_config()
    where = device_label(dev)
    log(f"model: {cfg.name} ({cfg.num_layers}L d={cfg.d_model} "
        f"ffn={cfg.ffn_kind} G={cfg.kan_grid}) on {where}")
    if lm_params is None:
        lm_params = init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    params = tree_map(lambda t: t.to(dev), lm_params)
    seconds, tokens = {}, {}

    # brief training so generations aren't pure noise
    log(f"training {train_steps} steps ...")
    sync(dev)
    t0 = time.perf_counter()
    params, losses = train(params, cfg, train_steps)
    sync(dev)
    seconds["train"] = time.perf_counter() - t0
    if losses:
        log(f"final loss {losses[-1]:.3f}")

    # batched serving: n_requests requests through the slots
    prompts = _prompts(torch.Generator().manual_seed(1), n_requests, 8,
                       cfg.vocab_size)
    engines = {}

    def serve(name: str, **kw) -> dict:
        eng = ServeEngine(params, cfg, slots=3, max_len=64, device=dev,
                          **kw)
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        sync(dev)
        t0 = time.perf_counter()
        out = _served(eng.run(reqs, log=log if name == "float" else None))
        sync(dev)
        seconds[name] = time.perf_counter() - t0
        tokens[name] = sum(len(v) for v in out.values())
        engines[name] = eng.compile_stats()
        return out

    out_float = serve("float")
    log(f"\nserved {len(out_float)} requests, {tokens['float']} tokens in "
        f"{seconds['float']:.2f}s ({tokens['float'] / seconds['float']:.1f} "
        f"tok/s on {where})")
    for rid in sorted(out_float):
        log(f"  req {rid}: {out_float[rid]}")

    # same batch on the paper's deployed datapath: FFN blocks ASP-quantized
    # at startup, every step through the fused pipeline (kernel B1)
    log("\nre-serving on the fused quantized pipeline (kan_deploy=True) ...")
    out_fused = serve("fused", kan_deploy=True)
    same = sum(out_fused[rid] == out_float[rid] for rid in out_float)
    log(f"quantized path: {tokens['fused']} tokens in {seconds['fused']:.2f}s; "
        f"{same}/{len(out_fused)} requests decode identical tokens")

    # async streaming serving: the same engine internals driven by the
    # event-driven scheduler — staggered arrivals, per-token callbacks,
    # seeded top-k sampling, TTFT/throughput metrics at shutdown
    log("\nstreaming sampled serving through the scheduler ...")
    seng = ServeEngine(params, cfg, slots=3, max_len=64, kan_deploy=True,
                       device=dev)
    sched = Scheduler(seng)
    sampling = SamplingParams(temperature=0.8, top_k=8, seed=0)
    streams: dict = {}
    gen = torch.Generator().manual_seed(2)
    for rid, prompt in enumerate(_prompts(gen, stream_requests, 6,
                                          cfg.vocab_size)):
        sched.submit(
            Request(rid=rid, prompt=prompt, max_new_tokens=stream_max_new,
                    arrival_s=0.1 * rid, sampling=sampling),
            on_token=lambda r, tok: streams.setdefault(r.rid, []).append(tok),
        )
    sresults = _served(sched.run_until_idle())
    engines["stream"] = seng.compile_stats()
    if any(streams.get(rid) != toks for rid, toks in sresults.items()):
        raise RuntimeError(f"streamed tokens {streams} differ from the final "
                           f"outputs {sresults}")
    stats = sched.stats()
    log(f"streamed {stats['tokens']} tokens from {stats['completed']} "
        f"requests at {stats['tokens_per_s']:.1f} tok/s; "
        f"ttft p50 {stats['ttft_s']['p50'] * 1e3:.0f}ms, "
        f"itl p50 {stats['itl_s']['p50'] * 1e3:.1f}ms on {where}")
    for rid in sorted(streams):
        log(f"  req {rid} streamed: {streams[rid]}")
    return {"cfg": cfg, "params": params, "losses": losses,
            "prompts": prompts, "float": out_float, "fused": out_fused,
            "same": same, "streams": streams, "stream_outputs": sresults,
            "stats": stats, "engines": engines, "seconds": seconds,
            "tokens": tokens}


def expected_launches(out: dict) -> dict:
    """The kernel launches a :func:`run` on the card makes: B2 once per
    layer of every prefill and decode call of its three engines, B1 on
    both halves of every KAN-FFN of every call of the two deployed ones."""
    layers = out["cfg"].num_layers
    calls = {name: st["prefill_calls"] + st["decode_traces"]
             + st["verify_calls"] for name, st in out["engines"].items()}
    return {"flash_attention": layers * sum(calls.values()),
            "kan_pipeline_layer": 2 * layers * (calls["fused"]
                                                + calls["stream"])}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_demo")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
