"""Serving entry point: the streaming scheduler over a smoke-size model.

Port of ``repro.launch.serve``.  Runs on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --kan-ffn --requests 8 --slots 4
    # on the CPU (the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --kan-ffn --device cpu
    # with the ACIM non-idealities (IR-drop, TM-DV and partial-sum noise):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --kan-ffn --backend acim
    # paged KV pool with prefix caching and chunked prefill:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --kv-block-size 16 --prefix-cache on --prefill-chunk 32
    # stream tokens, sample instead of greedy decode:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --stream --sampling 0.8 --top-k 16 --seed 7

``--kan-ffn`` serves the paper's datapath: the FFN blocks are
ASP-quantized and deployed at startup, and every prefill / decode step runs
them through kernel B1 (``--backend acim``: with the paper's ACIM
non-idealities injected); attention runs through kernel B2 ("flash")
unless ``--attn-backend ref``.  Weights are random, drawn from a fixed seed.
The reference's mesh, speculative-decoding, tuning-artifact and
observability flags exit with "not ported yet" and their ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import runtime
from ..configs.registry import smoke_config
from ..core.asp_quant import resolve_layer_bits
from ..device import resolve_device
from ..models.model import init_params
from ..serve.engine import Request, ServeEngine
from ..serve.scheduler import QueueFull, SamplingParams, Scheduler

# reference flags that wait for a later slice -> their ROADMAP item
NOT_PORTED = {
    "mesh": "A10 (distribution)",
    "spec_decode": "A6 (serve/spec.py)",
    "draft_spec": "A6 (serve/spec.py)",
    "tuned_config": "A9 (co-design stack)",
    "metrics_port": "A6 (obs)",
    "metrics_dump": "A6 (obs)",
    "trace_out": "A6 (obs)",
    "log_level": "A6 (obs)",
    "stats_interval": "A6 (obs)",
}


def log(msg: str, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"{msg} {extra}".strip(), flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--kan-ffn", action="store_true",
                    help="serve the KAN-FFN variant on the quantized "
                         "datapath (kernel B1)")
    ap.add_argument("--kan-bits", default=None, metavar="BITS",
                    help="with --kan-ffn: per-half ASP bit widths, e.g. "
                         "'8,4', or one value for a uniform width")
    ap.add_argument("--backend", default=None,
                    choices=("ref", "fused", "pallas", "acim"),
                    help="KAN executor backend (with --kan-ffn); default "
                         "resolves via REPRO_KAN_BACKEND, then 'fused'")
    ap.add_argument("--attn-backend", default=None, choices=("ref", "flash"),
                    help="attention backend: 'flash' = kernel B2, 'ref' = "
                         "the chunked composition; default resolves via "
                         "REPRO_ATTN_BACKEND, then 'flash'")
    ap.add_argument("--kv-block-size", type=int, default=None,
                    metavar="TOKENS",
                    help="paged KV cache in blocks of this many tokens (a "
                         "multiple of 8 dividing the max length)")
    ap.add_argument("--prefix-cache", default="on", choices=("on", "off"))
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    metavar="TOKENS",
                    help="with --kv-block-size: prefill this many tokens "
                         "per scheduling round")
    ap.add_argument("--sampling", type=float, default=0.0, metavar="TEMP",
                    help="decode temperature; 0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed (per-request streams fold rid)")
    ap.add_argument("--queue-limit", type=int, default=None, metavar="N")
    ap.add_argument("--deadline", type=float, default=None, metavar="S")
    ap.add_argument("--stream", action="store_true",
                    help="print every token as it is produced")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    for flag in NOT_PORTED:
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet "
                             f"(ROADMAP {item})")
    dev = resolve_device(args.device)

    cfg = smoke_config(args.arch)
    if args.kan_bits:
        bits = tuple(int(b) for b in args.kan_bits.split(","))
        cfg = (dataclasses.replace(cfg, kan_n_bits=bits[0], kan_layer_bits=())
               if len(bits) == 1 else
               dataclasses.replace(cfg, kan_layer_bits=bits))
    if args.kan_ffn:
        cfg = cfg.kan_variant()
        try:
            resolve_layer_bits(cfg.kan_layer_bits or cfg.kan_n_bits, 2,
                               cfg.kan_grid)
        except ValueError as e:
            raise SystemExit(f"invalid KAN bit allocation: {e}")
    if cfg.family in ("audio", "vlm") or cfg.encoder_layers:
        raise SystemExit("serve supports decoder-only archs")
    if any(k != "global" for k in cfg.layer_kinds):
        raise SystemExit(f"{args.arch}: layer kinds {set(cfg.layer_kinds)} "
                         "are not ported yet (ROADMAP A7)")
    if args.prefill_chunk is not None and args.kv_block_size is None:
        raise SystemExit("--prefill-chunk requires --kv-block-size")

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, cfg, device=dev)
    engine = ServeEngine(params, cfg, slots=args.slots, max_len=128,
                         kan_deploy=args.kan_ffn, kan_backend=args.backend,
                         attn_backend=args.attn_backend,
                         kv_block_size=args.kv_block_size,
                         prefix_cache=args.prefix_cache == "on",
                         prefill_chunk=args.prefill_chunk, device=dev)
    kan_backend = (runtime.resolve_backend(args.backend) if args.kan_ffn
                   else "none")
    log("device", device=dev,
        name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu"))
    log("backends", attn_backend=engine.attn_backend, kan_backend=kan_backend)
    if engine.paged:
        kv = engine.kv_stats()
        log("paged kv", blocks=kv["num_blocks"], block_size=kv["block_size"],
            prefix_cache="on" if kv["prefix_cache"] else "off",
            prefill_chunk=kv["prefill_chunk"] or "whole-prompt")
    if args.kan_ffn:
        log("kan-ffn", G=cfg.kan_grid, K=cfg.kan_order, n_bits=cfg.kan_n_bits,
            layer_bits=("uniform" if not cfg.kan_layer_bits
                        else ",".join(map(str, cfg.kan_layer_bits))))
    sampling = None
    if args.sampling > 0.0:
        sampling = SamplingParams(temperature=args.sampling, top_k=args.top_k,
                                  top_p=args.top_p, seed=args.seed)
        log("sampling", temperature=sampling.temperature, top_k=sampling.top_k,
            top_p=sampling.top_p, seed=sampling.seed)

    rng = np.random.default_rng(1)
    reqs = []
    for rid in range(args.requests):
        plen = int(4 + rng.integers(0, 9))  # a mixed-length stream
        prompt = rng.integers(3, cfg.vocab_size, plen).tolist()
        reqs.append(Request(rid=rid, prompt=prompt,
                            max_new_tokens=args.max_new,
                            deadline_s=args.deadline, sampling=sampling))

    sched = Scheduler(engine, max_queue=args.queue_limit,
                      log=None if args.stream else log)
    on_token = None
    if args.stream:
        def on_token(r, tok):
            print(f"  req {r.rid} += {tok}", flush=True)
    dropped = 0
    for r in reqs:
        try:
            sched.submit(r, on_token=on_token)
        except QueueFull as e:
            dropped += 1
            log("backpressure", detail=str(e))
    t0 = time.perf_counter()
    results = sched.run_until_idle()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    served = [r for r in results if r.status == "done"]
    total = sum(len(r.output) for r in served)
    stats = engine.compile_stats()
    log("served", requests=len(served), tokens=total,
        tokens_per_s=round(total / wall, 1), rejected=dropped)
    log("steps", prefill_buckets=stats["prefill_traces"],
        prefill_calls=stats["prefill_calls"], decode=stats["decode_traces"],
        kan_plan_cache=stats["plan_cache"])
    s = sched.stats()

    def ms(v):
        return "n/a" if v is None else f"{v * 1e3:.1f}ms"

    log("scheduler", submitted=s["submitted"], completed=s["completed"],
        expired=s["expired"], rejected=s["rejected"])
    ttft = s["ttft_s"] or {"p50": None, "p95": None}
    log("latency", ttft_p50=ms(ttft["p50"]), ttft_p95=ms(ttft["p95"]),
        itl_p50=ms(s["itl_s"]["p50"]), itl_p95=ms(s["itl_s"]["p95"]),
        tokens_per_s=round(s["tokens_per_s"] or 0.0, 1))
    if s["kv"] is not None:
        kv = s["kv"]
        log("kv pool", hit_rate=round(kv["prefix_hit_rate"], 2),
            hits=kv["prefix_hits"], misses=kv["prefix_misses"],
            in_use=kv["blocks_in_use"], cached=kv["blocks_cached"],
            free=kv["blocks_free"], evictions=kv["evictions"])


if __name__ == "__main__":
    main()
