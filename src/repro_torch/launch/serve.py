"""Serving entry point: the streaming scheduler over a smoke-size model.

Port of ``repro.launch.serve``.  Runs on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --kan-ffn --requests 8 --slots 4
    # on the CPU (the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --kan-ffn --device cpu
    # the sliding-window and MoE decoders (gemma2's alternating local /
    # global layers, mixtral's windowed MoE, olmoe's 64 experts):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \\
        --kan-ffn --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
        --device cpu
    # the recurrent decoders (recurrentgemma's RG-LRU + local attention,
    # mamba2's SSD); on the card at the published widths, 8 layers:
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --kan-ffn --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        --device cpu
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --kan-ffn \\
        --full-width-layers 8 --requests 4 --max-new 8
    # with the ACIM non-idealities (IR-drop, TM-DV and partial-sum noise):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --kan-ffn --backend acim
    # paged KV pool with prefix caching and chunked prefill:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --kv-block-size 16 --prefix-cache on --prefill-chunk 32
    # stream tokens, sample instead of greedy decode:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --stream --sampling 0.8 --top-k 16 --seed 7
    # speculative decoding (a grid-4 refit drafter, k = 2), with the span
    # trace and a metrics snapshot written at shutdown:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --kan-ffn --kv-block-size 8 --spec-decode 2 --draft-spec grid=4 \\
        --trace-out trace.jsonl --metrics-dump metrics.prom --device cpu
    # deploy a co-design point from a tuning artifact (repro_torch.tune):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --kan-ffn --tuned-config TUNE_artifact.json

``--kan-ffn`` serves the paper's datapath: the FFN blocks are
ASP-quantized and deployed at startup, and every prefill / decode step runs
them through kernel B1 (``--backend acim``: with the paper's ACIM
non-idealities injected); attention runs through kernel B2 ("flash")
unless ``--attn-backend ref``.  Weights are random, drawn from a fixed seed;
the model is the arch's smoke-size config, or its published widths with
``--full-width-layers N`` layers.  Decoders with "local" (sliding-window),
"rglru" (RG-LRU) or "ssm" (Mamba-2) layers serve from contiguous caches
only (no ``--kv-block-size``, so no ``--spec-decode``), as in the
reference; the audio / vlm families exit, as the engine cannot feed
their stub embeddings (the reference raises ``KeyError`` there).
``--spec-decode K`` (with ``--kan-ffn`` and ``--kv-block-size``) adds a
refit KAN drafter (``--draft-spec``); ``--metrics-port`` / ``--metrics-dump``
turn the obs registry on, ``--trace-out`` records the per-request span
trees, ``--log-level`` and ``--stats-interval`` drive the structured
logger.  ``--tuned-config`` loads a tuning artifact (either package's):
its chosen point's grid, order and bit widths become the KAN-FFN
quantization, and its tile plan is registered with the plan cache.
``--mesh data=D,model=M`` serves on a ``DeviceMesh`` (``launch.mesh``):
slots and KV on "data", attention heads, the vocabulary and the KAN-FFN
columns on "model".  One card takes ``--mesh data=1,model=1`` without a
launcher; a larger mesh runs one process per device under ``torchrun
--nproc-per-node N``, every rank on the same request stream; ``--deadline``
there expires requests on rank 0's clock (``serve.scheduler.MeshClock``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .. import obs, runtime
from ..configs.registry import get_config, smoke_config
from ..core.asp_quant import resolve_layer_bits
from ..device import resolve_device
from ..models.model import init_params, tokens_only_refusal
from ..serve.engine import Request, ServeEngine
from ..serve.scheduler import QueueFull, SamplingParams, Scheduler


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
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="serve on a device mesh: 'data=2,model=4' (one axis "
                         "may omit =N to absorb the remaining ranks, e.g. "
                         "'data,model=2'); slots / KV on data, heads, vocab "
                         "and KAN-FFN columns on model.  Ranks are the "
                         "process group's (torchrun), or one")
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
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="speculative decoding: a refit KAN drafter proposes "
                         "K tokens per round, the target verifies K+1 "
                         "positions in one forward (needs --kan-ffn and "
                         "--kv-block-size); 0 = off")
    ap.add_argument("--draft-spec", default=None, metavar="SPEC",
                    help="with --spec-decode: the drafter's deployment "
                         "point, e.g. 'grid=4,order=2,bits=6,backend=ref' "
                         "(defaults: half the target grid, same order and "
                         "bits, the engine's backend)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="enable the obs registry and serve Prometheus text "
                         "at http://127.0.0.1:PORT/metrics (JSON at "
                         "/metrics.json); 0 picks a free port")
    ap.add_argument("--metrics-dump", action="append", default=None,
                    metavar="PATH",
                    help="enable the obs registry and write a snapshot at "
                         "shutdown: '.json' -> JSON, else Prometheus text; "
                         "repeatable")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record one span tree per request, written at "
                         "shutdown: '.json' -> Chrome trace events, else "
                         "JSONL span records")
    ap.add_argument("--log-level", default=None,
                    choices=("debug", "info", "warning", "error"),
                    help="structured-logger threshold (sets REPRO_LOG_LEVEL "
                         "for this process)")
    ap.add_argument("--stats-interval", type=float, default=None,
                    metavar="S",
                    help="a one-line scheduler stats summary every S seconds")
    ap.add_argument("--full-width-layers", type=int, default=None,
                    metavar="N",
                    help="serve the arch at its published widths with its "
                         "depth cut to N layers, instead of the smoke-size "
                         "config (random weights either way)")
    ap.add_argument("--tuned-config", default=None, metavar="PATH",
                    help="tuning artifact to deploy: its chosen point "
                         "becomes the KAN-FFN quantization (over "
                         "--kan-bits) and its tile plan is registered "
                         "with the runtime plan cache")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.log_level:
        os.environ[obs.ENV_LOG_LEVEL_VAR] = args.log_level
    if args.metrics_port is not None or args.metrics_dump:
        obs.enable()
    log = obs.get_logger("serve")
    dev = resolve_device(args.device)

    cfg = (smoke_config(args.arch) if args.full_width_layers is None else
           dataclasses.replace(get_config(args.arch),
                               num_layers=args.full_width_layers))
    if args.kan_bits:
        bits = tuple(int(b) for b in args.kan_bits.split(","))
        cfg = (dataclasses.replace(cfg, kan_n_bits=bits[0], kan_layer_bits=())
               if len(bits) == 1 else
               dataclasses.replace(cfg, kan_layer_bits=bits))
    tuned_note = ""
    if args.tuned_config:
        from ..tune import apply_tuning_artifact, load_tuning_artifact

        art = load_tuning_artifact(args.tuned_config)
        resolved = apply_tuning_artifact(art)
        cand = resolved["candidate"]
        if cand is not None:
            # the chosen co-design point becomes the KAN-FFN quantization,
            # its per-layer allocation included (over any --kan-bits)
            cfg = dataclasses.replace(
                cfg, kan_grid=cand.grid_size, kan_order=cand.order,
                kan_n_bits=cand.n_bits, kan_layer_bits=cand.layer_bits)
        tp = art.get("tile_plan")
        tuned_note = (f" [artifact {args.tuned_config}: "
                      f"task={art.get('task')}, seed={art.get('seed')}, "
                      f"space={art.get('space_hash')}, tile mode="
                      f"{None if not tp else tp.get('mode')}]")
    if args.kan_ffn:
        cfg = cfg.kan_variant()
        try:
            resolve_layer_bits(cfg.kan_layer_bits or cfg.kan_n_bits, 2,
                               cfg.kan_grid)
        except ValueError as e:
            raise SystemExit(f"invalid KAN bit allocation: {e}")
    refusal = tokens_only_refusal(cfg, "the serving engine")
    if refusal:
        raise SystemExit(refusal)
    if args.prefill_chunk is not None and args.kv_block_size is None:
        raise SystemExit("--prefill-chunk requires --kv-block-size")
    if args.spec_decode:
        if not args.kan_ffn:
            raise SystemExit("--spec-decode requires --kan-ffn (the drafter "
                             "is refit from the KAN-FFN weights)")
        if args.kv_block_size is None:
            raise SystemExit("--spec-decode requires --kv-block-size "
                             "(draft rollback releases pool blocks)")

    mesh = None
    if args.mesh:
        from .mesh import parse_mesh_spec

        try:
            mesh = parse_mesh_spec(args.mesh, device=dev)
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}")
        if dev.type == "cuda":  # this rank's card (LOCAL_RANK under torchrun)
            dev = torch.device("cuda", torch.cuda.current_device())

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, cfg, device=dev)
    engine = ServeEngine(params, cfg, slots=args.slots, max_len=128,
                         kan_deploy=args.kan_ffn, kan_backend=args.backend,
                         attn_backend=args.attn_backend, mesh=mesh,
                         kv_block_size=args.kv_block_size,
                         prefix_cache=args.prefix_cache == "on",
                         prefill_chunk=args.prefill_chunk,
                         spec_decode=args.spec_decode,
                         draft_spec=args.draft_spec, device=dev)
    kan_backend = (runtime.resolve_backend(args.backend) if args.kan_ffn
                   else "none")
    log.info("device", device=dev,
             name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"))
    log.info("backends", attn_backend=engine.attn_backend,
             kan_backend=kan_backend)
    if engine.draft is not None:
        d = engine.draft.describe()
        log.info("spec decode", k=engine.spec_k, draft_grid=d["kan_grid"],
                 draft_order=d["kan_order"], draft_bits=d["kan_n_bits"],
                 draft_backend=d["kan_backend"] or "inherit")
    if engine.paged:
        kv = engine.kv_stats()
        log.info("paged kv", blocks=kv["num_blocks"],
                 block_size=kv["block_size"],
                 prefix_cache="on" if kv["prefix_cache"] else "off",
                 prefill_chunk=kv["prefill_chunk"] or "whole-prompt")
    if mesh is not None:
        import torch.distributed as dist

        layout = engine.mesh_layout()
        n_dev = (torch.cuda.device_count() if dev.type == "cuda"
                 else dist.get_world_size())
        log.info("mesh",
                 shape=" x ".join(f"{a}={s}" for a, s in
                                  zip(layout["axes"], layout["shape"])),
                 devices=f"{dist.get_world_size()}/{n_dev}",
                 slots=("sharded" if layout["slots_sharded"]
                        else "replicated"))
    if args.kan_ffn:
        log.info("kan-ffn", G=cfg.kan_grid, K=cfg.kan_order,
                 n_bits=cfg.kan_n_bits,
                 layer_bits=("uniform" if not cfg.kan_layer_bits
                             else ",".join(map(str, cfg.kan_layer_bits))),
                 plan_source=engine.kan_plan_source() + tuned_note)
    metrics_server = None
    if args.metrics_port is not None:
        metrics_server = obs.start_metrics_server(args.metrics_port)
        log.info("metrics server",
                 url=f"http://127.0.0.1:{metrics_server.server_port}/metrics")
    sampling = None
    if args.sampling > 0.0:
        sampling = SamplingParams(temperature=args.sampling, top_k=args.top_k,
                                  top_p=args.top_p, seed=args.seed)
        log.info("sampling", temperature=sampling.temperature,
                 top_k=sampling.top_k, top_p=sampling.top_p,
                 seed=sampling.seed)

    rng = np.random.default_rng(1)
    reqs = []
    for rid in range(args.requests):
        plen = int(4 + rng.integers(0, 9))  # a mixed-length stream
        prompt = rng.integers(3, cfg.vocab_size, plen).tolist()
        reqs.append(Request(rid=rid, prompt=prompt,
                            max_new_tokens=args.max_new,
                            deadline_s=args.deadline, sampling=sampling))

    sched = Scheduler(engine, max_queue=args.queue_limit,
                      log=None if args.stream else print,
                      trace=args.trace_out is not None,
                      stats_interval_s=args.stats_interval)
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
            log.warning("backpressure", detail=str(e))
    t0 = time.perf_counter()
    results = sched.run_until_idle()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    served = [r for r in results if r.status == "done"]
    total = sum(len(r.output) for r in served)
    stats = engine.compile_stats()
    log.info("served", requests=len(served), tokens=total,
             tokens_per_s=round(total / wall, 1), rejected=dropped)
    log.info("steps", prefill_buckets=stats["prefill_traces"],
             prefill_calls=stats["prefill_calls"],
             decode=stats["decode_traces"], verify=stats["verify_calls"],
             kan_plan_cache=stats["plan_cache"])
    s = sched.stats()

    def ms(v):
        return "n/a" if v is None else f"{v * 1e3:.1f}ms"

    log.info("scheduler", submitted=s["submitted"], completed=s["completed"],
             expired=s["expired"], rejected=s["rejected"])
    ttft = s["ttft_s"] or {"p50": None, "p95": None}
    log.info("latency", ttft_p50=ms(ttft["p50"]), ttft_p95=ms(ttft["p95"]),
             itl_p50=ms(s["itl_s"]["p50"]), itl_p95=ms(s["itl_s"]["p95"]),
             tokens_per_s=round(s["tokens_per_s"] or 0.0, 1))
    log.info("queue depth", max=s["queue_depth"]["max"],
             mean=round(s["queue_depth"]["mean"], 2),
             samples=s["queue_depth"]["samples"])
    if s["kv"] is not None:
        kv = s["kv"]
        log.info("kv pool", hit_rate=round(kv["prefix_hit_rate"], 2),
                 hits=kv["prefix_hits"], misses=kv["prefix_misses"],
                 in_use=kv["blocks_in_use"], cached=kv["blocks_cached"],
                 free=kv["blocks_free"], evictions=kv["evictions"],
                 truncations=kv["truncations"])
    if s["spec"] is not None:
        sp = s["spec"]
        log.info("spec decode", k=sp["k"], rounds=sp["rounds"],
                 drafted=sp["drafted"], accepted=sp["accepted"],
                 accept_rate=(round(sp["accept_rate"], 3)
                              if sp["accept_rate"] is not None else None),
                 draft_p50=ms(sp["draft_s"]["p50"]),
                 verify_p50=ms(sp["verify_s"]["p50"]),
                 tokens_per_round=(round(s["tokens_per_round"], 2)
                                   if s["tokens_per_round"] is not None
                                   else None))
    if args.trace_out:
        if args.trace_out.endswith(".json"):
            sched.tracer.export_chrome(args.trace_out)
        else:
            sched.tracer.export_jsonl(args.trace_out)
        log.info("trace written", path=args.trace_out,
                 records=len(sched.tracer.records()))
    for path in args.metrics_dump or ():
        obs.dump_metrics(path)
        log.info("metrics dump written", path=path)
    if metrics_server is not None:
        metrics_server.shutdown()


if __name__ == "__main__":
    main()
