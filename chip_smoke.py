#!/usr/bin/env python3
"""Build the PyTorch/CUDA port on one card and drive its main path.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA card (sm_90a, the
H100) and ``nvcc``.  It imports nothing of JAX or of the reference package.

Phases (any failure exits non-zero):

  1. device report: name, count, ``nvidia-smi`` name and power limit; TF32 off;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (seconds, ptxas);
  3. each kernel against its plain PyTorch version on the card
     (``repro_torch.kernels.kan_spline.cardcheck``): B1 in every flag
     combination at the KAN1 / KAN2 / FFN layer geometries (packed and
     unpacked B1 runs bit-identical), B3 on ragged shapes, both at every
     spline order 1..5 the kernel library is built for;
  4. the slice end to end: KAN1, KAN2, mixed (8, 4) KAN1 and the (64,128,64)
     G=8 FFN stack, initialized on the card, quantized and deployed, answer
     knot-surrogate requests of 1..65536 rows through ``runtime.execute``
     (default "fused" backend) and, for KAN1, the single-layer B3 path of the
     quickstart; every answer is held against the "ref" backend; the
     dispatch, launch and plan-cache counters are checked;
  5. CUDA-event times of B1 and B3 at the slice's 65536-row shapes beside
     their bounds and plain versions, the 65536-row request time and the
     peak device memory of those requests;
  6. one JSON line of kernels, then ``{"ok": true, "device": ...}`` last.

A longer report goes to ``reports/chip_smoke_report.json`` (gitignored).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's published peaks (H100 SXM, NVIDIA data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# atol for the slice's answers against the "ref" backend: f32 sums of the
# same O(1) terms in another order differ by a few ulps
ATOL = 1e-5
BATCHES = (1, 3, 5, 7, 8, 33, 130, 4096, 65536)
KERNEL_ROWS = 4096  # rows of each kernel-vs-plain check in phase 3
SOURCE = "src/repro_torch/csrc/kan_spline.cu"


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 \
        else f"nvidia-smi failed: {proc.stderr.strip()}"


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` launches."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, flops: int) -> tuple:
    """(bound ms, "bytes" | "operations") from the card's peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------------


def phase_kernels(dev, report) -> dict:
    import torch

    from repro_torch.kernels.kan_spline import cardcheck as cc

    gen = torch.Generator(device=dev).manual_seed(11)
    b1_err, excused, runs = 0.0, 0, 0
    for order in cc.ORDERS:
        for grid, f, o in cc.B1_GEOMETRIES:
            for flags in cc.B1_FLAGS:
                st = cc.check_b1(dev, gen, grid, f, o, flags, KERNEL_ROWS, order)
                b1_err = max(b1_err, st["max_abs_err"])
                excused += st["excused"]
                runs += 1
    print(f"B1 vs plain: {runs} runs ({len(cc.B1_FLAGS)} flag sets x "
          f"{len(cc.B1_GEOMETRIES)} layer geometries x orders {cc.ORDERS}, "
          f"{KERNEL_ROWS} rows), max |err| {b1_err:.3e} (atol {cc.ATOL}), "
          f"excused codes {excused}, packed == unpacked bit for bit")

    b3_err = max(cc.check_b3(dev, gen, *shape, order=order)
                 for order in cc.ORDERS for shape in cc.B3_SHAPES)
    print(f"B3 vs plain: {len(cc.B3_SHAPES)} shapes x orders {cc.ORDERS}, "
          f"max |err| {b3_err:.3e}")
    report["kernel_checks"] = {"b1_runs": runs, "b1_max_abs_err": b1_err,
                               "b1_excused_codes": excused,
                               "b3_max_abs_err": b3_err}
    return {"kan_pipeline_layer": b1_err, "kan_spline": b3_err}


# ----------------------------------------------------------------------------
# phase 4: the slice end to end
# ----------------------------------------------------------------------------


def build_models(dev) -> dict:
    import torch

    from repro_torch.core.kan_layer import KANSpec, init_kan_network
    from repro_torch.core.kan_network_deploy import (
        deploy_kan_ffn_stack,
        deploy_kan_network,
        quantize_kan_network,
    )

    models = {}
    for name, dims, grid, bits in [
        ("kan1", (17, 1, 14), 5, 8),
        ("kan2", (17, 1, 14), 68, 8),
        ("kan1_mixed_8_4", (17, 1, 14), 5, (8, 4)),
        ("ffn_64_128_64_g8", (64, 128, 64), 8, 8),
    ]:
        kspec = KANSpec(dims=dims, grid_size=grid, n_bits=bits)
        gen = torch.Generator(device=dev).manual_seed(0)
        qparams = quantize_kan_network(init_kan_network(gen, kspec, device=dev),
                                       kspec)
        if name.startswith("ffn"):
            dep = deploy_kan_ffn_stack(qparams, dims, kspec.layer_spec(),
                                       batch=8, device=dev)
        else:
            dep = deploy_kan_network(qparams, kspec, batch=8, device=dev)
        models[name] = (kspec, qparams, dep)
    return models


def requests(name: str, knot, b: int):
    """``b`` rows of knot-surrogate features (17 per row; the FFN takes 64,
    four rows' features laid end to end)."""
    if name.startswith("ffn"):
        return knot[: 4 * b].reshape(b, 68)[:, :64].copy()
    return knot[:b]


def phase_slice(dev, models, report) -> dict:
    import torch

    from repro_torch import parity, runtime
    from repro_torch.core.asp_quant import quantize_input
    from repro_torch.data.knot import make_knot_dataset
    from repro_torch.kernels import cuda
    from repro_torch.kernels.kan_spline.ops import kan_spline_from_qparams
    from repro_torch.runtime.executor import _entry_codes

    knot, _, _, _ = make_knot_dataset(n_train=4 * max(BATCHES), n_test=1, seed=0)
    kspec1, qp1, _ = models["kan1"]
    spec1 = kspec1.layer_specs()

    runtime.reset_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_dispatch_counts()
    cuda.reset_launch_counts()
    answers, quick = {}, {}
    t0 = time.perf_counter()
    for name, (_, _, dep) in models.items():
        for b in BATCHES:
            answers[name, b] = runtime.execute(dep, requests(name, knot, b),
                                               return_intermediates=True)
    for b in BATCHES:
        # quickstart's path: kernel B3 layer by layer, tanh re-coding between
        x = torch.as_tensor(knot[:b], device=dev)
        c1 = quantize_input(torch.tanh(
            kan_spline_from_qparams(quantize_input(x, spec1[0]), qp1[0], spec1[0])),
            spec1[1])
        quick[b] = (c1, kan_spline_from_qparams(c1, qp1[1], spec1[1]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dispatch = runtime.dispatch_counts()
    launches = cuda.launch_counts()
    stats = runtime.cache_stats()
    peak = torch.cuda.max_memory_allocated()

    n_req = len(models) * len(BATCHES)
    n_layers = sum(len(dep.plan.layers) for _, _, dep in models.values())
    buckets = len({runtime.bucket_batch(b) for b in BATCHES})
    print(f"main path: {n_req} requests in {wall:.3f} s; dispatch {dispatch}; "
          f"launches {launches}; plan cache {stats}; peak memory {peak} B")
    require(dispatch == {"fused": n_req}, f"dispatch counts {dispatch}")
    require(launches.get("kan_pipeline_layer") == len(BATCHES) * n_layers,
            f"B1 launches {launches} != requests x layers")
    require(launches.get("kan_spline") == 2 * len(BATCHES),
            f"B3 launches {launches} != quickstart requests x layers")
    require(stats["misses"] == len(models) * buckets,
            f"plan-cache misses {stats['misses']} != distinct buckets "
            f"{len(models) * buckets}")

    checked = {}
    for (name, b), (y, codes) in answers.items():
        dep = models[name][2]
        x = torch.as_tensor(requests(name, knot, b), device=dev)
        ry, rcodes = runtime.execute(dep, x, backend="ref",
                                     return_intermediates=True)
        entry, xraw = _entry_codes(dep, x, None)
        pre = parity.boundary_prerounds(dep, entry, xraw, rcodes)
        require(y.shape == (b, dep.dims[-1]) and bool(torch.isfinite(y).all()),
                f"{name} b={b}: bad output {tuple(y.shape)}")
        st = parity.compare_runs(codes, rcodes, pre, y, ry)
        if name == "kan1":
            c1, qy = quick[b]
            parity.compare_runs([c1], rcodes, pre, qy, ry)
        checked[f"{name}/{b}"] = st
    excused = sum(s["excused"] for s in checked.values())
    left = sum(s["rows_left_out"] for s in checked.values())
    err = max(s["max_abs_err"] for s in checked.values())
    print(f"fused vs ref on the card: {len(checked)} answers agree, max |err| "
          f"{err:.3e} (atol {ATOL}), excused codes {excused}, rows left out "
          f"{left}; quickstart B3 path agrees with ref")
    report["slice"] = {"requests": n_req, "wall_s": wall, "dispatch": dispatch,
                       "launches": launches, "plan_cache": stats,
                       "peak_bytes": peak, "vs_ref": checked}
    return launches


# ----------------------------------------------------------------------------
# phase 5: times
# ----------------------------------------------------------------------------


def b1_work(lp, lw, bp) -> tuple:
    """(bytes, flops) of one B1 call.  Bytes as the padded contract hands
    them: each stored weight operand read once, the (bp, fp) codes (and raw
    inputs) read once, the (bp, op) outputs written once.  Flops: the band
    work the layer needs, K+1 LUT MACs + 1 residual MAC per logical
    (b, f, o); padded features and columns carry zero weights."""
    nbytes = sum(t.numel() * t.element_size() for k, t in lw.items()
                 if not (k == "lut" and "lutp" in lw))
    nbytes += bp * lp.fp * 4 * (2 if lp.residual_raw else 1)
    nbytes += bp * lp.op * 4 * (2 if lp.emit_codes else 1)
    flops = 2 * bp * lp.f * lp.o * (lp.spec.order + 2)
    return nbytes, flops


def phase_times(dev, models, report) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch import runtime
    from repro_torch.core.asp_quant import quantize_input
    from repro_torch.data.knot import make_knot_dataset
    from repro_torch.kernels.kan_spline import pipeline as pl
    from repro_torch.kernels.kan_spline.ops import kan_spline
    from repro_torch.kernels.kan_spline.ref import kan_spline_ref
    from repro_torch.runtime.executor import _entry_codes

    bp = max(BATCHES)
    knot, _, _, _ = make_knot_dataset(n_train=4 * bp, n_test=1, seed=0)
    rows, totals = [], {}
    # library_ms stays none: no single PyTorch call computes either kernel's
    # function (a gathered band MAC + requantizer), so none is timed
    print("B1 at 65536 rows: layer | kernel ms | plain ms | bound ms (by) | "
          "library_ms: none")
    for name, (_, _, dep) in models.items():
        plan = runtime.PLAN_CACHE.plan(bp, dep.dims, dep.specs,
                                       residual_raw=dep.residual_raw)
        x = torch.as_tensor(requests(name, knot, bp), device=dev)
        codes, xraw = _entry_codes(dep, x, None)
        lp0 = plan.layers[0]
        codes = F.pad(codes, (0, lp0.fp - lp0.f))
        xraw = None if xraw is None else F.pad(xraw, (0, lp0.fp - lp0.f))
        for li, (lp, lw) in enumerate(zip(plan.layers, dep.layers)):
            args = (codes, xraw if lp.residual_raw else None, lw, lp, bp)
            ms = cuda_ms(lambda: pl.run_pipeline_layer(*args), reps=50)
            plain = cuda_ms(lambda: pl.run_pipeline_layer_plain(*args), reps=5,
                            warmup=1)
            b_ms, by = bound(*b1_work(lp, lw, bp))
            rows.append({"kernel": "kan_pipeline_layer", "layer": f"{name}/{li}",
                         "f": lp.f, "o": lp.o, "fp": lp.fp, "op": lp.op,
                         "nb": lp.spec.num_basis,
                         "packed_w": "wcp" in lw, "packed_lut": "lutp" in lw,
                         "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": by})
            print(f"  {name}/{li} f={lp.f} o={lp.o} fp={lp.fp} op={lp.op} "
                  f"nb={lp.spec.num_basis} | {ms:.4f} | {plain:.4f} | "
                  f"{b_ms:.4f} ({by})")
            y, nxt = pl.run_pipeline_layer(*args)
            codes, xraw = nxt, y

    kspec1, qp1, _ = models["kan1"]
    specs = kspec1.layer_specs()
    x = torch.as_tensor(knot[:bp], device=dev)
    c0 = quantize_input(x, specs[0])
    print("B3 at 65536 rows (quickstart's KAN1 layers), library_ms: none:")
    for li, (qp, spec) in enumerate(zip(qp1, specs)):
        wc = qp["c_q"].to(torch.float32) * qp["c_scale"]
        wb = qp["w_b_q"].to(torch.float32) * qp["w_b_scale"]
        args = (c0, qp["lut"], wc, wb, spec)
        ms = cuda_ms(lambda: kan_spline(*args), reps=50)
        plain = cuda_ms(lambda: kan_spline_ref(*args), reps=5, warmup=1)
        f, nb, o = wc.shape
        nbytes = (c0.numel() * 4 + qp["lut"].numel() * 4 + wc.numel() * 4
                  + wb.numel() * 4 + bp * o * 4)
        b_ms, by = bound(nbytes, 2 * bp * f * o * (spec.order + 2))
        rows.append({"kernel": "kan_spline", "layer": f"kan1/{li}", "fp": f,
                     "op": o, "nb": nb, "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": by})
        print(f"  kan1/{li} F={f} O={o} | {ms:.4f} | {plain:.4f} | "
              f"{b_ms:.4f} ({by})")
        if li == 0:
            c0 = quantize_input(torch.tanh(kan_spline(*args)), specs[1])

    for kern in ("kan_pipeline_layer", "kan_spline"):
        sel = [r for r in rows if r["kernel"] == kern]
        by_time = {"bytes": 0.0, "operations": 0.0}
        for r in sel:
            by_time[r["bound_by"]] += r["bound_ms"]
        totals[kern] = {
            "ms": sum(r["ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": sum(r["bound_ms"] for r in sel),
            "bound_by": max(by_time, key=by_time.get),
        }
        t = totals[kern]
        print(f"{kern} at 65536 rows, all layers: {t['ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"bound / kernel time {100 * t['bound_ms'] / t['ms']:.2f}%")

    e2e = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, (_, _, dep) in models.items():
        x = requests(name, knot, bp)
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runtime.execute(dep, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        e2e[name] = sorted(times[1:])[len(times[1:]) // 2]
    peak = torch.cuda.max_memory_allocated()
    print("request time at 65536 rows (host clock, median of 5, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in e2e.items()))
    print(f"peak device memory over those requests: {peak} B")
    breakdown = profile_requests(models, knot, bp, e2e)
    report["times"] = {"rows": rows, "totals": totals, "request_ms_65536": e2e,
                       "device_breakdown_65536": breakdown,
                       "request_peak_bytes_65536": peak}
    return totals


def profile_requests(models, knot, bp, e2e) -> dict:
    """Device time by kernel of one 65536-row request per model (profiler),
    and its share of the unprofiled request time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import runtime

    out = {}
    print("device time of one 65536-row request (profiler, ms): total | "
          "share of request time | top kernels")
    for name, (_, _, dep) in models.items():
        x = requests(name, knot, bp)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runtime.execute(dep, x)
            torch.cuda.synchronize()
        kernels = []
        for ev in prof.key_averages():
            # the record_function range of the executor also shows on the
            # device timeline; it spans the kernels, so it is left out
            if (ev.device_type != torch.autograd.DeviceType.CUDA
                    or ev.key.startswith("kan_spline.")
                    or getattr(ev, "is_user_annotation", False)):
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            key = ev.key.replace("void (anonymous namespace)::", "")
            kernels.append((us / 1e3, key.split("((")[0][:48]))
        kernels.sort(reverse=True)
        total = sum(ms for ms, _ in kernels)
        out[name] = {"device_ms": total, "busy_share": total / e2e[name],
                     "top": kernels[:4]}
        top = "; ".join(f"{k} {ms:.3f}" for ms, k in kernels[:3]) \
            or "profiler saw no device time"
        print(f"  {name}: {total:.3f} | {total / e2e[name]:.2f} | {top}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {name} x {torch.cuda.device_count()}; {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = cuda.build()
    summary = [ln.strip() for ln in info["ptxas"].splitlines()
               if "registers" in ln or "spill" in ln]
    print(f"build: {info['seconds']:.2f} s ({'cached' if info['cached'] else 'nvcc'}),"
          f" {len(summary) // 2} kernel instances")
    for ln in summary[:4]:
        print(f"  ptxas: {ln}")

    report = {"device": name, "smi": smi, "build_s": info["seconds"],
              "ptxas": summary}
    errs = phase_kernels(dev, report)
    models = build_models(dev)
    launches = phase_slice(dev, models, report)
    totals = phase_times(dev, models, report)

    out = ROOT / "reports"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))

    replaces = {
        "kan_pipeline_layer": "src/repro/kernels/kan_spline/pipeline.py:471",
        "kan_spline": "src/repro/kernels/kan_spline/kernel.py:33",
    }
    kernels = [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": replaces[k],
         "launches": launches.get(k, 0), "max_abs_err": errs[k],
         "ms": totals[k]["ms"], "plain_ms": totals[k]["plain_ms"],
         "bound_ms": totals[k]["bound_ms"], "bound_by": totals[k]["bound_by"],
         "library_ms": None}
        for k in ("kan_pipeline_layer", "kan_spline")
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
