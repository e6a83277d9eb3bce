"""Run one cell once: build the system, drive its mix, judge, read metrics.

Nothing here knows a cell, a configuration or a metric by name: each is
found through ``BENCHMARK.json`` (``benchlib.manifest``).
"""

from __future__ import annotations

import gc
import math
import time
import types

from .manifest import Manifest
from .trace import Tracer

BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list:
    """Top-level names of loaded modules that the port must not pull in,
    compared whole (``repro_torch`` is not ``repro``)."""
    import sys

    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(BANNED_MODULES))


def make_context(cfg, mix, sut, seed, seconds, trace, device, t_start):
    import torch

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def reset_peak():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def read_peak():
        if cuda:
            torch.cuda.synchronize()
            return int(torch.cuda.max_memory_allocated())
        return 0

    return types.SimpleNamespace(
        cfg=cfg, mix=mix, sut=sut, seed=seed, seconds=seconds, trace=trace,
        device=device, t_start=t_start, sync=sync, reset_peak=reset_peak,
        read_peak=read_peak, tracer=lambda: Tracer(device))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, manifest: Manifest | None = None,
             cfg: dict | None = None, mix: dict | None = None,
             plant=None, control: bool = False,
             limits: dict | None = None) -> dict:
    """One run of ``cell``; returns the result object of the last line.

    ``cfg`` / ``mix`` / ``limits`` replace the cell's files (the tests'
    small sizes);
    ``plant(sut)`` runs after the system is built (the tests' faults);
    ``control`` adds the control's reading on the run's own answers under
    ``"control"`` (``bench/calibrate.py``; a benchmark run never does)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    m = manifest or Manifest()
    spec = m.cell(cell)
    cfg = cfg or m.config(spec["config"])
    mix = mix or m.mix(spec["traffic"])
    limits = limits or m.limits(cell)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sut = m.system(cfg["system"]).build(cfg, mix, seed, device)
    if plant is not None:
        plant(sut)
    ctx = make_context(cfg, mix, sut, seed, seconds, trace, device, t_start)
    rec = m.generator(mix["kind"]).run(ctx)

    # the program's state goes before the reference runs
    sut.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found = sut.judge(rec.answers)
    checks = {name: {"value": found[name], "limit": lim["limit"]}
              for name, lim in limits["checks"].items()}
    correct = (rec.failed == 0 and found.get("answers", 0) > 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))

    metrics = {}
    for meta in m.metrics_for(cell, trace):
        value = m.reader(meta["name"]).read(rec)
        if value is not None:
            metrics[meta["name"]] = {"value": value, "unit": meta["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": rec.peak_bytes}
    out = {"correct": bool(correct), "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s()
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    out["judged"] = {k: v for k, v in found.items() if k not in checks}
    if control:
        out["control"] = sut.control(rec.answers)
    out["checks"] = checks
    return out
