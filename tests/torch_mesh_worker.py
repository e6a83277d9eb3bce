"""Rank body of ``tests/test_torch_mesh.py``: one gloo rank of a CPU mesh.

Imports no JAX.  The parent writes the converted bundles and the inputs to
``workdir/inputs.pt``, starts ``data * model`` ranks of :func:`main` with a
deadline, and holds what each rank saves in ``workdir/out<rank>.pt``
against the JAX reference and the port's unsharded calls.  Every rank
starts its process group from a ``FileStore`` in ``workdir`` with a 60 s
timeout, so a rank that dies cannot leave the others waiting for longer.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import io
import os
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

PG_TIMEOUT = datetime.timedelta(seconds=60)
BACKENDS = ("fused", "ref", "acim")


def main(rank: int, world: int, data: int, model: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world, timeout=PG_TIMEOUT)
    try:
        out = _checks(data, model, workdir)
        torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _kw(backend):
    from repro_torch import runtime

    if backend == "acim":
        return {"cim": runtime.quiet_cim_config()}
    return {}


def _pair(y_b):
    y, b = y_b
    return y, list(b)


def _checks(data: int, model: int, workdir: str) -> dict:
    from repro_torch import runtime
    from repro_torch.core.kan_network_deploy import (
        kan_network_deploy_apply,
        place_deployed_kan,
    )
    from repro_torch.launch.mesh import make_local_mesh

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = make_local_mesh(data, model, device="cpu")
    out = {"runtime": {}, "notes": [], "tasks": inp["tasks"]}
    for name, dep in inp["bundles"].items():
        x = torch.from_numpy(inp["x"][name])
        placed = place_deployed_kan(dep, mesh)
        out[f"placed_cols/{name}"] = [lw["wb"].shape[-1]
                                      for lw in placed.layers]
        for be in BACKENDS:
            kw = _kw(be)
            out["runtime"][(name, be, "plain")] = _pair(
                kan_network_deploy_apply(dep, x, backend=be,
                                         return_intermediates=True, **kw))
            out["runtime"][(name, be, "mesh")] = _pair(
                kan_network_deploy_apply(dep, x, backend=be, mesh=mesh,
                                         return_intermediates=True, **kw))
            out["runtime"][(name, be, "placed")] = _pair(
                kan_network_deploy_apply(placed, x, backend=be,
                                         return_intermediates=True, **kw))
    out["notes"] = sorted({n for v in runtime.shard_notes().values()
                           for n in v})
    for task in inp["tasks"]:
        out[task] = TASKS[task](mesh, inp)
    return out


def _plumbing(mesh, inp) -> dict:
    """Mesh precedence and plan-cache keying (the mesh's "model" submesh
    stands in for a second mesh)."""
    from repro_torch import runtime
    from repro_torch.core.kan_network_deploy import (
        kan_network_deploy_apply,
        place_deployed_kan,
    )

    sub = mesh["model"]
    dep = inp["bundles"]["kan1"]
    placed = place_deployed_kan(dep, mesh)
    res = {
        "arg_beats_placement": runtime.resolve_mesh(sub, placed.placement)
        is sub,
        "placement_alone": runtime.resolve_mesh(None, placed.placement)
        is mesh,
        "none": runtime.resolve_mesh(None, None) is None,
        "replan_keeps_placement": placed.replan(64).placement is mesh,
    }
    with runtime.use_mesh(sub):
        res["scope_beats_placement"] = runtime.resolve_mesh(
            None, placed.placement) is sub
        res["arg_beats_scope"] = runtime.resolve_mesh(mesh, None) is mesh
        with runtime.use_mesh(None):
            res["none_passes_through"] = runtime.resolve_mesh() is sub
    x = torch.from_numpy(inp["x"]["kan1"][:5])
    runtime.reset_cache()
    kan_network_deploy_apply(dep, x)
    kan_network_deploy_apply(dep, x, mesh=mesh)
    res["stats_first"] = runtime.cache_stats()
    kan_network_deploy_apply(dep, x)
    kan_network_deploy_apply(dep, x, mesh=mesh)
    res["stats_second"] = runtime.cache_stats()
    return res


def _acim_noise(mesh, inp) -> dict:
    """Noisy acim (default config) under one seed, twice, and another
    seed."""
    from repro_torch.core.kan_network_deploy import kan_network_deploy_apply

    dep = inp["bundles"]["kan1"]
    x = torch.from_numpy(inp["x"]["kan1"])

    def run(seed):
        return kan_network_deploy_apply(
            dep, x, backend="acim", mesh=mesh,
            generator=torch.Generator().manual_seed(seed))

    return {"a": run(5), "b": run(5), "c": run(6)}


def _grad_sync(mesh, inp) -> dict:
    """compressed_grad_sync of per-data-rank gradients (numpy, seeded by
    the data index) with a nonzero carried error."""
    from repro_torch.dist.compress import compressed_grad_sync
    from repro_torch.runtime.meshexec import mesh_index

    d = mesh_index(mesh, "data")
    grads = {k: torch.from_numpy(v[d]) for k, v in inp["grads"].items()}
    ef = {k: torch.from_numpy(v[d]) for k, v in inp["errors"].items()}
    synced, new_ef = compressed_grad_sync(grads, ef, mesh)
    return {"synced": synced, "new_ef": new_ef}


def _compress(mesh, inp) -> dict:
    """Compress a placed bundle, decompress it onto the mesh and run it."""
    from repro_torch.core.kan_network_deploy import (
        kan_network_deploy_apply,
        place_deployed_kan,
    )
    from repro_torch.dist.compress import (
        compress_deployed_kan,
        decompress_deployed_kan,
    )

    dep = inp["bundles"]["kan1"]
    payload = compress_deployed_kan(place_deployed_kan(dep, mesh))
    dep2 = decompress_deployed_kan(payload, dep, mesh=mesh)
    x = torch.from_numpy(inp["x"]["kan1"])
    mismatch = None
    try:
        other = inp["bundles"]["ffn"]
        decompress_deployed_kan(payload, other)
    except ValueError as e:
        mismatch = str(e)
    return {
        "payload": payload,
        "placed_on_mesh": dep2.placement is mesh,
        "y0": kan_network_deploy_apply(dep, x),
        "y1": kan_network_deploy_apply(dep2, x),
        "mismatch": mismatch,
    }


def smoke_engine(arch: str, kan: bool, kw: dict, mesh=None):
    """One smoke engine of ``arch`` (its ``kan_variant()`` on the deployed
    KAN path when ``kan``), 2 slots unless ``kw`` names them, on ``mesh``;
    ``kw`` may also hold ``cfg`` (config fields to replace) and
    ``max_new``.  Returns (engine, max_new)."""
    import dataclasses

    from repro_torch.configs.registry import smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    kw = dict(kw)
    cfg = dataclasses.replace(smoke_config(arch), **kw.pop("cfg", {}))
    cfg = cfg.kan_variant() if kan else cfg
    max_new = kw.pop("max_new", 3)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = ServeEngine(params, cfg, **{"slots": 2, "max_len": 32, **kw},
                      kan_deploy=kan, mesh=mesh, device="cpu")
    return eng, max_new


def serve_streams(arch: str, kan: bool, kw: dict, prompts, mesh=None):
    """:func:`smoke_engine` serving ``prompts`` (rid = index); returns
    (engine, streams by rid).  The parent calls it without a mesh for the
    wanted streams."""
    from repro_torch.serve.engine import Request

    eng, max_new = smoke_engine(arch, kan, kw, mesh)
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    return eng, {r.rid: list(r.output) for r in eng.run(reqs)}


def _engine(mesh, inp) -> dict:
    """The smoke engines on the mesh, in each mode the parent asks for
    (``{mode: (arch, kan, engine kwargs)}``); returns the streams by rid,
    the layout, the collectives of the run and the pool stats."""
    from repro_torch import runtime
    from repro_torch.dist import comm

    out = {}
    eng = None
    for mode, (arch, kan, kw) in inp["engine_modes"].items():
        runtime.reset_cache()
        comm.reset_collectives()
        eng, out[mode] = serve_streams(arch, kan, kw, inp["prompts"], mesh)
        out[mode + "/collectives"] = dict(comm.COLLECTIVES)
        out[mode + "/layout"] = eng.mesh_layout()
        if eng.paged:
            for pool in eng.pools:
                pool.check_consistent()
            out[mode + "/kv"] = eng.kv_stats()
    return out


# the arrival offset of the clock task's future request (seconds)
ARRIVAL_S = 0.05


def clock_requests(prompts, max_new: int, deadline_s: float = 1e-3):
    """Two requests that fill the 2 slots, one behind them that must
    expire (``deadline_s``) and one arriving ``ARRIVAL_S`` after start, with
    the third prompt."""
    from repro_torch.serve.engine import Request

    return [Request(rid=0, prompt=list(prompts[0]), max_new_tokens=max_new),
            Request(rid=1, prompt=list(prompts[1]), max_new_tokens=max_new),
            Request(rid=2, prompt=list(prompts[2]), max_new_tokens=max_new,
                    deadline_s=deadline_s),
            Request(rid=3, prompt=list(prompts[2]), max_new_tokens=max_new,
                    arrival_s=ARRIVAL_S)]


def _clock(mesh, inp) -> dict:
    """A deadline and a future arrival on the wall clock: the scheduler
    decides them on rank 0's clock (its ``MeshClock``).  Returns the
    statuses, streams and completion order, the expiry count, the clock's
    reads and the collectives of the run, the admission instant of the
    future arrival and one ``MeshClock.now()``; then ``launch.serve --mesh
    ... --deadline 5`` on these ranks, its return and printed lines."""
    from repro_torch.dist import comm
    from repro_torch.launch import serve
    from repro_torch.serve.scheduler import MeshClock, Scheduler

    eng, max_new = smoke_engine("qwen2.5-14b", True, {}, mesh)
    now = MeshClock(mesh).now()
    comm.reset_collectives()
    sched = Scheduler(eng, trace=True)
    for r in clock_requests(inp["prompts"], max_new):
        sched.submit(r)
    done = sched.run_until_idle()
    admitted = {rec["rid"]: rec["t1"] for rec in sched.tracer.records()
                if rec["name"] == "queued"}
    out = {"clock": type(sched._clock).__name__, "now": now,
           "reads": sched._clock.reads,
           "collectives": dict(comm.COLLECTIVES),
           "order": [r.rid for r in done],
           "status": {r.rid: r.status for r in done},
           "streams": {r.rid: list(r.output) for r in done},
           "expired": sched.expired, "decode_steps": sched.decode_steps,
           "arrival_s": {r.rid: r.arrival_s for r in done},
           "admitted_s": admitted}
    spec = f"data={mesh.shape[0]},model={mesh.shape[1]}"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["cli_return"] = serve.main(
            ["--arch", "qwen2.5-14b", "--device", "cpu", "--mesh", spec,
             "--deadline", "5", "--requests", "4", "--max-new", "4"])
    out["cli_lines"] = buf.getvalue().splitlines()
    return out


def one_rank_trace(mesh=None) -> tuple:
    """A ManualClock workload, traced, on the float smoke qwen2.5-14b with
    one slot (``mesh`` or none): a request that keeps the slot for four
    tokens, one behind it that expires (0.5 s deadline) and one arriving
    at 3 s; the clock moves 0.25 s per emitted token, and no stream stops
    early (``eos_id=-1``).  Returns (sha256 of the JSONL trace, statuses
    by rid, the collectives of the run)."""
    from repro_torch.dist import comm
    from repro_torch.serve.engine import Request
    from repro_torch.serve.scheduler import ManualClock, Scheduler

    eng, _ = smoke_engine("qwen2.5-14b", False, {"slots": 1}, mesh)
    clock = ManualClock()
    comm.reset_collectives()
    sched = Scheduler(eng, clock=clock, trace=True)
    reqs = [Request(rid=0, prompt=[5, 6, 7, 8], max_new_tokens=4, eos_id=-1),
            Request(rid=1, prompt=[9, 10, 11], max_new_tokens=3, eos_id=-1,
                    deadline_s=0.5),
            Request(rid=2, prompt=[12, 13], max_new_tokens=3, eos_id=-1,
                    arrival_s=3.0)]
    for r in reqs:
        sched.submit(r, on_token=lambda r, t: clock.advance(0.25))
    sched.run_until_idle()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.jsonl")
        sched.tracer.export_jsonl(path)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    return (digest, {r.rid: r.status for r in sched.finished},
            dict(comm.COLLECTIVES))


def _one_rank(mesh, inp) -> dict:
    """No mesh and this 1x1 mesh: the ManualClock trace, and a wall-clock
    deadline and future arrival (:func:`clock_requests`) with the
    collectives of each run; no ``MeshClock`` is made."""
    from repro_torch.dist import comm
    from repro_torch.serve.scheduler import MeshClock, Scheduler

    out = {}
    for name, m in (("none", None), ("mesh", mesh)):
        out[name + "/trace"] = one_rank_trace(m)
        eng, max_new = smoke_engine("qwen2.5-14b", True, {}, m)
        comm.reset_collectives()
        sched = Scheduler(eng)
        for r in clock_requests(inp["prompts"], max_new):
            sched.submit(r)
        done = sched.run_until_idle()
        out[name + "/wall"] = {
            "mesh_clock": isinstance(sched._clock, MeshClock),
            "collectives": dict(comm.COLLECTIVES),
            "status": {r.rid: r.status for r in done},
            "streams": {r.rid: list(r.output) for r in done}}
    return out


TASKS = {"plumbing": _plumbing, "acim_noise": _acim_noise,
         "grad_sync": _grad_sync, "compress": _compress, "engine": _engine,
         "clock": _clock, "one_rank": _one_rank}


def reference_quantize(g: np.ndarray):
    """numpy reckoning of the int8 codec (``dist.compress._quantize``)."""
    g = np.asarray(g, np.float32)
    s = np.float32(max(np.abs(g).max(), np.float32(1e-30))) / np.float32(127)
    q = np.clip(np.round(g / s), -127, 127).astype(np.int8)
    return q, np.float32(s)
