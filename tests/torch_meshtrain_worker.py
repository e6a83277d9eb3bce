"""Rank body of ``tests/test_torch_meshtrain.py``: one gloo rank of a CPU
training mesh; run as a script under ``torchrun``, one rank of a training
mesh of cards (:func:`cards`):

    PYTHONPATH=src torchrun --nproc-per-node 4 \
        tests/torch_meshtrain_worker.py --data 2 --model 2

Imports no JAX.  The parent writes ``workdir/inputs.pt`` (the tasks, the
checkpoint directories) and starts ``data * model`` ranks of :func:`main`
with a deadline; each rank saves what it read in ``workdir/out<rank>.pt``.
The parent calls the same run functions without a mesh for the unsharded
port's numbers.  Every rank starts its process group from a ``FileStore``
in ``workdir`` with a 60 s timeout.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

PG_TIMEOUT = datetime.timedelta(seconds=60)
SEQ = 16
BATCH = 4
QUIET = lambda *_: None  # noqa: E731


def main(rank: int, world: int, data: int, model: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world, timeout=PG_TIMEOUT)
    try:
        from repro_torch.launch.mesh import make_local_mesh

        inp = torch.load(os.path.join(workdir, "inputs.pt"),
                         weights_only=False)
        mesh = make_local_mesh(data, model, device="cpu")
        out = {t: TASKS[t](mesh, inp) for t in inp["tasks"]}
        torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def qwen_cfg(**kw):
    """The smoke qwen2.5-14b ``kan_variant()`` with remat and two
    microbatches (the smoke config turns both off)."""
    from repro_torch.configs import smoke_config

    cfg = smoke_config("qwen2.5-14b").kan_variant()
    return dataclasses.replace(cfg, **{"remat": True, "microbatch": 2, **kw})


def data_cfg(cfg, global_batch: int = BATCH):
    from repro_torch.data.lm_data import DataConfig

    return DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=global_batch)


def shardings(cfg, mesh) -> dict:
    """The loop's shardings: the state as ``state_pspecs`` lays it out,
    the rows of the batch on "data"."""
    from repro_torch.dist.sharding import PSpec, to_shardings
    from repro_torch.train.train_state import meta_state, state_pspecs

    rows = PSpec("data", None)
    return {"state": to_shardings(state_pspecs(meta_state(cfg), mesh), mesh),
            "batch": to_shardings({"tokens": rows, "targets": rows}, mesh)}


def make_loop(cfg, ckpt_dir, mesh=None, global_batch=BATCH, **kw):
    from repro_torch.train.loop import TrainLoop

    return TrainLoop(cfg, data_cfg(cfg, global_batch), ckpt_dir,
                     shardings=None if mesh is None else shardings(cfg, mesh),
                     device="cpu", **kw)


def gathered(state, state_shardings=None) -> list:
    """The whole leaves of a (sharded) state, in checkpoint order."""
    from repro_torch.dist.sharding import gather_tensor
    from repro_torch.train.checkpoint import flatten_shardings, flatten

    leaves = flatten(state)
    if state_shardings is None:
        return [t.clone() for t in leaves]
    return [gather_tensor(t, sh) for t, sh in
            zip(leaves, flatten_shardings(state_shardings))]


def counters(state) -> tuple:
    return (int(state["step"]), int(state["good_steps"]),
            int(state["skipped_steps"]))


def _train(mesh, inp) -> dict:
    """The loop from the reference's step_0 checkpoint, 3 steps (a
    checkpoint every ``ckpt_every``)."""
    from repro_torch.dist import comm

    cfg = qwen_cfg()
    comm.reset_collectives()
    loop = make_loop(cfg, inp["ckpt"], mesh,
                     ckpt_every=inp.get("ckpt_every", 100))
    hist = loop.run(3, log=QUIET)
    coll = dict(comm.COLLECTIVES)
    return {"start": loop.start_step, "hist": hist,
            "state": gathered(loop.state, loop.shardings["state"]),
            "counters": counters(loop.state), "collectives": coll}


def _restore(mesh, inp) -> dict:
    """A new loop on this mesh resuming from another mesh's checkpoint:
    the restored tree, gathered."""
    loop = make_loop(qwen_cfg(), inp["restore_dir"], mesh)
    return {"start": loop.start_step,
            "state": gathered(loop.state, loop.shardings["state"])}


def nan_batch(cfg, poisoned_rows) -> dict:
    """Step 0's batch with a loss mask of ones, NaN in ``poisoned_rows``."""
    from repro_torch.data.lm_data import global_batch_at_step

    batch = global_batch_at_step(data_cfg(cfg), 0)
    mask = np.ones(batch["tokens"].shape, np.float32)
    mask[list(poisoned_rows), 0] = np.nan
    return {**batch, "loss_mask": mask}


def faulty_step(step_fn, state, state_shardings, microbatch_spec, batch,
                microbatch: int) -> dict:
    """One step on this rank's rows of a whole ``batch`` that holds a
    non-finite value: whether this rank's rows held one, ``ok``, the
    counters, and whether the gathered state stayed as it was."""
    from repro_torch.train.train_state import local_rows

    local = local_rows(batch, microbatch, microbatch_spec)
    finite = all(bool(np.isfinite(v).all()) for v in local.values())
    before = gathered(state, state_shardings)
    _, m = step_fn(state, {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in local.items()})
    after = gathered(state, state_shardings)
    return {"ok": bool(m["ok"]), "counters": counters(state),
            "my_rows_finite": finite,
            "unchanged": all(torch.equal(a, b) for a, b in zip(before, after))}


def _nan(mesh, inp) -> dict:
    """One step on a batch whose NaN lies in one data rank's rows of the
    loss mask (whose count every rank divides by)."""
    cfg = qwen_cfg()
    loop = make_loop(cfg, inp["ckpt0"], mesh)
    return faulty_step(loop.step_fn, loop.state, loop.shardings["state"],
                       loop.microbatch_spec,
                       nan_batch(cfg, inp["poisoned_rows"]), cfg.microbatch)


def _inf_patches(mesh, inp) -> dict:
    """One pixtral step whose fault reaches one data rank's loss and
    gradients alone: +inf in the stub patch embeddings of the poisoned
    rows (no loss mask: every other rank's loss and gradients are
    finite until they are summed over "data")."""
    from repro_torch.train.train_state import make_train_step

    cfg = family_cfg("pixtral-12b", False)
    state, sh, spec = family_state(cfg, mesh)
    batch = family_batch(cfg, 0)
    batch["patch_embeds"][list(inp["poisoned_rows"])] = np.inf
    return faulty_step(make_train_step(cfg, microbatch_spec=spec), state, sh,
                       spec, batch, cfg.microbatch)


class PeakBytes(TorchDispatchMode):
    """The most bytes of tensor storage alive at once while the mode is on,
    read after every op (storages made before it count once they are an
    op's output; meta tensors hold none)."""

    def __init__(self):
        super().__init__()
        self.refs: dict = {}
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.multiprocessing.reductions import StorageWeakRef
        from torch.utils._pytree import tree_leaves

        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                st = t.untyped_storage()
                old = self.refs.get(st.data_ptr())
                if old is None or old[0].expired():
                    self.refs[st.data_ptr()] = (StorageWeakRef(st),
                                                st.nbytes())
        self.peak = max(self.peak, sum(n for ref, n in self.refs.values()
                                       if not ref.expired()))
        return out


def storage_bytes(state) -> int:
    """The bytes of the storages a state's tensors hold (each once)."""
    from repro_torch.train.checkpoint import flatten

    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in flatten(state)}.values())


def construction_bytes(mesh, ckpt_dir: str) -> dict:
    """The peak and the held bytes of building the qwen loop on this rank
    (``ckpt_dir`` empty: nothing is restored)."""
    peak = PeakBytes()
    with peak:
        loop = make_loop(qwen_cfg(), ckpt_dir, mesh)
    return {"peak": peak.peak, "held": storage_bytes(loop.state)}


def _memory(mesh, inp) -> dict:
    return construction_bytes(mesh, inp["empty"])


def _odd(mesh, inp) -> dict:
    """A global batch of 3 rows, which "data" does not divide, one step."""
    loop = make_loop(qwen_cfg(microbatch=0), inp["ckpt0"], mesh,
                     global_batch=3)
    hist = loop.run(1, log=QUIET)
    return {"hist": hist, "rows": tuple(loop.microbatch_spec.spec),
            "state": gathered(loop.state, loop.shardings["state"])}


def family_batch(cfg, step: int) -> dict:
    """Batch ``step`` of a family run: 4 rows of 16 tokens (and the stub
    patch embeddings of a vlm), from numpy under one seed."""
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(3, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(BATCH, cfg.num_patches, cfg.patch_embed_dim)).astype(
                np.float32)
    return batch


def family_cfg(arch: str, kan: bool):
    from repro_torch.configs import smoke_config

    cfg = smoke_config(arch)
    cfg = cfg.kan_variant() if kan else cfg
    return dataclasses.replace(cfg, remat=True, microbatch=2)


def family_state(cfg, mesh=None) -> tuple:
    """The state from seed 0 on the CPU (this rank's slabs on ``mesh``),
    its shardings and the microbatch layout (None, None unsharded)."""
    from repro_torch.dist.sharding import to_shardings
    from repro_torch.train.train_state import (
        init_state,
        meta_state,
        microbatch_pspec,
        state_pspecs,
    )

    state = init_state(torch.Generator().manual_seed(0), cfg, device="cpu",
                       mesh=mesh)
    if mesh is None:
        return state, None, None
    return (state,
            to_shardings(state_pspecs(meta_state(cfg), mesh), mesh),
            to_shardings(microbatch_pspec(mesh, BATCH, cfg.microbatch),
                         mesh))


def family_run(arch: str, kan: bool, mesh=None, steps: int = 2,
               grads_of=None) -> dict:
    """``steps`` train steps of ``arch``'s smoke config (remat, two
    microbatches) from seed 0, through ``make_train_step`` (the loop's
    stream has no stub embeddings), on ``mesh`` or unsharded;
    ``grads_of(params, batch, cfg)`` is called on the unsharded state
    before each step."""
    from repro_torch.dist import comm
    from repro_torch.train.train_state import local_rows, make_train_step

    cfg = family_cfg(arch, kan)
    state, sh, spec = family_state(cfg, mesh)
    step_fn = make_train_step(cfg, microbatch_spec=spec)
    comm.reset_collectives()
    hist = []
    for i in range(steps):
        batch = family_batch(cfg, i)
        if grads_of is not None:
            grads_of(state["params"], batch, cfg)
        local = local_rows(batch, cfg.microbatch, spec)
        state, m = step_fn(state, {k: torch.from_numpy(np.ascontiguousarray(
            v)) for k, v in local.items()})
        hist.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "ok": bool(m["ok"])})
    return {"hist": hist, "state": gathered(state, sh),
            "collectives": dict(comm.COLLECTIVES)}


def _families(mesh, inp) -> dict:
    return {f"{arch}{'-kan' if kan else ''}": family_run(arch, kan, mesh)
            for arch, kan in inp["families"]}


def _collectives(mesh, inp) -> dict:
    """f, g and the gather of ``dist.comm`` on the "model" group: values
    and gradients, and the collectives they count."""
    from repro_torch.dist import comm

    group = mesh.get_group("model")
    r = comm.group_rank(group)
    n = comm.group_size(group)
    out = {}
    comm.reset_collectives()
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    y = comm.tp_copy(x, group)
    (gx,) = torch.autograd.grad((y * (r + 1)).sum(), x)
    out["copy"] = (torch.equal(y, x), gx)
    z = comm.tp_reduce(x * (r + 1), group)
    (gz,) = torch.autograd.grad(z.sum(), x)
    out["reduce"] = (z.detach(), gz)
    w = comm.tp_gather(x + 10 * r, group, -1)
    (gw,) = torch.autograd.grad((w * torch.arange(3.0 * n)).sum(), x)
    out["gather"] = (w.detach(), gw)
    with torch.no_grad():
        before = dict(comm.COLLECTIVES)
        comm.tp_copy(x, group)
        comm.tp_reduce(x, group)
        comm.tp_gather(x, group, 0)
        out["no_grad_extra"] = {k: v - before.get(k, 0)
                                for k, v in comm.COLLECTIVES.items()}
    out["counts"] = before
    out["rank"], out["size"] = r, n
    return out


TASKS = {"train": _train, "restore": _restore, "nan": _nan,
         "inf_patches": _inf_patches, "odd": _odd, "memory": _memory,
         "families": _families, "collectives": _collectives}


def cards(argv=None) -> None:
    """One rank of ``torchrun``: phase 9's training cell of
    ``chip_smoke.py`` (the full-width ``qwen2.5-14b`` ``kan_variant()`` cut
    to ``--layers`` layers, 16 x 256 tokens a step) through
    ``TrainLoop(shardings=)`` on a ``--data`` x ``--model`` mesh of cards.
    Rank 0 prints the losses, grad norms, s/step, collectives per step and
    the peak memory of every rank, as one JSON line."""
    import argparse
    import json
    import statistics
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import DataConfig
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.loop import TrainLoop

    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config instead (a rehearsal on the CPU "
                         "with --device cpu)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_local_mesh(args.data, args.model, device=args.device)
    cfg = qwen_cfg() if args.smoke else dataclasses.replace(
        get_config("qwen2.5-14b"), num_layers=args.layers).kan_variant()
    d = DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=16)
    on_card = mesh.device_type == "cuda"
    with tempfile.TemporaryDirectory() as ck:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        loop = TrainLoop(cfg, d, ck, ckpt_every=10 ** 9,
                         shardings=shardings(cfg, mesh), device=args.device)
        comm.reset_collectives()
        hist = loop.run(args.steps, log=QUIET)
        coll = {k: v / args.steps for k, v in comm.COLLECTIVES.items()}
    peak = torch.tensor([torch.cuda.max_memory_allocated() if on_card
                         else 0], device=loop.device)
    peaks = comm.all_gather(peak, dist.group.WORLD, 0).tolist()
    if dist.get_rank() == 0:
        times = [m["time_s"] for m in hist]
        print(json.dumps({
            "mesh": [args.data, args.model],
            "device": (torch.cuda.get_device_name(loop.device) if on_card
                       else "cpu"),
            "losses": [m["loss"] for m in hist],
            "grad_norms": [m["grad_norm"] for m in hist],
            "time_s": times, "s_per_step": statistics.median(times[1:]),
            "collectives_per_step": coll, "peak_bytes": peaks}))
    dist.destroy_process_group()


if __name__ == "__main__":
    cards()
