"""Training loop: the train step, checkpoint/restart, straggler watchdog.

Port of ``repro.train.loop`` (the card unless ``device="cpu"``):

  * checkpoint/restart: atomic keep-N checkpoints (``checkpoint.py``);
    the loop restores the latest one at construction and resumes at its
    step, which is also the data step (the pipeline is seekable), under
    any mesh shape (the elastic re-shard on restore);
  * NaN/Inf step rejection inside the step (``train_state.py``);
  * straggler watchdog: steps longer than ``deadline_factor`` x the
    rolling median step time are logged and counted;
  * graceful preemption: SIGTERM sets a flag; the loop checkpoints and
    exits at the next step boundary.

The host waits for the device once per step, to read the loss (the
reference's sync point; the step's grad norm is read after it, outside
the step's time); the batch goes up through pinned memory without a
wait.

Sharded training (``shardings=``): as in the reference, ``{"state": ...,
"batch": ...}``, each a tree from ``dist.sharding.to_shardings``, whose
leaves (``MeshSharding``) carry the mesh they were bound to, so the dict
needs no third key.  The mesh is a ``DeviceMesh`` ("data", "model") over
every rank of the process group, one process per device (SPMD; e.g.
``launch.mesh.make_local_mesh``), and every rank builds the same loop.
``"state"`` must be the layout :func:`train_state.state_pspecs` gives
(the one the sharded step runs).  Each rank makes only its slabs of the
initial state (``train_state.init_state(mesh=)``: the seed's draws, each
layer cut as it is drawn), so a model trains whose whole state would not
fit on one device; ``"batch"`` puts the rows on "data" or not, and then
each rank uploads only its rows of each microbatch
(:func:`train_state.local_rows`).  Checkpoints are gathered whole and
written by rank 0, and a stop asked for on any rank (SIGTERM) stops every
rank at the same step boundary: the flag is summed over the ranks once
per step.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..data.lm_data import DataConfig, global_batch_at_step
from ..device import resolve_device
from ..dist import comm
from ..dist.sharding import PSpec, to_shardings
from .checkpoint import Checkpointer, flatten_shardings
from .train_state import (
    init_state,
    local_rows,
    make_train_step,
    meta_state,
    microbatch_pspec,
    state_pspecs,
)

__all__ = ["TrainLoop", "StepWatchdog"]


class StepWatchdog:
    """Flags steps that exceed deadline_factor x rolling-median duration."""

    def __init__(self, deadline_factor: float = 3.0, window: int = 32):
        self.deadline_factor = deadline_factor
        self.durations: list[float] = []
        self.window = window
        self.straggler_steps = 0

    def observe(self, dt: float) -> bool:
        hist = self.durations[-self.window:]
        is_straggler = bool(
            len(hist) >= 8 and dt > self.deadline_factor * float(np.median(hist))
        )
        self.durations.append(dt)
        if is_straggler:
            self.straggler_steps += 1
        return is_straggler


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """Host arrays -> device tensors; to the card through pinned memory,
    without waiting for the device."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = (t.pin_memory().to(device, non_blocking=True)
                  if device.type == "cuda" else t.to(device))
    return out


def _mesh_of(shardings):
    return flatten_shardings(shardings)[0].mesh


def _batch_rows_on_data(batch_shardings) -> bool:
    """Whether a batch's shardings put its rows (dim 0) on "data"."""
    return batch_shardings is not None and any(
        sh.spec.on(0, "data") for sh in flatten_shardings(batch_shardings))


class TrainLoop:
    def __init__(
        self,
        cfg: ModelConfig,
        data_cfg: DataConfig,
        ckpt_dir: str,
        seed: int = 0,
        keep: int = 3,
        ckpt_every: int = 50,
        shardings: dict | None = None,
        *,
        device=None,
    ):
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.ckpt = Checkpointer(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.watchdog = StepWatchdog()
        self.shardings = shardings
        self._stop = threading.Event()
        self.mesh = None if shardings is None else _mesh_of(
            shardings["state"])
        if self.mesh is not None:
            from ..launch.mesh import ensure_process_group

            self.device = ensure_process_group(device)
        else:
            self.device = resolve_device(device)

        state_sh, mb_spec = None, None
        if self.mesh is not None:
            state_sh = shardings["state"]
            want = to_shardings(state_pspecs(meta_state(cfg), self.mesh),
                                self.mesh)
            if want != state_sh:
                raise ValueError("shardings['state'] must be "
                                 "to_shardings(train_state.state_pspecs("
                                 "state, mesh), mesh): the layout the "
                                 "sharded step runs")
            spec = (microbatch_pspec(self.mesh, data_cfg.global_batch,
                                     cfg.microbatch)
                    if _batch_rows_on_data(shardings.get("batch"))
                    else PSpec(None, None))
            mb_spec = to_shardings(spec, self.mesh)
        self.state_shardings, self.microbatch_spec = state_sh, mb_spec
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_state(gen, cfg, device=self.device, mesh=self.mesh)
        restored, step = self.ckpt.restore_latest(self.state,
                                                  shardings=state_sh)
        if restored is not None:
            self.state = restored
            self.start_step = int(step)
        else:
            self.start_step = 0
        self.step_fn = make_train_step(cfg, microbatch_spec=mb_spec)

    def install_sigterm_handler(self):
        # the handler holds the stop event alone: a handler that closed
        # over the loop would keep its parameters and optimizer state
        # alive for the rest of the process
        stop = self._stop
        signal.signal(signal.SIGTERM, lambda *_: stop.set())

    def _stopping(self) -> bool:
        """The stop flag, summed over every rank of a sharded loop."""
        stop = self._stop.is_set()
        world = dist.group.WORLD if self.mesh is not None else None
        if comm.group_size(world) == 1:
            return stop
        flag = torch.full((1,), float(stop), device=self.device)
        return bool(comm.all_reduce_sum(flag, world).item() > 0)

    def _batch(self, step: int) -> dict:
        batch = global_batch_at_step(self.data_cfg, step)
        if self.microbatch_spec is not None:
            batch = {k: np.ascontiguousarray(v) for k, v in local_rows(
                batch, self.cfg.microbatch, self.microbatch_spec).items()}
        return batch_to_device(batch, self.device)

    def run(self, num_steps: int, log_every: int = 10, log: Callable = print):
        metrics_hist = []
        for step in range(self.start_step, self.start_step + num_steps):
            if self._stopping():
                log(f"[preempt] checkpointing at step {step} and exiting")
                self.ckpt.save(step, self.state, blocking=True,
                               shardings=self.state_shardings)
                break
            batch = self._batch(step)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])  # blocks; also the sync point
            dt = time.perf_counter() - t0
            if self.watchdog.observe(dt):
                log(f"[straggler] step {step} took {dt:.3f}s "
                    f"(median {np.median(self.watchdog.durations[-32:]):.3f}s)")
            metrics_hist.append({"step": step, "loss": loss, "time_s": dt,
                                 "grad_norm": float(metrics["grad_norm"])})
            if step % log_every == 0:
                log(f"step {step}: loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, self.state,
                               shardings=self.state_shardings)
        self.ckpt.wait()
        return metrics_hist
