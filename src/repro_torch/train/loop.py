"""Training loop: the train step, checkpoint/restart, straggler watchdog.

Port of ``repro.train.loop`` on one device (the card unless
``device="cpu"``):

  * checkpoint/restart: atomic keep-N checkpoints (``checkpoint.py``);
    the loop restores the latest one at construction and resumes at its
    step, which is also the data step (the pipeline is seekable);
  * NaN/Inf step rejection inside the step (``train_state.py``);
  * straggler watchdog: steps longer than ``deadline_factor`` x the
    rolling median step time are logged and counted;
  * graceful preemption: SIGTERM sets a flag; the loop checkpoints and
    exits at the next step boundary.

The host waits for the device once per step, to read the loss (the
reference's sync point); the batch goes up through pinned memory without
a wait.  Restoring under other shardings (``shardings=``) waits for
ROADMAP A10b.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Callable

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..data.lm_data import DataConfig, global_batch_at_step
from ..device import resolve_device
from .checkpoint import Checkpointer
from .train_state import init_state, make_train_step

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
        if shardings is not None:
            raise NotImplementedError(
                "sharded training is not ported yet (ROADMAP A10b: "
                "distributed training)")
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        self.ckpt = Checkpointer(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.watchdog = StepWatchdog()
        self._stop = threading.Event()

        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_state(gen, cfg, device=self.device)
        restored, step = self.ckpt.restore_latest(self.state)
        if restored is not None:
            self.state = restored
            self.start_step = int(step)
        else:
            self.start_step = 0
        self.step_fn = make_train_step(cfg)

    def install_sigterm_handler(self):
        # the handler holds the stop event alone: a handler that closed
        # over the loop would keep its parameters and optimizer state
        # alive for the rest of the process
        stop = self._stop
        signal.signal(signal.SIGTERM, lambda *_: stop.set())

    def run(self, num_steps: int, log_every: int = 10, log: Callable = print):
        metrics_hist = []
        for step in range(self.start_step, self.start_step + num_steps):
            if self._stop.is_set():
                log(f"[preempt] checkpointing at step {step} and exiting")
                self.ckpt.save(step, self.state, blocking=True)
                break
            batch = batch_to_device(global_batch_at_step(self.data_cfg, step),
                                    self.device)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])  # blocks; also the sync point
            dt = time.perf_counter() - t0
            if self.watchdog.observe(dt):
                log(f"[straggler] step {step} took {dt:.3f}s "
                    f"(median {np.median(self.watchdog.durations[-32:]):.3f}s)")
            metrics_hist.append({"step": step, "loss": loss, "time_s": dt})
            if step % log_every == 0:
                log(f"step {step}: loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, self.state)
        self.ckpt.wait()
        return metrics_hist
