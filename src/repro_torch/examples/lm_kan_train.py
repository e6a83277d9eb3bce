"""Train a small LM with KAN-FFN layers end-to-end through the production
TrainLoop (checkpointing, NaN guards, straggler watchdog, restart).

Port of ``examples/lm_kan_train.py``; on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.lm_kan_train \\
        [--steps 60] [--arch qwen2.5-14b] [--device cpu]

The train step attends on the "ref" backend and runs the float KAN-FFN
(kernel B2 has no backward), so no kernel of the port runs here.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

from ..configs.registry import smoke_config
from ..data.lm_data import DataConfig
from ..device import resolve_device
from ..train.loop import TrainLoop
from ..train.optimizer import tree_map
from . import device_label, sync

__all__ = ["example_config", "run", "main"]


def example_config(arch: str = "qwen2.5-14b"):
    """The arch's smoke config with the KAN-FFN at grid 8, 2 layers deep,
    learning rate 3e-3."""
    return dataclasses.replace(smoke_config(arch).kan_variant(grid=8),
                               num_layers=2, learning_rate=3e-3)


def run(*, steps: int = 60, arch: str = "qwen2.5-14b",
        restart_steps: int = 10, seq_len: int = 64,
        global_batch: int = 8, ckpt_every: int = 20,
        ckpt_dir: str | None = None, lm_params=None, device=None,
        log=print) -> dict:
    """Train ``steps`` steps, then build a second loop on the same
    checkpoint directory (it resumes from the last checkpoint) and train
    ``restart_steps`` more.

    ``lm_params`` (a parameter tree, e.g. from ``convert.
    lm_params_from_numpy``) replaces the first loop's drawn parameters when
    it starts from step 0.  ``ckpt_dir`` defaults to a fresh temporary
    directory.  Returns the ``cfg``, both loops' histories (``hist``,
    ``hist2``), the second loop's ``start_step``, the ``ckpt_dir``, the
    flagged ``stragglers``, the two ``loops`` and ``seconds`` of each run.
    """
    dev = resolve_device(device)
    cfg = example_config(arch)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch)
    if ckpt_dir is None:
        ckpt_dir = tempfile.mkdtemp(prefix="kan_lm_ckpt_")
    where = device_label(dev)
    log(f"arch={cfg.name} steps={steps} ckpt={ckpt_dir} on {where}")

    loop = TrainLoop(cfg, dcfg, ckpt_dir, ckpt_every=ckpt_every, device=dev)
    if lm_params is not None and loop.start_step == 0:
        loop.state["params"] = tree_map(lambda t: t.to(dev), lm_params)
    loop.install_sigterm_handler()
    seconds = {}
    sync(dev)
    t0 = time.perf_counter()
    hist = loop.run(steps, log_every=10, log=log)
    sync(dev)
    seconds["train"] = time.perf_counter() - t0
    log(f"\nloss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} over "
        f"{len(hist)} steps; stragglers flagged: "
        f"{loop.watchdog.straggler_steps}")

    # demonstrate restart: a second loop resumes from the checkpoint
    loop2 = TrainLoop(cfg, dcfg, ckpt_dir, ckpt_every=ckpt_every, device=dev)
    log(f"restart resumes at step {loop2.start_step}")
    t0 = time.perf_counter()
    hist2 = loop2.run(restart_steps, log_every=5, log=log)
    sync(dev)
    seconds["restart"] = time.perf_counter() - t0
    log(f"seconds on {where}: {len(hist)} steps "
        f"{seconds['train']:.2f}, {len(hist2)} after the restart "
        f"{seconds['restart']:.2f}")
    return {"cfg": cfg, "hist": hist, "hist2": hist2,
            "start_step": loop2.start_step, "ckpt_dir": ckpt_dir,
            "stragglers": loop.watchdog.straggler_steps,
            "loops": (loop, loop2), "seconds": seconds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.lm_kan_train")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    run(steps=args.steps, arch=args.arch, device=args.device)


if __name__ == "__main__":
    main()
