"""Training entry point: the LM train loop on one device.

Port of ``repro.launch.train``.  Runs on the card unless ``--device cpu``:

    # the smoke-size config on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
        --smoke --kan-ffn --steps 20 --device cpu
    # the published widths, depth cut to 4 layers, on the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
        --full-width-layers 4 --kan-ffn --steps 6 --seq-len 256 \\
        --global-batch 16

Weights are random, drawn from seed 0; the data is the seekable synthetic
stream of ``data.lm_data``.  The fault-tolerance machinery (checkpoint /
restart from ``--ckpt-dir``, NaN guards, straggler watchdog, SIGTERM-safe
preemption) is active either way.  ``--smoke`` trains the arch's
smoke-size config without microbatches; ``--full-width-layers N`` its
published config (its own ``microbatch`` and ``remat``) cut to N layers.
The audio / vlm families exit: the stream has no stub embeddings for
them (the reference raises ``KeyError`` there).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from ..configs.registry import get_config, smoke_config
from ..data.lm_data import DataConfig
from ..device import resolve_device
from ..models.model import tokens_only_refusal
from ..train.loop import TrainLoop


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", action="store_true",
                      help="the arch's reduced config")
    size.add_argument("--full-width-layers", type=int, default=None,
                      metavar="N",
                      help="the arch at its published widths with its depth "
                           "cut to N layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--kan-ffn", action="store_true",
                    help="swap in the paper's KAN-FFN")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns the loop and its per-step history."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.full_width_layers is not None:
        cfg = dataclasses.replace(get_config(args.arch),
                                  num_layers=args.full_width_layers)
    else:
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.kan_ffn:
        cfg = cfg.kan_variant()
    if args.smoke:
        cfg = dataclasses.replace(cfg, microbatch=0)
    refusal = tokens_only_refusal(cfg, "the lm_data training stream")
    if refusal:
        raise SystemExit(refusal)

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    loop = TrainLoop(cfg, dcfg, args.ckpt_dir, ckpt_every=args.ckpt_every,
                     device=dev)
    loop.install_sigterm_handler()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} device={name} start_step={loop.start_step}")
    hist = loop.run(args.steps)
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; "
              f"stragglers={loop.watchdog.straggler_steps}")
    return loop, hist


if __name__ == "__main__":
    main()
