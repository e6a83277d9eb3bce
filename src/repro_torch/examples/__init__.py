"""The repository's six examples as modules of the port.

Each module twins one file of ``examples/`` and keeps its flags, its
defaults and its exit status, with ``--device`` added (the card unless
``--device cpu``; without a card and without ``--device cpu`` it raises):

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.knot_e2e --fast
    PYTHONPATH=src python -m repro_torch.examples.neurosim_search --fast
    PYTHONPATH=src python -m repro_torch.examples.tune_deploy --smoke
    PYTHONPATH=src python -m repro_torch.examples.lm_kan_train
    PYTHONPATH=src python -m repro_torch.examples.serve_demo

``main(argv=None)`` parses the flags and calls one function, ``run``, that
takes the sizes as keywords, accepts carried weights (``params=`` /
``lm_params=``, as ``repro_torch.convert`` builds them) and returns the
example's numbers in a dict.  Every time an example prints was taken on
the device it names (:func:`device_label`).
"""

from __future__ import annotations

import subprocess

import torch

__all__ = ["device_label", "sync"]


def device_label(dev: torch.device) -> str:
    """``cpu``, or the card's name with ``nvidia-smi``'s name and power
    limit (a card may run below its maximum power)."""
    if dev.type != "cuda":
        return str(dev)
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30)
        smi = proc.stdout.strip() if proc.returncode == 0 \
            else f"failed: {proc.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"failed: {e}"
    return f"{torch.cuda.get_device_name(dev)} (nvidia-smi: {smi})"


def sync(dev: torch.device) -> None:
    """Wait for the device, so a host clock read after it times the work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
