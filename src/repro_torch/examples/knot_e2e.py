"""End-to-end knot-theory pipeline (the paper's fig. 13 application):

train KAN on the knot surrogate -> ASP-quantize -> evaluate on the
RRAM-ACIM simulator with KAN-SAM mapping -> report accuracy + hardware cost.

Port of ``examples/knot_e2e.py``; on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.knot_e2e [--fast] [--grid G]

The simulator's MAC is the plain ``cim_matmul`` in both packages (kernel
B4 serves ``kernels.cim_mac`` alone), so no kernel of the port runs here.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from ..core.asp_quant import ASPQuantSpec
from ..core.cim import CIMConfig
from ..core.costmodel import accelerator_cost, kan_accelerator
from ..core.kan_layer import KANSpec, param_count
from ..core.neurosim import evaluate_accuracy, evaluate_accuracy_cim, train_kan
from ..core.tmdv import TMDVConfig
from ..data.knot import make_knot_dataset
from ..device import resolve_device
from . import device_label, sync

__all__ = ["EXAMPLE_CIM", "cosine_schedule", "run", "main"]

# the example's RRAM-ACIM macro: 128-row arrays, 8-bit ADC, the measured
# IR-drop and partial-sum noise
EXAMPLE_CIM = CIMConfig(array_rows=128, adc_bits=8, ir_gamma=0.06,
                        sigma_ps_ref=0.05)


def cosine_schedule(steps: int):
    """The example's learning rate at optimizer step ``step`` (an int
    tensor): cosine from 1.5e-2 down to 1e-3 over 90% of ``steps``, then
    flat.  The divisor is an f32 tensor, so the quotient is IEEE on a card
    too (a host-scalar division there multiplies by the reciprocal)."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        span = torch.tensor(0.9 * steps, dtype=torch.float32,
                            device=step.device)
        t = torch.clamp(step.to(torch.float32) / span, max=1.0)
        return 1.5e-2 * 0.95 * (0.5 * (1 + torch.cos(math.pi * t))) + 1e-3
    return sched


def run(*, fast: bool = False, grid: int = 5, n: int | None = None,
        n_val: int = 2048, epochs: int | None = None, params=None,
        cim: CIMConfig = EXAMPLE_CIM, device=None, log=print) -> dict:
    """Train, evaluate in software and on the ACIM simulator (baseline
    placement and KAN-SAM), and cost the 22nm accelerator.

    ``n`` / ``epochs`` default to the example's (8192 / 60 with ``fast``,
    else 32768 / 250); ``params`` starts the training from carried weights
    (``epochs=0`` evaluates them as they are); ``cim`` replaces the
    example's macro (a ``deterministic`` one draws no noise).  Returns the
    trained ``params``, ``history``, ``sw_acc``, ``acim_acc`` (``baseline``
    and ``kan_sam``), the accelerator ``cost``, the schedule ``sched`` and
    its ``steps``, and ``seconds`` of each stage on the device.
    """
    dev = resolve_device(device)
    if n is None:
        n = 8192 if fast else 32768
    if epochs is None:
        epochs = 60 if fast else 250
    xt, yt, xv, yv = make_knot_dataset(n, n_val, seed=0, label_noise=0.04)
    kspec = KANSpec(dims=(17, 1, 14), grid_size=grid)
    where = device_label(dev)
    log(f"training KAN {kspec.dims} G={grid} ({param_count(kspec)} params) "
        f"on {n} samples on {where} ...")

    steps = epochs * max(1, n // 2048)
    sched = cosine_schedule(steps)
    seconds = {}
    if params is not None:
        params = [{k: v.to(dev) for k, v in p.items()} for p in params]
    sync(dev)
    t0 = time.perf_counter()
    params, hist = train_kan(kspec, xt, yt, xv, yv, epochs=epochs,
                             batch_size=2048, lr=sched,
                             params=params, verbose=True, device=dev)
    sync(dev)
    seconds["train"] = time.perf_counter() - t0
    sw = evaluate_accuracy(params, xv, yv, kspec)
    log(f"\nsoftware accuracy: {sw:.3f}")

    acim = {}
    t0 = time.perf_counter()
    for sam in (False, True):
        gen = torch.Generator(device=dev).manual_seed(7)
        acc = evaluate_accuracy_cim(params, xv, yv, kspec, cim, gen,
                                    use_sam=sam, calib_x=xt[:2048])
        acim["kan_sam" if sam else "baseline"] = acc
        log(f"ACIM accuracy ({'KAN-SAM' if sam else 'baseline map'}): "
            f"{acc:.3f}")
    sync(dev)
    seconds["acim"] = time.perf_counter() - t0

    spec = ASPQuantSpec(grid_size=grid, order=3, n_bits=8, lut_bits=8,
                        lo=-1.0, hi=1.0)
    cost = accelerator_cost(
        kan_accelerator((17, 1, 14), spec, TMDVConfig(8, 4), 128, adc_bits=8))
    log(f"\n22nm accelerator: {cost['area_mm2']*1e3:.1f} x1e-3 mm^2, "
        f"{cost['energy_pj']:.0f} pJ/inference, {cost['latency_ns']:.0f} ns")
    log(f"seconds on {where}: training {seconds['train']:.2f}, "
        f"ACIM evaluation {seconds['acim']:.2f}")
    return {"kspec": kspec, "params": params, "history": hist, "sw_acc": sw,
            "acim_acc": acim, "cost": cost, "sched": sched, "steps": steps,
            "seconds": seconds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.knot_e2e")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--grid", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    run(fast=args.fast, grid=args.grid, device=args.device)


if __name__ == "__main__":
    main()
