"""KAN-NeuroSim hyperparameter search (paper §3.4, Fig. 9) via
``repro_torch.tune``.

step 1 — Pareto search over the design space under each hardware budget
         (cost model only: no task, no training);
step 2 — grid-extension training under the minimal budget, then the
         trained network's accuracy.

Port of ``examples/neurosim_search.py``; on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.neurosim_search [--fast]

Step 1 is pure Python; step 2 trains on the device.  No kernel of the
port runs here.
"""

from __future__ import annotations

import argparse
import time

from ..core.neurosim import (
    HardwareConstraints,
    evaluate_accuracy,
    grid_extension_train,
)
from ..data.knot import make_knot_dataset
from ..device import resolve_device
from ..tune import DesignSpace, SearchConfig, pareto_search
from . import device_label, sync

__all__ = ["BUDGETS", "SPACE", "run", "main"]

BUDGETS = {
    "minimal (KAN1-like)": HardwareConstraints(
        max_area_mm2=0.016, max_energy_pj=280, max_latency_ns=700),
    "moderate (KAN2-like)": HardwareConstraints(
        max_area_mm2=0.065, max_energy_pj=420, max_latency_ns=900),
}
# step 1's space: G and the TM-DV split (SAM is cost-free, so only
# meaningful with a task)
SPACE = DesignSpace(
    grid_size=(3, 5, 8, 12, 16, 24, 32, 48, 68),
    voltage_bits=(3, 4, 5),
    array_rows=(128,),
    use_sam=(False,),
)


def run(*, fast: bool = False, n: int | None = None,
        epochs_per_round: int | None = None, max_rounds: int | None = None,
        device=None, log=print) -> dict:
    """Both steps.  ``n`` / ``epochs_per_round`` / ``max_rounds`` default
    to the example's (8192 / 20 / 3 with ``fast``, else 16384 / 60 / 6).

    Returns ``searches`` (budget name -> ``SearchResult``), ``gmax``
    (budget name -> max feasible G, None when nothing is feasible), step
    2's ``extension`` (``grid_extension_train``'s dict), its
    ``accuracy`` and ``seconds`` of each step.
    """
    dev = resolve_device(device)
    dims = (17, 1, 14)
    seconds = {}
    searches, gmax = {}, {}
    t0 = time.perf_counter()
    for name, hc in BUDGETS.items():
        res = pareto_search(
            None, SPACE, constraints=hc, dims=dims,
            config=SearchConfig(budget=40, n_init=16, seed=0),
        )
        searches[name] = res
        feas = [p for p in res.evaluated if p.feasible]
        if not feas:
            gmax[name] = None
            log(f"[{name}] infeasible")
            continue
        gmax[name] = max(p.candidate.grid_size for p in feas)
        log(f"[{name}] step 1: {len(res.front)} Pareto points, "
            f"max feasible G = {gmax[name]}")
        for p in res.front[:4]:
            c, m = p.candidate, p.metrics
            log(f"    G={c.grid_size:>2} vb={c.voltage_bits} "
                f"area {m['area_mm2']:.4f} mm^2  {m['energy_pj']:.0f} pJ  "
                f"{m['latency_ns']:.0f} ns")
    seconds["search"] = time.perf_counter() - t0

    if n is None:
        n = 8192 if fast else 16384
    if epochs_per_round is None:
        epochs_per_round = 20 if fast else 60
    if max_rounds is None:
        max_rounds = 3 if fast else 6
    xt, yt, xv, yv = make_knot_dataset(n, 2048, seed=0, label_noise=0.04)
    hc = BUDGETS["minimal (KAN1-like)"]
    where = device_label(dev)
    log(f"\nstep 2: grid-extension training under the minimal budget on "
        f"{where}")
    sync(dev)
    t0 = time.perf_counter()
    out = grid_extension_train(
        dims, hc, xt, yt, xv, yv,
        g_init=3, extend_by=2,
        epochs_per_round=epochs_per_round,
        max_rounds=max_rounds, device=dev,
    )
    sync(dev)
    seconds["extension"] = time.perf_counter() - t0
    log("extension log:", out["log"])
    acc = evaluate_accuracy(out["params"], xv, yv, out["kspec"])
    log(f"final: G={out['G']} accuracy={acc:.3f} "
        f"cost: {out['cost']['area_mm2']:.4f} mm^2 "
        f"{out['cost']['energy_pj']:.0f} pJ {out['cost']['latency_ns']:.0f} ns")
    log(f"seconds: search {seconds['search']:.2f} (host), grid extension "
        f"{seconds['extension']:.2f} on {where}")
    return {"searches": searches, "gmax": gmax, "extension": out,
            "accuracy": acc, "seconds": seconds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.neurosim_search")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    run(fast=args.fast, device=args.device)


if __name__ == "__main__":
    main()
