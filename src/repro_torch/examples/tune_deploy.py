"""End-to-end co-design tuning: search -> tile tune -> artifact -> deploy.

Runs the full ``repro_torch.tune`` flow on the paper's KAN1 knot task:

  1. train the base network once, Pareto-search the design space under a
     KAN1-like hardware budget (cost model + acim-backend accuracy: kernel
     B1 with its noise operand on a card);
  2. pick an operating point off the front, deploy it, and tile-tune
     kernel B1 for its geometry (timed on a card, the cost proxy on the
     CPU);
  3. dump a versioned tuning artifact, then RELOAD it into a cold runtime
     (caches cleared) and verify the deployment reproduces bit-identically
     — the file, not the search, is the deployment input from here on.

Port of ``examples/tune_deploy.py``; on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.tune_deploy [--smoke] \\
        [--out X.json] [--device cpu]

Exit status is non-zero if the search returns an empty front or the
reloaded deployment mismatches.  To serve an LM on the tuned point:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --kan-ffn --tuned-config TUNE_artifact.json
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import runtime, tune
from ..core.kan_network_deploy import kan_network_deploy_apply
from ..core.neurosim import HardwareConstraints
from ..device import resolve_device
from . import device_label, sync

__all__ = ["HC", "run", "check_reload", "main"]

HC = HardwareConstraints(max_area_mm2=0.02, max_energy_pj=300,
                         max_latency_ns=900)


def _err(msg: str) -> None:
    print(f"ERROR: {msg}", file=sys.stderr)


def check_reload(path: str, task, chosen, tile, x_probe, y_tuned,
                 log=print) -> int:
    """Step 3's second half: reset the runtime, reload the artifact at
    ``path``, redeploy its point and run the probe again.  0 when the
    candidate, the tile plan and the probe's outputs all come back
    unchanged, else 1."""
    runtime.reset_cache()  # cold runtime: the file is all we have
    loaded = tune.load_tuning_artifact(path)
    resolved = tune.apply_tuning_artifact(loaded)
    cand2 = resolved["candidate"]
    if cand2 != chosen.candidate:
        _err("reloaded candidate differs")
        return 1
    if resolved["plan"] != tile.chosen_plan:
        _err("reloaded plan differs")
        return 1
    _, _, dep2 = tune.deploy_candidate(task, cand2)
    with torch.no_grad():
        y_reloaded = kan_network_deploy_apply(dep2, x_probe).cpu().numpy()
    if not np.array_equal(y_tuned, y_reloaded):
        _err("reloaded deployment is not bit-identical")
        return 1
    log("artifact round trip OK: reloaded deployment is bit-identical")
    return 0


def run(*, smoke: bool = False, out: str = "TUNE_artifact.json",
        seed: int = 0, n_train: int | None = None, n_val: int | None = None,
        epochs: int | None = None, budget: int | None = None,
        n_init: int | None = None, device=None, log=print) -> dict:
    """The whole flow.  The task sizes and the search budget default to
    the example's (``smoke``: 4096 / 512 rows, 60 epochs, 10 evaluations
    from 4; else 8192 / 1024, 120 epochs, 32 from 8); ``smoke`` also
    narrows the design space to G in {3, 5, 8} and the tile sweep to 6
    candidates (else ``DesignSpace()`` and 16).  Returns ``status`` (the exit status), and where the flow got
    that far the ``task``, the search ``result``, the ``chosen`` point,
    the ``tile`` result, the probe ``x_probe`` and its outputs
    ``y_tuned`` (numpy), and ``seconds`` of each stage."""
    dev = resolve_device(device)
    seconds = {}
    # -- 1. task + search -------------------------------------------------
    if smoke:
        sizes = dict(n_train=4096, n_val=512, epochs=60)
        space = tune.DesignSpace(grid_size=(3, 5, 8), voltage_bits=(3, 4, 5),
                                 array_rows=(128,))
        budget, n_init = budget or 10, n_init or 4
    else:
        sizes = dict(n_train=8192, n_val=1024, epochs=120)
        space = tune.DesignSpace()
        budget, n_init = budget or 32, n_init or 8
    for k, v in (("n_train", n_train), ("n_val", n_val), ("epochs", epochs)):
        if v is not None:
            sizes[k] = v
    where = device_label(dev)
    log(f"co-design flow on {where}")
    sync(dev)
    t0 = time.perf_counter()
    task = tune.make_knot_task(**sizes, seed=seed, device=dev)
    sync(dev)
    seconds["task"] = time.perf_counter() - t0
    cfg = tune.SearchConfig(budget=budget, n_init=n_init, seed=seed)
    t0 = time.perf_counter()
    result = tune.pareto_search(task, space, constraints=HC, config=cfg)
    sync(dev)
    seconds["search"] = time.perf_counter() - t0
    log(f"search: {result.n_evals} evals, {len(result.front)} Pareto "
        f"points (space {result.space_hash}, seed {result.seed})")
    if not result.front:
        _err("empty Pareto front")
        return {"status": 1, "task": task, "result": result,
                "seconds": seconds}
    base = result.baseline
    log(f"baseline: acc={base.metrics['accuracy']:.3f} "
        f"energy={base.metrics['energy_pj']:.0f} pJ")
    for p in result.front:
        c, m = p.candidate, p.metrics
        log(f"  front: G={c.grid_size} K={c.order} vb={c.voltage_bits} "
            f"sam={int(c.use_sam)} -> acc={m['accuracy']:.3f} "
            f"energy={m['energy_pj']:.0f} pJ area={m['area_mm2']:.4f} mm^2")
    dom = result.dominating_baseline(on=("energy_pj", "accuracy"))
    log(f"{len(dom)} front points dominate the un-searched default on "
        "(energy, accuracy)")

    # -- 2. choose + deploy + tile-tune ----------------------------------
    chosen = tune.select_point(result.front)
    log(f"chosen: {chosen.candidate}")
    _, _, dep = tune.deploy_candidate(task, chosen.candidate)
    t0 = time.perf_counter()
    tile = tune.tune_tiles(dep, max_candidates=6 if smoke else 16,
                           seed=seed)
    sync(dev)
    seconds["tiles"] = time.perf_counter() - t0
    log(f"tile tuner: mode={tile.mode}, {len(tile.trials)} trials, "
        f"plan source now: {'tuned' if tile.tuned else 'heuristic'}")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x_probe = torch.rand((64, task.dims[0]), generator=gen, device=dev) \
        * 2.0 - 1.0
    with torch.no_grad():
        y_tuned = kan_network_deploy_apply(dep, x_probe).cpu().numpy()

    # -- 3. artifact round trip ------------------------------------------
    art = tune.build_tuning_artifact(search=result, chosen=chosen, tile=tile,
                                     task=task.name)
    tune.save_tuning_artifact(out, art)
    log(f"wrote {out}")
    status = check_reload(out, task, chosen, tile, x_probe, y_tuned, log=log)
    log(f"seconds on {where}: task {seconds['task']:.2f}, search "
        f"{seconds['search']:.2f}, tiles {seconds['tiles']:.2f}")
    return {"status": status, "task": task, "result": result,
            "chosen": chosen, "tile": tile, "x_probe": x_probe,
            "y_tuned": y_tuned, "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.tune_deploy")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny budgets for CI: small task, few evals")
    ap.add_argument("--out", default="TUNE_artifact.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    return run(smoke=args.smoke, out=args.out, seed=args.seed,
               device=args.device)["status"]


if __name__ == "__main__":
    sys.exit(main())
