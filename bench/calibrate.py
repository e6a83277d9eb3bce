"""Readings that the limits of ``bench/checks/<cell>.json`` are set from.

    python bench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--fault NAME --fault-seeds 4 5 6] \
        [--seconds S] [--out FILE]

In one process (set-up is long), runs the cell on each seed with a short
window at the cell's own load and prints, per seed, each number the check
compares (the program's reading, the lower side of a limit); on the
control seeds it also prints the controls' readings on the same answers
(the reference one precision step below the configuration's, put in the
program's place: the upper side).  On the fault seeds it runs the cell
again with the fault ``NAME`` of ``benchlib.faults`` planted and prints
what the check reads then.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent / "src"), str(BENCH)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=())
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchlib import faults
    from benchlib.harness import run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    runs = [(seed, None) for seed in args.seeds]
    runs += [(seed, f) for f in args.fault for seed in args.fault_seeds]
    rows = []
    for seed, fault in runs:
        t = time.perf_counter()
        plant, undo = faults.plant(fault) if fault else (None, lambda: None)
        try:
            out = run_cell(args.workload, seed, args.seconds, False, "cuda",
                           plant=plant,
                           control=not fault and seed in args.control_seeds)
        finally:
            undo()
        row = {"workload": args.workload, "seed": seed, "fault": fault,
               "correct": out["correct"],
               "program": {k: c["value"] for k, c in out["checks"].items()},
               "limits": {k: c["limit"] for k, c in out["checks"].items()},
               "judged": out["judged"], "control": out.get("control"),
               "metrics": {k: m["value"] for k, m in out["metrics"].items()},
               "seconds": time.perf_counter() - t,
               "device": out["device"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
