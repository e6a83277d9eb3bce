#!/usr/bin/env python3
"""Kernel B4's times at the simulator path's shapes, for one or more trees.

    python3 scripts/b4_times.py [--trees DIR [DIR ...]] [--out FILE]

Runs this checkout's ``chip_smoke.phase_times_b4`` on the kernel library of
each tree (a checkout root holding ``src/repro_torch``), in the order given,
each in a process of its own with ``DIR/src`` first on the path: every shape
of this checkout's ``kernels/cim_mac/cardcheck.py::PATH_SHAPES`` (whatever
the tree's own list) is held against the plain version under the ADC
contract, then timed L2-cold (``chip_smoke.cold_ms``), warm by
back-to-back events and warm by a CUDA-graph replay, beside its bound.
Give two trees in turns (``--trees old . . old``) to compare two versions
of the kernel on one card under one timer.  Each tree then also runs phase
5b's simulator MAC path (``chip_smoke.phase_mac_path``: 12 launches at 65536
knot rows), whose B4 device time the profiler reports.  Prints
one JSON line per run and a table, and writes the runs to ``--out``
(default ``reports/b4_times.json``).  Needs a CUDA card; without one
it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(tree: Path, shapes: list) -> int:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("b4_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import repro_torch

    src = Path(repro_torch.__file__).resolve()
    if tree.resolve() / "src" not in src.parents:
        print(f"b4_times: repro_torch came from {src}, not {tree}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    run = {"tree": str(tree), "smi": chip_smoke.smi_line(),
           "device": torch.cuda.get_device_name(0),
           "shapes": chip_smoke.phase_times_b4(dev, shapes)}
    from repro_torch.data.knot import make_knot_dataset

    knot = make_knot_dataset(n_train=chip_smoke.ACIM_ROWS, n_test=1,
                             seed=0)[0]
    mac = chip_smoke.phase_mac_path(dev, chip_smoke.build_models(dev), knot)
    run["mac_path_b4_device_ms"] = mac["b4_device_ms"]
    print(json.dumps(run))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[str(ROOT)])
    ap.add_argument("--out", default=str(ROOT / "reports" /
                                         "b4_times.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--shapes", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(Path(args.worker), json.loads(args.shapes))
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.cim_mac.cardcheck import PATH_SHAPES

    runs = []
    for tree in args.trees:
        cmd = [sys.executable, __file__, "--worker", str(Path(tree).resolve()),
               "--shapes", json.dumps(PATH_SHAPES)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              env=dict(os.environ))
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            print(f"b4_times: {tree} failed ({proc.returncode})",
                  file=sys.stderr)
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(json.dumps(run))
    print(f"{runs[0]['smi']}; times in ms, cold = L2 flushed before each "
          "launch; event and graph warm")
    for run in runs:
        print(f"{run['tree']}: B4 device time on the simulator MAC path "
              f"(12 launches, profiler) {run['mac_path_b4_device_ms']:.4f}")
    print("tree | shape | cold | event | graph | cold read of x | bound | "
          "bound / cold")
    for run in runs:
        for r in run["shapes"]:
            print(f"{run['tree']} | {r['shape']} | "
                  f"{r['cold_ms']:.4f} | {r['event_ms']:.4f} | "
                  f"{r['graph_ms']:.4f} | {r['read_ms']:.4f} | "
                  f"{r['bound_ms']:.4f} | {r['bound_ms'] / r['cold_ms']:.3f}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
