"""Run one benchmark cell once on the card and print its result line.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, metrics and check limits are
found by name through ``BENCHMARK.json`` (see ``bench/README.md``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``), ``breakdown`` (traced runs) and, last,
``checks``: each number the correctness check compared, beside its
limit.  The same numbers end standard error.  Without a card, with fewer
cards than the cell asks for, or when the process holds a module of JAX
or of the JAX package after the window, it prints no result and exits
non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the program's kernel build lives in its checkout (src/repro_torch/csrc/
# _build); any other build or kernel cache goes to a fixed path in it too
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(BENCH / "_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(BENCH)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchlib.harness import banned_modules, run_cell
    from benchlib.manifest import Manifest

    m = Manifest(ROOT)
    need = int(m.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"bench: the cell needs {need} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}, devices: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"bench: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 4
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start=T_START, manifest=m)
    found = banned_modules()
    if found:
        print(f"bench: the process holds {', '.join(found)} after the window",
              file=sys.stderr)
        return 5
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
